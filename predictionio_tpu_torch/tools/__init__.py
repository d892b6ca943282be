"""Command-line tools of the port: the console (``python -m
predictionio_tpu_torch.tools.console``), engine registration, the
train/eval entry point (``run_workflow``), the serving entry point
(``run_server``), the bundled templates and event import/export."""


#: what is left of the continuous loop: the watcher, the controller and
#: fold-in are ported; tailing a partitioned store's feeds is item 12's
CONTINUOUS_LOOP = ("the continuous loop over a partitioned store's feeds "
                   "(PartitionedFeedWatcher, partitioned folds)")


def not_ported(what: str, item: int) -> NotImplementedError:
    """The refusal of a command, flag or setting whose module is not
    ported, naming its ROADMAP item."""
    return NotImplementedError(
        f"not ported to the PyTorch package yet: {what} (ROADMAP.md, "
        f"queue 1 item {item})"
    )
