"""Command-line tools of the port: the console (``python -m
predictionio_tpu_torch.tools.console``), engine registration, the
train/eval entry point (``run_workflow``), the serving entry point
(``run_server``), the bundled templates and event import/export."""


#: what the continuous loop's refusals name: fold-in is ported, the
#: changefeed watcher and the controller wait for the storage oplog
CONTINUOUS_LOOP = "the continuous-learning loop's watcher and controller, item 9's second half"


def not_ported(what: str, item: int) -> NotImplementedError:
    """The refusal of a command, flag or setting whose module is not
    ported, naming its ROADMAP item."""
    return NotImplementedError(
        f"not ported to the PyTorch package yet: {what} (ROADMAP.md, "
        f"queue 1 item {item})"
    )
