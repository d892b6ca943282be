"""Continuous-learning plane of the port (counterpart of
``predictionio_tpu/continuous``). Ported so far: fold-in
(:mod:`.foldin`) — the incremental step that re-solves only the rows a
delta touched. The changefeed watcher and the controller that closes the
loop wait for the storage server's oplog (ROADMAP.md, queue 1 item 9's
second half)."""

from .foldin import (
    FOLD_IN,
    FULL_RETRAIN,
    FoldInPolicy,
    FoldInStats,
    decide_mode,
    extend_bimap_indexing,
    fold_in_factors,
    seeded_rows,
    solve_rows,
)

__all__ = [
    "FOLD_IN",
    "FULL_RETRAIN",
    "FoldInPolicy",
    "FoldInStats",
    "decide_mode",
    "extend_bimap_indexing",
    "fold_in_factors",
    "seeded_rows",
    "solve_rows",
]
