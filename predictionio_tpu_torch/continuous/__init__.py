"""Continuous-learning plane of the port (counterpart of
``predictionio_tpu/continuous``): changefeed-driven fold-in training with
automatic rollout submission.

- :mod:`.watcher` tails a storage primary's changefeed from a durable
  cursor and accumulates a delta of fresh rating/feedback events;
- :mod:`.foldin` is the incremental step: re-solve only the rows a delta
  touched (kernels 3 and 2 on the card), with policy thresholds that
  escalate to a full retrain;
- :mod:`.controller` turns deltas into candidate models and submits them
  through the rollout plane's shadow → canary → live gates.

One feed a loop: a partitioned store's feeds wait (ROADMAP.md, queue 1
item 12).
"""

from .controller import ContinuousConfig, ContinuousController
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
from .watcher import DeltaBatch, FeedGap, FeedWatcher, LocalFeed, RemoteFeed, make_watcher

__all__ = [
    "ContinuousConfig",
    "ContinuousController",
    "DeltaBatch",
    "FOLD_IN",
    "FULL_RETRAIN",
    "FeedGap",
    "FeedWatcher",
    "FoldInPolicy",
    "FoldInStats",
    "LocalFeed",
    "RemoteFeed",
    "decide_mode",
    "extend_bimap_indexing",
    "fold_in_factors",
    "make_watcher",
    "seeded_rows",
    "solve_rows",
]
