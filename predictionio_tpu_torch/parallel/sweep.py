"""Sweep execution over the slices of a workflow context.

Copy of ``predictionio_tpu/parallel/sweep.py``. The reference evaluates
a hyperparameter grid with a parallel collection
(``MetricEvaluator.scala:202-211``); the JAX package runs each candidate
on its own mesh slice. Here the slices are
:meth:`..workflow.context.WorkflowContext.slices`, which on one card is
the context itself: a sweep with ``parallelism > 1`` runs on one sweep
thread, candidate after candidate. Slicing across several cards waits
for sharded ALS on ``torch.distributed`` (ROADMAP.md, queue 1 item 11).

- :class:`SlicePool` — a checkout pool of slice contexts; a task takes
  a FREE slice, so no two concurrent trainings share a device.
- :func:`run_sliced` — ordered map of tasks over the pool.
"""

from __future__ import annotations

import contextlib
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Sequence

__all__ = ["SlicePool", "run_sliced"]


class SlicePool:
    """Checkout pool over a context's slices."""

    def __init__(self, ctx, parallelism: int):
        slices = ctx.slices(parallelism) if hasattr(ctx, "slices") else [ctx]
        self._free: "queue.Queue" = queue.Queue()
        for s in slices:
            self._free.put(s)
        self.n_slices = len(slices)

    @contextlib.contextmanager
    def acquire(self):
        """Check out a slice context; blocks until one is free. Never nest
        acquisitions on one pool from within a held slice: with every
        slice held by a waiting parent that deadlocks."""
        ctx = self._free.get()
        try:
            yield ctx
        finally:
            self._free.put(ctx)


def run_sliced(ctx, tasks: Sequence[Callable[[Any], Any]], parallelism: int) -> List[Any]:
    """Run ``tasks`` (each a callable taking a slice context), one free
    slice per running task; returns the results in task order. The first
    task exception propagates (after all tasks settle)."""
    pool = SlicePool(ctx, parallelism)

    def run(task):
        with pool.acquire() as sliced:
            return task(sliced)

    with ThreadPoolExecutor(max_workers=pool.n_slices, thread_name_prefix="sweep") as executor:
        futs = [executor.submit(run, t) for t in tasks]
        return [f.result() for f in futs]
