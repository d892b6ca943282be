"""Background checkpoint writer: the train loop never stalls on disk.

Copy of ``predictionio_tpu/ckpt/writer.py``. The trainer copies its
state to host arrays and hands the snapshot to
:meth:`CheckpointWriter.submit`, which puts it on a BOUNDED queue and
returns at once. A dedicated thread drains the queue through
:meth:`~.store.CheckpointStore.save` (atomic files, manifest last).

When the queue is full (the disk cannot keep up with the cadence) the
NEW snapshot is dropped and counted (:attr:`CheckpointWriter.dropped`),
never waited on: a dropped checkpoint costs recovery granularity, a
blocked train loop costs every step. A write error is logged at ERROR,
counted and kept as ``last_error``: a full disk must not kill an
otherwise healthy run. :meth:`close` drains the queue (the final step's
snapshot is never dropped silently) and joins the thread.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Optional

import numpy as np

from .store import CheckpointStore

logger = logging.getLogger("pio.ckpt")

_STOP = object()


class CheckpointWriter:
    """One writer thread over one :class:`CheckpointStore`."""

    def __init__(self, store: CheckpointStore, queue_depth: int = 2) -> None:
        if queue_depth < 1:
            raise ValueError(
                f"writer queue_depth must be >= 1, got {queue_depth}"
            )
        self.store = store
        self.written = 0
        self.dropped = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="pio-ckpt-writer", daemon=True
        )
        self._thread.start()

    def submit(
        self, step: int, arrays: Dict[str, np.ndarray], meta: dict
    ) -> bool:
        """Enqueue one snapshot without blocking. False = dropped
        (queue full — counted and logged, training continues)."""
        if self._closed:
            raise RuntimeError("CheckpointWriter is closed")
        try:
            self._queue.put_nowait((step, arrays, meta))
            return True
        except queue.Full:
            self.dropped += 1
            logger.warning(
                "ckpt: writer queue full — dropping snapshot of step %d "
                "(disk is behind checkpoint_every; %d dropped so far)",
                step, self.dropped,
            )
            return False

    def flush_submit(
        self, step: int, arrays: Dict[str, np.ndarray], meta: dict
    ) -> None:
        """Blocking submit for the FINAL snapshot of a run: the one
        checkpoint that must not be dropped waits for a queue slot."""
        if self._closed:
            raise RuntimeError("CheckpointWriter is closed")
        self._queue.put((step, arrays, meta))

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            step, arrays, meta = item
            try:
                self.store.save(step, arrays, meta)
                self.written += 1
            except Exception as exc:
                self.errors += 1
                self.last_error = f"step {step}: {exc}"
                logger.error(
                    "ckpt: background write of step %d failed (%s) — "
                    "training continues; the previous committed "
                    "checkpoint remains the resume point",
                    step, exc,
                )

    def close(self, timeout: Optional[float] = 60.0) -> dict:
        """Drain pending snapshots, stop the thread, return
        :meth:`stats`. Idempotent."""
        if not self._closed:
            self._closed = True
            self._queue.put(_STOP)
            self._thread.join(timeout)
            if self._thread.is_alive():
                self.errors += 1
                self.last_error = (
                    f"writer thread failed to drain within {timeout}s"
                )
                logger.error("ckpt: %s", self.last_error)
        return self.stats()

    def stats(self) -> dict:
        return {
            "written": self.written,
            "dropped": self.dropped,
            "errors": self.errors,
            "lastError": self.last_error,
        }

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
