"""Micro-batching aggregator for the serving hot path.

Copy of ``predictionio_tpu/workflow/batching.py``. Concurrent request threads
``submit()`` work items; a dispatcher thread collects what arrives
within ``max_wait_ms`` (or up to ``max_batch``) and hands the batch to
one of ``pipeline_depth`` worker threads, so one batch's results travel
back from the card while the next is already dispatched. A lone query
pays at most ``max_wait_ms`` of added latency; under load the batch
fills and the wait never triggers.

The processor must be thread-safe under ``pipeline_depth`` concurrent
calls. Batches may complete out of order; per-item futures make that
invisible to callers. With a ``tracer``, each item whose submitting
thread carried a span context gets two child spans, ``batch.queue-wait``
(submit → dispatch) and ``batch.device`` (the processor call); ``clock``
is injectable.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer, current_context

__all__ = ["MicroBatcher"]

#: default bound on one ``submit()`` wait: covers a first dispatch that
#: builds the kernels (seconds) with a wide margin
SUBMIT_TIMEOUT_S = 120.0


class MicroBatcher:
    """Aggregate concurrent ``submit()`` calls into batched processor runs.

    ``process`` takes a list of items and returns a list of results of
    the same length. A result that is an ``Exception`` fails only its own
    request; an exception *raised* by ``process`` fails every request of
    that batch. :data:`SUBMIT_TIMEOUT_S` bounds each ``submit()`` wait.

    Into ``metrics`` every flush records its size, reason
    (``full``/``wait``/``close``) and per-item queue wait, and the live
    queue depth is a gauge. ``submit(item, timeout)`` bounds one wait
    (a request's remaining deadline)."""

    def __init__(
        self,
        process: Callable[[Sequence[Any]], Sequence[Any]],
        max_batch: int = 64,
        max_wait_ms: float = 1.0,
        name: str = "microbatch",
        pipeline_depth: int = 2,
        *,
        metrics: MetricsRegistry,
        tracer: Optional[Tracer] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._process = process
        self._max_batch = max_batch
        self._max_wait_s = max(0.0, max_wait_ms) / 1000.0
        self._pipeline_depth = pipeline_depth
        self._clock = clock
        self._tracer = tracer
        self._obs_size = metrics.histogram(
            "pio_batch_size",
            "Queries per dispatched micro-batch",
            buckets=[2.0 ** i for i in range(11)],  # 1..1024
        )
        self._obs_wait = metrics.histogram(
            "pio_batch_queue_wait_seconds",
            "Per-item wait between submit and batch dispatch",
        )
        self._obs_flush = metrics.counter(
            "pio_batch_flush_total", "Batch flushes by trigger",
            labelnames=("reason",),
        )
        self._obs_items = metrics.counter(
            "pio_batch_items_total", "Items dispatched through batches"
        )
        self._obs_failures = metrics.counter(
            "pio_batch_failures_total",
            "Batches whose processor raised (all items failed)",
        )
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._items: List[Any] = []
        self._futures: List[Future] = []
        #: parallel to _items: (enqueue time, submitter's SpanContext or None)
        self._meta: List[Tuple[float, Any]] = []
        self._closed = False
        # registered only now: a scrape can fire the callback at once
        metrics.gauge_callback(
            "pio_batch_queue_depth", self._queue_depth,
            "Items waiting for the next batch",
        )
        self._batches = 0
        self._submitted = 0
        self._inflight_hwm = 0
        self._inflight = 0
        self._slots = threading.Semaphore(pipeline_depth)
        # daemon workers, not a ThreadPoolExecutor: a batch hung on a dead
        # device must not wedge interpreter exit
        self._work: "queue.Queue" = queue.Queue()
        self._workers = [
            threading.Thread(target=self._worker, name=f"{name}-exec-{i}", daemon=True)
            for i in range(pipeline_depth)
        ]
        for w in self._workers:
            w.start()
        self._dispatcher = threading.Thread(target=self._run, name=name, daemon=True)
        self._dispatcher.start()

    def _queue_depth(self) -> int:
        with self._lock:
            return len(self._items)

    def submit(self, item: Any, timeout: Optional[float] = None) -> Any:
        """Block until the batched processor has handled ``item``; returns
        its result (or raises that item's exception). ``timeout`` (default
        :data:`SUBMIT_TIMEOUT_S`) raises ``concurrent.futures.TimeoutError``."""
        # the submitter's trace context, captured here: the threads that
        # record this item's spans cannot see its contextvars
        span_ctx = current_context() if self._tracer is not None else None
        fut: Future = Future()
        with self._nonempty:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._items.append(item)
            self._futures.append(fut)
            self._meta.append((self._clock(), span_ctx))
            self._submitted += 1
            self._nonempty.notify()
        return fut.result(timeout=SUBMIT_TIMEOUT_S if timeout is None else timeout)

    def _take_batch(self) -> tuple:
        """Wait for one item, linger up to max_wait for more (or until the
        batch is full), then drain. Returns ((), (), (), "") on close."""
        with self._nonempty:
            while not self._items and not self._closed:
                self._nonempty.wait(0.1)
            if self._closed and not self._items:
                return (), (), (), ""
            if self._max_wait_s > 0:
                deadline = time.monotonic() + self._max_wait_s
                while len(self._items) < self._max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._nonempty.wait(remaining)
            if len(self._items) >= self._max_batch:
                reason = "full"
            elif self._closed:
                reason = "close"
            else:
                reason = "wait"
            n = self._max_batch
            items, futures, metas = self._items[:n], self._futures[:n], self._meta[:n]
            del self._items[:n], self._futures[:n], self._meta[:n]
            return items, futures, metas, reason

    def _run(self) -> None:
        while True:
            # take a pipeline slot BEFORE draining: while every slot is
            # busy, arrivals keep topping up the next batch
            self._slots.acquire()
            items, futures, metas, reason = self._take_batch()
            if not items:
                self._slots.release()
                with self._lock:
                    closed = self._closed
                if closed:
                    return
                continue
            with self._lock:
                self._inflight += 1
                self._inflight_hwm = max(self._inflight_hwm, self._inflight)
            self._work.put((items, futures, metas, reason))
            # drop this frame's references to the batch while the next
            # one is awaited: an item can hold a retired deployment
            del items, futures, metas

    def _worker(self) -> None:
        while True:
            task = self._work.get()
            if task is None:  # close() sentinel
                return
            self._execute(*task)
            task = None  # as in _run: keep no batch alive between batches

    def _record_obs(self, metas: Sequence[Tuple[float, Any]], reason: str,
                    dispatch_ts: float, device_s: float, batch_size: int) -> None:
        self._obs_size.observe(batch_size)
        self._obs_flush.inc(1, reason=reason)
        self._obs_items.inc(batch_size)
        for enqueue_ts, span_ctx in metas:
            wait_s = max(0.0, dispatch_ts - enqueue_ts)
            self._obs_wait.observe(wait_s)
            if self._tracer is not None and span_ctx is not None:
                wall = self._tracer.wall()
                tags = {"batch_size": batch_size, "flush": reason}
                self._tracer.record(
                    "batch.queue-wait", self._tracer.child_context(span_ctx),
                    span_ctx.span_id, start_wall=wall - wait_s - device_s,
                    duration_s=wait_s, tags=tags,
                )
                self._tracer.record(
                    "batch.device", self._tracer.child_context(span_ctx),
                    span_ctx.span_id, start_wall=wall - device_s,
                    duration_s=device_s, tags=tags,
                )

    def _execute(self, items: Sequence[Any], futures: Sequence[Future],
                 metas: Sequence[Tuple[float, Any]] = (), reason: str = "") -> None:
        """Run one batch on a worker thread and fan results out. Metrics
        and spans are recorded before the fan-out, failed batches
        included: a client that reads /metrics or /traces.json right
        after its answer must find this batch there."""
        dispatch_ts = self._clock()

        def record() -> None:
            try:
                self._record_obs(metas, reason, dispatch_ts,
                                 self._clock() - dispatch_ts, len(items))
            except Exception:
                pass  # observability must never wedge a pipeline slot

        try:
            try:
                results = self._process(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch processor returned {len(results)} results "
                        f"for {len(items)} items"
                    )
            except Exception as exc:
                self._obs_failures.inc(1)
                record()
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            with self._lock:
                self._batches += 1
            record()
            for fut, result in zip(futures, results):
                if fut.done():
                    continue
                if isinstance(result, Exception):
                    fut.set_exception(result)  # per-item failure channel
                else:
                    fut.set_result(result)
        finally:
            with self._lock:
                self._inflight -= 1
            self._slots.release()

    def close(self, grace_s: float = 5.0) -> None:
        """Stop accepting, wait up to ``grace_s`` in total for in-flight
        batches, then fail whatever is still queued."""
        deadline = time.monotonic() + grace_s
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()
        self._dispatcher.join(timeout=max(0.0, deadline - time.monotonic()))
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.005)
        for _ in self._workers:
            self._work.put(None)
        with self._nonempty:
            for fut in self._futures:
                if not fut.done():
                    fut.set_exception(RuntimeError("MicroBatcher closed"))
            self._items.clear()
            self._futures.clear()
            self._meta.clear()

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self._submitted,
                "batches": self._batches,
                "avg_batch": self._submitted / self._batches if self._batches else 0.0,
                "pipeline_depth": self._pipeline_depth,
                "inflight_hwm": self._inflight_hwm,
            }
