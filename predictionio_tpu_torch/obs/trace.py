"""Cross-process request tracing: ``X-PIO-Trace`` ids and in-process spans.

Copy of ``predictionio_tpu/obs/trace.py``. A client (or the first server
that sees a request) mints a trace id and sends it in ``X-PIO-Trace``;
each server opens a **server span** at admission under that id, each
instrumented stage inside the process (the micro-batch queue wait, the
batched dispatch, feedback delivery) adds child spans, and outbound
calls forward the header so the downstream server's spans join the same
trace. Each process keeps its spans in a bounded ring (:class:`SpanStore`)
served on ``GET /traces.json``; ``pio trace <id>`` stitches the dumps of
a node list into one timeline.

A contextvar carries the live request's :class:`SpanContext`. It does
not cross threads: work handed to another thread (the micro-batcher's
workers, the feedback pool) captures :func:`current_context` at submit
time and passes it as ``parent``. Clocks are injectable.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import secrets
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional

__all__ = [
    "TRACE_HEADER",
    "SpanContext",
    "SpanStore",
    "Tracer",
    "current_context",
    "new_trace_id",
]

#: Wire header carrying the trace id. Value contract: an opaque token of
#: 1-64 URL-safe characters; anything longer/weirder is truncated and
#: sanitized at admission (a garbled header must degrade, never 500).
TRACE_HEADER = "X-PIO-Trace"

_MAX_ID_LEN = 64
_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_."
)


def new_trace_id() -> str:
    """16 hex chars — unique enough to tell a fleet's requests apart."""
    return secrets.token_hex(8)


def sanitize_trace_id(value: Optional[str]) -> Optional[str]:
    """Header value → usable trace id, or None when absent/empty."""
    if not value:
        return None
    cleaned = "".join(c for c in value.strip() if c in _ID_OK)[:_MAX_ID_LEN]
    return cleaned or None


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """What a child span (possibly on another thread) needs of its
    parent: the ids and the tracer whose store it records into."""

    trace_id: str
    span_id: str
    tracer: "Tracer"


_ambient_span: contextvars.ContextVar = contextvars.ContextVar(
    "pio_span", default=None
)


def current_context() -> Optional[SpanContext]:
    """The span context of the request this thread is serving, if any."""
    return _ambient_span.get()


class SpanStore:
    """Bounded ring buffer of finished spans (newest win; a busy server
    forgets old traces instead of growing without bound)."""

    def __init__(self, capacity: int = 2048):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)

    def add(self, span: dict) -> None:
        with self._lock:
            self._spans.append(span)

    def dump(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def for_trace(self, trace_id: str) -> List[dict]:
        return [s for s in self.dump() if s.get("traceId") == trace_id]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class Tracer:
    """Per-process (per-server) span factory bound to one store.

    ``clock`` measures durations (monotonic); ``wall`` stamps span start
    times (epoch seconds) so cross-process dumps sort into one timeline.
    Both injectable for sleep-free tests.
    """

    def __init__(
        self,
        service: str,
        store: Optional[SpanStore] = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ):
        self.service = service
        self.store = store if store is not None else SpanStore()
        self.clock = clock
        self.wall = wall

    # -- span creation ----------------------------------------------------
    @contextlib.contextmanager
    def server_span(
        self,
        name: str,
        header_value: Optional[str] = None,
        tags: Optional[Dict[str, object]] = None,
    ) -> Iterator[SpanContext]:
        """The admission span: joins the trace named by an incoming
        ``X-PIO-Trace`` header, or roots a fresh one. Sets the ambient
        context for the request's dynamic extent."""
        trace_id = sanitize_trace_id(header_value) or new_trace_id()
        yield from self._run_span(name, trace_id, None, tags, kind="server")

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        tags: Optional[Dict[str, object]] = None,
        parent: Optional[SpanContext] = None,
    ) -> Iterator[SpanContext]:
        """A child of ``parent`` (default: the ambient context; with
        neither, roots a fresh trace). Use an explicit ``parent`` when
        crossing threads — the ambient contextvar does not follow."""
        parent = parent if parent is not None else current_context()
        trace_id = parent.trace_id if parent else new_trace_id()
        parent_id = parent.span_id if parent else None
        yield from self._run_span(name, trace_id, parent_id, tags)

    def _run_span(self, name, trace_id, parent_id, tags, kind="internal"):
        ctx = SpanContext(trace_id, secrets.token_hex(4), self)
        token = _ambient_span.set(ctx)
        start_wall = self.wall()
        t0 = self.clock()
        error: Optional[str] = None
        try:
            yield ctx
        except BaseException as exc:
            error = type(exc).__name__
            raise
        finally:
            _ambient_span.reset(token)
            self.record(
                name=name,
                ctx=ctx,
                parent_id=parent_id,
                start_wall=start_wall,
                duration_s=self.clock() - t0,
                tags=tags,
                kind=kind,
                error=error,
            )

    def record(
        self,
        name: str,
        ctx: SpanContext,
        parent_id: Optional[str],
        start_wall: float,
        duration_s: float,
        tags: Optional[Dict[str, object]] = None,
        kind: str = "internal",
        error: Optional[str] = None,
    ) -> None:
        """Append one finished span (also the entry point for callers
        that measured timing themselves, e.g. the MicroBatcher's
        queue-wait span whose start predates the dispatch thread)."""
        span = {
            "traceId": ctx.trace_id,
            "spanId": ctx.span_id,
            "parentId": parent_id,
            "service": self.service,
            "kind": kind,
            "name": name,
            "startMs": round(start_wall * 1000.0, 3),
            "durationMs": round(max(0.0, duration_s) * 1000.0, 3),
        }
        if tags:
            span["tags"] = {k: v for k, v in tags.items()}
        if error:
            span["error"] = error
        self.store.add(span)

    def child_context(self, parent: Optional[SpanContext]) -> SpanContext:
        """A pre-minted context for a span whose lifetime is managed by
        hand (cross-thread timing); pair with :meth:`record`."""
        trace_id = parent.trace_id if parent else new_trace_id()
        return SpanContext(trace_id, secrets.token_hex(4), self)
