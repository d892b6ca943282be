"""Thread-safe metrics registry: counters, gauges, log-scale histograms.

Trimmed copy of ``predictionio_tpu/obs/metrics.py`` — the instruments
the serving path records (request latency, shed and HTTP-status
counters, micro-batch sizes and waits, breaker gauges, the kernel-launch
gauge) and the in-process read path the SLO engine evaluates
(``instrument``, ``Counter.samples``, ``Gauge.samples``,
``Histogram.label_snapshots``). Instruments are created idempotently by
name with a fixed label-name schema; past ``max_label_sets`` label sets
a metric collapses new ones into one ``_overflow`` series instead of
growing without bound. The registry's ``clock`` is injectable: breaker,
SLO and stall windows read it, so their tests never sleep.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "OVERFLOW_VALUE",
    "DEFAULT_BUCKETS",
    "percentile_from_buckets",
]

#: the label value every over-cap label set collapses into
OVERFLOW_VALUE = "_overflow"

#: Default histogram buckets (seconds): powers of two from 0.5 ms to ~65 s.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(0.0005 * (2.0 ** i) for i in range(18))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def percentile_from_buckets(
    uppers: Sequence[float], cumulative: Sequence[int], q: float
) -> float:
    """Estimate the ``q`` (0..1) percentile from cumulative bucket counts
    (Prometheus ``histogram_quantile``: linear interpolation inside the
    first bucket whose cumulative count reaches the rank). 0.0 with no
    observations; beyond the last finite bound it clamps to that bound."""
    total = cumulative[-1] if cumulative else 0
    if total <= 0:
        return 0.0
    rank = q * total
    prev_bound = 0.0
    prev_count = 0
    for upper, count in zip(uppers, cumulative):
        if count >= rank:
            in_bucket = count - prev_count
            if in_bucket <= 0 or math.isinf(upper):
                return prev_bound
            frac = (rank - prev_count) / in_bucket
            return prev_bound + (upper - prev_bound) * frac
        prev_bound, prev_count = upper, count
    return uppers[-1] if uppers else 0.0


class _Instrument:
    """Base: child series keyed by label-value tuples, under one lock."""

    kind = ""

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 max_label_sets: int):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # the unlabelled series exists from creation
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def _child(self, labels: Dict[str, object]):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.labelnames and len(self._children) >= self._max_label_sets:
                    key = tuple(OVERFLOW_VALUE for _ in self.labelnames)
                    child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
            return child

    def series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def _labels_of(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def clear(self) -> None:
        """Drop every series (re-exported state whose label sets change,
        such as a reload's train phases); the unlabelled series is
        re-created at zero."""
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._new_child()


class _Value:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _Scalar(_Instrument):
    """A counter's or a gauge's series: one float each."""

    def _new_child(self):
        return _Value()

    def value(self, **labels) -> float:
        child = self._child(labels)
        with self._lock:
            return child.value

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        """Every series as ``(labels, value)`` — the in-process twin of a
        scraped exposition (the SLO engine reads them this way)."""
        with self._lock:
            return [(self._labels_of(key), child.value)
                    for key, child in sorted(self._children.items())]


class Counter(_Scalar):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        child = self._child(labels)
        with self._lock:
            child.value += amount


class Gauge(_Scalar):
    """Point-in-time value; may be backed by a collect-time callback
    (:meth:`MetricsRegistry.gauge_callback`)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            child.value = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        child = self._child(labels)
        with self._lock:
            child.value += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class _HistogramChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative exposition, per-bucket storage)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 max_label_sets: int, buckets: Optional[Sequence[float]] = None):
        bounds = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"{name}: buckets must be non-empty and strictly increasing"
            )
        self.buckets = bounds
        super().__init__(name, help, labelnames, max_label_sets)

    def _new_child(self):
        return _HistogramChild(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        child = self._child(labels)
        idx = len(self.buckets)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                idx = i
                break
        with self._lock:
            child.counts[idx] += 1
            child.sum += value
            child.count += 1

    def snapshot(self, **labels) -> Dict[str, object]:
        """Cumulative view of one series: ``{"buckets": [(le, n), ...],
        "sum": s, "count": n}``."""
        child = self._child(labels)
        with self._lock:
            counts = list(child.counts)
            total_sum, total = child.sum, child.count
        cumulative = []
        running = 0
        for bound, n in zip(self.buckets, counts[:-1]):
            running += n
            cumulative.append((bound, running))
        cumulative.append((math.inf, total))
        return {"buckets": cumulative, "sum": total_sum, "count": total}

    def percentile(self, q: float, **labels) -> float:
        snap = self.snapshot(**labels)
        uppers = [b for b, _ in snap["buckets"]]
        cums = [n for _, n in snap["buckets"]]
        return percentile_from_buckets(uppers, cums, q)

    def label_snapshots(self) -> List[Tuple[Dict[str, str], Dict[str, object]]]:
        """Every series as ``(labels, snapshot)`` in :meth:`snapshot`'s
        cumulative shape, so the SLO engine can count under-threshold
        observations across the whole family."""
        with self._lock:
            raw = [(self._labels_of(key), list(child.counts), child.sum, child.count)
                   for key, child in sorted(self._children.items())]
        out = []
        for labels, counts, total_sum, total in raw:
            cumulative = []
            running = 0
            for bound, n in zip(self.buckets, counts[:-1]):
                running += n
                cumulative.append((bound, running))
            cumulative.append((math.inf, total))
            out.append((labels, {"buckets": cumulative, "sum": total_sum, "count": total}))
        return out


class MetricsRegistry:
    """One server's instrument set. ``counter(name)`` twice returns the
    same object; a name re-used with another kind, label schema or
    bucket set raises."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 max_label_sets: int = 64):
        self.clock = clock
        self.max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._callbacks: List[Tuple[Gauge, Dict[str, str], Callable]] = []

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._instruments.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        "kind or label schema"
                    )
                want = kwargs.get("buckets")
                if want is not None and tuple(want) != existing.buckets:
                    raise ValueError(
                        f"histogram {name!r} re-registered with different buckets"
                    )
                return existing
            inst = cls(name, help, labelnames, self.max_label_sets, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def instrument(self, name: str) -> Optional[_Instrument]:
        """The registered instrument of that name, or None (the SLO
        engine reads absence as abstention, never as an error)."""
        with self._lock:
            return self._instruments.get(name)

    def gauge_callback(self, name: str, fn: Callable[[], float], help: str = "",
                       labels: Optional[Dict[str, str]] = None) -> Gauge:
        """A gauge whose value is pulled at collect time. ``fn`` must be
        cheap; a raise freezes the series at its last value."""
        labels = dict(labels or {})
        gauge = self.gauge(name, help=help, labelnames=sorted(labels))
        with self._lock:
            self._callbacks.append((gauge, labels, fn))
        return gauge

    def collect(self) -> List[_Instrument]:
        """All instruments, callback gauges refreshed, stable name order."""
        with self._lock:
            callbacks = list(self._callbacks)
            instruments = sorted(self._instruments.items())
        for gauge, labels, fn in callbacks:
            try:
                gauge.set(float(fn()), **labels)
            except Exception:
                pass  # last value stands; exposition must never 500
        return [inst for _, inst in instruments]
