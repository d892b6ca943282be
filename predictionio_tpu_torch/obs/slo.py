"""SLO engine: declarative objectives, burn-rate alerting, the alert ledger.

Copy of ``predictionio_tpu/obs/slo.py``. An :class:`SLOObjective` is a
statement over a metric family the server already exports (99.9 % of
responses not 5xx, 99 % of queries under 512 ms, a gauge under its
limit). The :class:`SLOEngine` evaluates each with multi-window burn
rates on the registry's clock: an alert fires only when both the fast
(~5 min) and the slow (~1 h) window burn error budget at
``burn_threshold`` or faster, and clears when the fast window drops below
``clear_threshold``. Every FIRING/CLEARED transition is appended, fsynced,
to the alert ledger (``PIO_ALERT_LEDGER``, through
``obs/perfledger.py::append_record``), set on ``pio_slo_alert_state`` and
recorded in the flight recorder.

Abstention is explicit: an objective whose series is absent, exports the
``-1`` sentinel, or holds fewer than ``min_window_events`` observations
reports ``abstaining`` and neither fires nor clears; a firing alert does
not clear on data loss. The objective sets are those of the port's
servers (``query``, ``event``); the router's and the storage server's,
with the storage server's per-partition evaluation, come with their
servers (ROADMAP.md queue 1 items 12 and 13). :class:`HealthPlane`
bundles the engine, the stall watchdog and the process flight recorder
on one ticker thread per server (``GET /health.json``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "ALERT_SCHEMA",
    "ALERT_LEDGER_ENV",
    "HealthConfig",
    "HealthPlane",
    "SLOEngine",
    "SLOObjective",
    "default_objectives",
    "load_alerts",
]

ALERT_SCHEMA = 1

#: env naming the JSONL file alert transitions append to (the alerting
#: twin of ``PIO_PERF_LEDGER`` / ``PIO_QUALITY_SNAPSHOTS``)
ALERT_LEDGER_ENV = "PIO_ALERT_LEDGER"

#: env setting the background evaluation cadence (seconds; 0 disables
#: the thread — evaluation then only happens on explicit tick() calls)
TICK_ENV = "PIO_SLO_TICK_S"

DEFAULT_TICK_S = 15.0

_OK = "OK"
_FIRING = "FIRING"


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One declarative objective over an existing metric family.

    Two evaluation kinds:

    - ``ratio`` — good/bad event counts from a cumulative family:
      a *status counter* (``metric`` = a counter with a ``status``
      label; ``bad_status_min`` and up are bad) or a *latency
      histogram* (``latency_threshold_s`` set; observations at or under
      the threshold are good). Burn rate over a window =
      ``bad_fraction / (1 - target)`` — 1.0 means the error budget is
      being spent exactly at the sustainable rate.
    - ``gauge`` — a current-value family (feed lag, PSI): burn rate =
      ``window_mean / max_value``; negative samples are the metrics
      plane's abstention sentinel and read as *absent*, never as zero.

    An alert fires when BOTH windows burn at ``burn_threshold`` or
    faster, and clears when the fast window drops below
    ``clear_threshold``.
    """

    name: str
    kind: str  # "ratio" | "gauge"
    metric: str
    #: ratio: target good fraction (error budget = 1 - target)
    target: float = 0.999
    #: ratio over a histogram: observations <= this bound are good
    #: (align with a bucket bound; DEFAULT_BUCKETS are 0.0005 * 2^i)
    latency_threshold_s: Optional[float] = None
    #: ratio over a status counter: statuses >= this are bad
    bad_status_min: int = 500
    #: gauge: the value at which burn rate reads 1.0
    max_value: Optional[float] = None
    #: label filter applied to the source series (e.g. variant=baseline)
    labels: Tuple[Tuple[str, str], ...] = ()
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    burn_threshold: float = 8.0
    clear_threshold: float = 1.0
    #: ratio: a window with fewer total events than this abstains — a
    #: single 500 in a 3-request window is sampling noise, not a burn
    min_window_events: int = 10

    def __post_init__(self):
        if self.kind not in ("ratio", "gauge"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "ratio" and not (0.0 < self.target < 1.0):
            raise ValueError(f"{self.name}: target must be in (0, 1)")
        if self.kind == "gauge" and not self.max_value:
            raise ValueError(f"{self.name}: gauge objectives need max_value")


def default_objectives(kind: str) -> Tuple[SLOObjective, ...]:
    """The stock objective set for one server kind. Every
    objective reads a family the server may not export — absence is
    abstention, so one shared availability objective is safe on all of
    them while freshness/drift only ever report where the plane exists."""
    availability = SLOObjective(
        name="availability", kind="ratio", metric="pio_http_responses_total",
        target=0.999,
    )
    if kind == "query":
        return (
            availability,
            SLOObjective(
                name="latency", kind="ratio",
                metric="pio_serving_request_seconds",
                latency_threshold_s=0.512, target=0.99,
            ),
            SLOObjective(
                name="freshness", kind="gauge",
                metric="pio_continuous_feed_lag_ops",
                max_value=5000.0, burn_threshold=1.0,
            ),
            SLOObjective(
                name="drift", kind="gauge",
                metric="pio_quality_score_psi",
                labels=(("variant", "baseline"),),
                max_value=0.25, burn_threshold=1.0,
            ),
        )
    if kind == "event":
        return (
            availability,
            SLOObjective(
                name="latency", kind="ratio",
                metric="pio_http_request_seconds",
                latency_threshold_s=0.128, target=0.99,
            ),
            SLOObjective(
                name="drift", kind="gauge",
                metric="pio_quality_event_mix_psi",
                max_value=0.25, burn_threshold=1.0,
            ),
        )
    # any other server: availability is universal
    return (availability,)


# -- alert ledger -------------------------------------------------------------


def load_alerts(path: str) -> List[dict]:
    """Every parseable alert record in file order; torn or foreign lines
    are skipped, never fatal (the perf-ledger load discipline)."""
    import json

    out: List[dict] = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    parsed = json.loads(line)
                except ValueError:
                    continue
                if isinstance(parsed, dict) and parsed.get("kind") == "alert":
                    out.append(parsed)
    except OSError:
        return []
    return out


# -- windowed series ----------------------------------------------------------


class _Series:
    """Bounded ring of timestamped samples for one objective. Ratio
    objectives store cumulative ``(t, good, bad)``; gauge objectives
    store ``(t, value)``. NOT thread-safe — the engine's lock guards it."""

    #: hard cap on retained samples (a 1 s tick against a 1 h window
    #: would otherwise grow without bound)
    MAX_SAMPLES = 4096

    def __init__(self):
        self.samples: List[tuple] = []

    def add(self, sample: tuple, keep_window_s: float) -> None:
        self.samples.append(sample)
        cutoff = sample[0] - keep_window_s
        # prune from the head, keep one sample AT/BEFORE the cutoff so a
        # full slow window always has a baseline point to delta against
        while len(self.samples) > 2 and self.samples[1][0] <= cutoff:
            self.samples.pop(0)
        if len(self.samples) > self.MAX_SAMPLES:
            self.samples.pop(0)

    def ratio_window(
        self, now: float, window_s: float
    ) -> Optional[Tuple[float, float]]:
        """``(delta_good, delta_bad)`` between the newest sample and the
        newest sample at least ``window_s`` old (or the oldest sample —
        a partial window is still evidence). None with <2 samples."""
        if len(self.samples) < 2:
            return None
        newest = self.samples[-1]
        cutoff = now - window_s
        base = self.samples[0]
        for sample in self.samples:
            if sample[0] <= cutoff:
                base = sample
            else:
                break
        if base is newest:
            base = self.samples[-2]
        dgood = newest[1] - base[1]
        dbad = newest[2] - base[2]
        if dgood < 0 or dbad < 0:  # a counter reset (restart): no verdict
            return None
        return (dgood, dbad)

    def gauge_window(self, now: float, window_s: float) -> Optional[float]:
        """Mean of the samples inside the window (the newest always
        counts). None when no samples exist."""
        if not self.samples:
            return None
        cutoff = now - window_s
        values = [s[1] for s in self.samples if s[0] > cutoff]
        if not values:
            values = [self.samples[-1][1]]
        return sum(values) / len(values)


# -- readers over the in-process registry ------------------------------------


def _match(labels: Dict[str, str], want: Tuple[Tuple[str, str], ...]) -> bool:
    return all(labels.get(k) == v for k, v in want)


def _read_ratio(
    metrics: MetricsRegistry, obj: SLOObjective
) -> Optional[Tuple[float, float]]:
    """Cumulative ``(good, bad)`` for a ratio objective, or None when
    the source family does not exist yet."""
    inst = metrics.instrument(obj.metric)
    if inst is None:
        return None
    if obj.latency_threshold_s is not None:
        if not isinstance(inst, Histogram):
            return None
        good = 0.0
        total = 0.0
        threshold = obj.latency_threshold_s * (1.0 + 1e-9)
        for labels, snap in inst.label_snapshots():
            if not _match(labels, obj.labels):
                continue
            cumulative = snap["buckets"]
            total += cumulative[-1][1]
            under = 0
            for bound, count in cumulative:
                if bound <= threshold:
                    under = count
                else:
                    break
            good += under
        return (good, total - good)
    if not isinstance(inst, Counter):
        return None
    good = bad = 0.0
    found = False
    for labels, value in inst.samples():
        if not _match(labels, obj.labels):
            continue
        found = True
        try:
            status = int(labels.get("status", "0"))
        except ValueError:
            status = 0
        if status >= obj.bad_status_min:
            bad += value
        else:
            good += value
    return (good, bad) if found else None


def _read_gauge(
    metrics: MetricsRegistry, obj: SLOObjective
) -> Optional[float]:
    """Worst (max) non-negative matching sample of a gauge family, or
    None when absent / every sample carries the ``-1`` abstention
    sentinel — "no data is never a verdict"."""
    inst = metrics.instrument(obj.metric)
    if inst is None or not isinstance(inst, Gauge):
        return None
    values = [
        value
        for labels, value in inst.samples()
        if _match(labels, obj.labels) and value >= 0
    ]
    return max(values) if values else None


# -- the engine ---------------------------------------------------------------


class SLOEngine:
    """Evaluates a set of objectives against one process's registry.

    One lock guards the window state; ledger appends (fsync) happen
    OUTSIDE it — the module-wide never-block-under-a-lock discipline.
    Clocks are injected: ``clock`` orders the windows (monotonic),
    ``wall`` only stamps ledger lines for humans.
    """

    def __init__(
        self,
        metrics: MetricsRegistry,
        objectives: Sequence[SLOObjective],
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        ledger_path: Optional[str] = None,
        node: str = "",
        flight=None,
    ):
        self.metrics = metrics
        self.objectives = tuple(objectives)
        self.clock = clock
        self.wall = wall
        #: None defers to the env at append time, like quality snapshots
        self.ledger_path = ledger_path
        self.node = node
        self.flight = flight
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {
            obj.name: _Series() for obj in self.objectives
        }
        self._state: Dict[str, dict] = {
            obj.name: self._fresh_state() for obj in self.objectives
        }
        self._burn_gauge = metrics.gauge(
            "pio_slo_burn_rate",
            "Error-budget burn rate per objective and window "
            "(-1 = abstaining: source series absent or too thin)",
            labelnames=("objective", "window"),
        )
        self._state_gauge = metrics.gauge(
            "pio_slo_alert_state",
            "Alert state per objective (-1 abstaining, 0 ok, 1 firing)",
            labelnames=("objective",),
        )
        self._alerts = metrics.counter(
            "pio_slo_alerts_total",
            "Alert transitions by objective and event (fire / clear)",
            labelnames=("objective", "event"),
        )
        for obj in self.objectives:
            self._state_gauge.set(-1.0, objective=obj.name)
            for window in ("fast", "slow"):
                self._burn_gauge.set(
                    -1.0, objective=obj.name, window=window
                )

    @staticmethod
    def _fresh_state() -> dict:
        return {
            "state": _OK,
            "abstaining": True,
            "burn_fast": None,
            "burn_slow": None,
            "fired": 0,
            "cleared": 0,
        }

    # -- evaluation --------------------------------------------------------
    def _burns(
        self, obj: SLOObjective, series: _Series, now: float
    ) -> Tuple[Optional[float], Optional[float]]:
        if obj.kind == "ratio":
            burns = []
            budget = 1.0 - obj.target
            for window_s in (obj.fast_window_s, obj.slow_window_s):
                delta = series.ratio_window(now, window_s)
                if delta is None:
                    burns.append(None)
                    continue
                dgood, dbad = delta
                total = dgood + dbad
                if total < obj.min_window_events:
                    burns.append(None)  # too thin to judge — abstain
                    continue
                burns.append((dbad / total) / budget)
            return burns[0], burns[1]
        burns = []
        for window_s in (obj.fast_window_s, obj.slow_window_s):
            mean = series.gauge_window(now, window_s)
            burns.append(
                None if mean is None else mean / float(obj.max_value)
            )
        return burns[0], burns[1]

    def evaluate(self) -> dict:
        """One tick: sample every objective's source family, update the
        windows, run the fire/clear state machines, persist transitions.
        Returns the post-tick summary."""
        # refresh callback gauges (feed lag, PSI, breaker states ride
        # collect-time callbacks) before reading them
        self.metrics.collect()
        now = self.clock()
        transitions: List[dict] = []
        with self._lock:
            for obj in self.objectives:
                sample = None
                gauge_absent = False
                if obj.kind == "ratio":
                    observed = _read_ratio(self.metrics, obj)
                    if observed is not None:
                        sample = (now, observed[0], observed[1])
                else:
                    value = _read_gauge(self.metrics, obj)
                    if value is not None:
                        sample = (now, value)
                    else:
                        # the source went away (or is exporting the -1
                        # sentinel): stale window samples are not a
                        # verdict about NOW — abstain outright
                        gauge_absent = True
                self._evaluate_entry(obj, sample, gauge_absent, now, transitions)
        # durable + counter + flight work OUTSIDE the lock
        for record in transitions:
            event = "fire" if record["state"] == _FIRING else "clear"
            self._alerts.inc(1, objective=record["objective"], event=event)
            self._append(record)
            if self.flight is not None:
                try:
                    self.flight.record(
                        "alert", f"slo.{record['objective']}",
                        state=record["state"],
                        burnFast=record["burnFast"],
                        burnSlow=record["burnSlow"],
                    )
                except Exception:
                    pass  # forensics must never fail the evaluator
        return self.summary()

    def _evaluate_entry(
        self,
        obj: SLOObjective,
        sample,
        gauge_absent: bool,
        now: float,
        transitions: List[dict],
    ) -> None:
        """Window update + fire/clear state machine for one objective.
        Caller holds the lock."""
        name = obj.name
        series = self._series[name]
        state = self._state[name]
        if sample is not None:
            series.add(sample, obj.slow_window_s * 1.5)
        if gauge_absent:
            burn_fast = burn_slow = None
        else:
            burn_fast, burn_slow = self._burns(obj, series, now)
        abstaining = burn_fast is None or burn_slow is None
        state["burn_fast"] = burn_fast
        state["burn_slow"] = burn_slow
        state["abstaining"] = abstaining
        if not abstaining:
            if (
                state["state"] == _OK
                and burn_fast >= obj.burn_threshold
                and burn_slow >= obj.burn_threshold
            ):
                state["state"] = _FIRING
                state["fired"] += 1
                transitions.append(self._transition(obj, _FIRING, state))
            elif (
                state["state"] == _FIRING
                and burn_fast < obj.clear_threshold
            ):
                state["state"] = _OK
                state["cleared"] += 1
                transitions.append(self._transition(obj, "CLEARED", state))
        # export: -1 abstaining / 0 ok / 1 firing; a FIRING
        # objective that loses its data keeps exporting 1 — an
        # alert never clears on data loss
        if state["state"] == _FIRING:
            self._state_gauge.set(1.0, objective=name)
        elif abstaining:
            self._state_gauge.set(-1.0, objective=name)
        else:
            self._state_gauge.set(0.0, objective=name)
        for window, burn in (
            ("fast", burn_fast), ("slow", burn_slow)
        ):
            self._burn_gauge.set(
                -1.0 if burn is None else burn,
                objective=name, window=window,
            )

    def _transition(self, obj: SLOObjective, state: str, snapshot: dict) -> dict:
        return {
            "schema": ALERT_SCHEMA,
            "kind": "alert",
            "objective": obj.name,
            "metric": obj.metric,
            "state": state,
            "burnFast": _round(snapshot["burn_fast"]),
            "burnSlow": _round(snapshot["burn_slow"]),
            "burnThreshold": obj.burn_threshold,
            "node": self.node,
            "at": self.wall(),
        }

    def _append(self, record: dict) -> None:
        path = self.ledger_path or os.environ.get(ALERT_LEDGER_ENV)
        if not path:
            return
        try:
            from .perfledger import append_record

            append_record(path, record)
        except OSError:
            pass  # a read-only ledger degrades to in-memory alerting

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            objectives = []
            for obj in self.objectives:
                entry = self._state[obj.name]
                objectives.append(
                    {
                        "name": obj.name,
                        "kind": obj.kind,
                        "metric": obj.metric,
                        "state": entry["state"],
                        "abstaining": entry["abstaining"],
                        "burnFast": _round(entry["burn_fast"]),
                        "burnSlow": _round(entry["burn_slow"]),
                        "burnThreshold": obj.burn_threshold,
                        "fired": entry["fired"],
                        "cleared": entry["cleared"],
                    }
                )
        return {
            "objectives": objectives,
            "firing": sum(
                1 for o in objectives if o["state"] == _FIRING
            ),
        }

    def firing(self) -> List[str]:
        with self._lock:
            return [
                name
                for name, state in self._state.items()
                if state["state"] == _FIRING
            ]


def _round(value: Optional[float]) -> Optional[float]:
    return None if value is None else round(float(value), 4)


# -- per-server health plane --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of one server's health plane (``ServerConfig.health``)."""

    #: alert-ledger JSONL path; None reads PIO_ALERT_LEDGER at append
    alert_ledger: Optional[str] = None
    #: flight-recorder dump dir; None reads PIO_FLIGHT_DIR
    flight_dir: Optional[str] = None
    #: background evaluation cadence; None reads PIO_SLO_TICK_S
    #: (default 15 s); 0 disables the thread (explicit tick() only)
    tick_s: Optional[float] = None
    #: objective override; None = default_objectives(kind)
    objectives: Optional[Tuple[SLOObjective, ...]] = None


class HealthPlane:
    """One server's health stack: SLO engine + stall watchdog + a
    reference to the process flight recorder, evaluated together on one
    background ticker (``GET /health.json`` reads it, ``pio health``
    scrapes it fleet-wide)."""

    def __init__(
        self,
        metrics: MetricsRegistry,
        kind: str,
        clock: Callable[[], float] = time.monotonic,
        config: Optional[HealthConfig] = None,
        flight=None,
        node: str = "",
    ):
        from .flight import StallWatchdog, arm, default_recorder

        self.kind = kind
        self.config = config or HealthConfig()
        self.flight = flight if flight is not None else default_recorder()
        # arm the atexit/faulthandler crash dump — a process-level
        # decision, so env-driven only (PIO_FLIGHT_DIR; no-op unset,
        # idempotent, never signal handlers from library code)
        arm()
        objectives = (
            self.config.objectives
            if self.config.objectives is not None
            else default_objectives(kind)
        )
        self.engine = SLOEngine(
            metrics,
            objectives,
            clock=clock,
            ledger_path=self.config.alert_ledger,
            node=node or kind,
            flight=self.flight,
        )
        self.watchdog = StallWatchdog(
            metrics,
            clock=clock,
            flight=self.flight,
            dump_dir=self.config.flight_dir,
        )
        if self.config.tick_s is not None:
            self._tick_s = float(self.config.tick_s)
        else:
            self._tick_s = float(
                os.environ.get(TICK_ENV, str(DEFAULT_TICK_S))
            )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> dict:
        """One evaluation round (the background loop's body; drills and
        tests call it directly on injected clocks)."""
        self.watchdog.check()
        return self.engine.evaluate()

    def start(self) -> None:
        if self._tick_s <= 0 or self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self._tick_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the watcher must never take the server down

        self._thread = threading.Thread(
            target=loop, name=f"health-{self.kind}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def health_json(self) -> dict:
        out = self.engine.summary()
        out["kind"] = self.kind
        out["stalls"] = self.watchdog.summary()
        return out
