"""Model and data quality monitors: score drift, feedback quality, ingest mix.

Copy of ``predictionio_tpu/obs/quality.py``, built on the sketches of
:mod:`.sketch`. Three signal families:

1. Served-score drift — :class:`QualityMonitor` keeps a rolling sketch a
   variant of the top-k scores the serving path answered with, pins a
   baseline snapshot of the live distribution once it holds
   ``pin_min_samples`` (and again after every model go-live), and scores
   each variant's window against the pin by PSI:
   ``pio_quality_score_psi{variant}`` and quantile gauges. The rollout
   manager reads the candidate's PSI as an optional gate
   (``GateConfig.max_score_psi``).
2. Feedback quality — the serving path records what it served a user (a
   bounded LRU); :meth:`QualityMonitor.record_feedback` joins a user's
   later action to it: hit rate and the served rank's sketch.
3. Ingest quality — :class:`IngestQualityMonitor` rides the Event
   Server: per-app schema, range and poison counters, and the event-type
   mix against a durable per-app baseline by categorical PSI
   (``pio_quality_event_mix_psi{app}``).

Clocks are injected, each monitor takes one lock, and no file is written
under it. Snapshots are schema-versioned JSONL lines appended through
:func:`.perfledger.append_record` (fsynced; torn lines skipped on load)
to the file ``PIO_QUALITY_SNAPSHOTS`` names.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .sketch import QuantileSketch, categorical_psi, psi

__all__ = [
    "QualityConfig",
    "QualityMonitor",
    "IngestQualityMonitor",
    "SNAPSHOT_SCHEMA",
    "SNAPSHOTS_ENV",
    "append_snapshot",
    "USER_KEY_FIELDS",
    "feedback_key",
    "load_snapshots",
    "scores_from_result",
    "snapshot_psi",
]

SNAPSHOT_SCHEMA = 1

#: env naming the JSONL file quality snapshots append to (the quality
#: twin of ``PIO_PERF_LEDGER`` — both live next to the perf ledger)
SNAPSHOTS_ENV = "PIO_QUALITY_SNAPSHOTS"

#: variant vocabulary mirrored from rollout/plan.py WITHOUT importing it
#: (obs must stay importable with zero package dependencies beyond obs)
_BASELINE = "baseline"
_CANDIDATE = "candidate"


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Policy knobs of one process's quality monitors."""

    #: rolling-window length for the score / mix distributions (two
    #: epochs are kept, so signals cover 1–2 windows of history)
    window_s: float = 600.0
    #: live-traffic samples before the baseline snapshot auto-pins
    pin_min_samples: int = 200
    #: samples BOTH sides of a PSI comparison need before it reports —
    #: a 5-sample "distribution" would make the gate a coin flip
    min_psi_samples: int = 50
    #: sketch relative accuracy 
    rel_err: float = 0.02
    #: served-list LRU capacity for the feedback join (per process;
    #: bounded — the join is sampling, not an index)
    served_capacity: int = 1024
    #: quantiles exported as ``pio_quality_score_quantile{variant,q}``
    quantiles: Tuple[float, ...] = (0.5, 0.9, 0.99)
    #: JSONL path quality snapshots append to; None reads SNAPSHOTS_ENV
    #: at write time (unset = no snapshot persistence)
    snapshot_path: Optional[str] = None
    #: accepted rating interval at ingest; outside counts as a "range"
    #: violation (the event is still stored — observability, not veto)
    rating_range: Tuple[float, float] = (0.0, 10.0)
    #: ingest events per app before the mix baseline auto-pins
    baseline_min_events: int = 200


#: conventional user-identity payload fields, most specific first — the
#: ONE home for this order (the VARIANT_HEADER lesson: a second copy
#: silently diverges and every feedback event goes "unjoined");
#: ``rollout.plan._ENTITY_KEY_FIELDS`` extends it with item/id
#: fallbacks for sticky assignment of non-user-keyed payloads
USER_KEY_FIELDS: Tuple[str, ...] = (
    "user", "userId", "user_id", "uid", "entityId", "entity_id",
)


def feedback_key(payload) -> str:
    """The identity feedback joins on: the conventional user field of a
    query payload (the same field order ``rollout.plan.sticky_key``
    prefers), or the stringified value itself — a feedback event's raw
    user id passes through here, so both sides derive the same key."""
    if isinstance(payload, dict):
        for field in USER_KEY_FIELDS:
            value = payload.get(field)
            if isinstance(value, (str, int, float, bool)):
                return str(value)
        try:
            return json.dumps(payload, sort_keys=True, default=str)
        except (TypeError, ValueError):
            return str(payload)
    return str(payload)


def scores_from_result(result) -> Tuple[List, List[float]]:
    """Extract ``(items, scores)`` from one *encoded* prediction. The
    recommender templates' ``{"itemScores": [{"item", "score"}, ...]}``
    shape first; a bare ``{"score": x}`` scalar second; anything else
    contributes nothing (a classification label has no score
    distribution to drift)."""
    if not isinstance(result, dict):
        return [], []
    item_scores = result.get("itemScores")
    if isinstance(item_scores, list):
        items: List = []
        scores: List[float] = []
        for entry in item_scores:
            if not isinstance(entry, dict):
                continue
            score = entry.get("score")
            if isinstance(score, (int, float)) and not isinstance(
                score, bool
            ):
                items.append(entry.get("item"))
                scores.append(float(score))
        return items, scores
    score = result.get("score")
    if isinstance(score, (int, float)) and not isinstance(score, bool):
        return [result.get("item")], [float(score)]
    return [], []


class _RollingPair:
    """Two-epoch rotation of any mergeable container: ``current`` takes
    new observations, ``previous`` ages out after ``window_s`` — so a
    combined read always covers between one and two windows of history
    at bounded memory, with no per-sample timestamps. NOT thread-safe:
    the owning monitor's lock guards every call."""

    def __init__(self, clock: Callable[[], float], window_s: float, make):
        self._clock = clock
        self._window_s = window_s
        self._make = make
        self.current = make()
        self.previous = make()
        self._epoch = clock()

    def rotate(self) -> None:
        now = self._clock()
        elapsed = now - self._epoch
        if elapsed < self._window_s:
            return
        if elapsed >= 2.0 * self._window_s:
            self.previous = self._make()  # idle gap: both epochs stale
        else:
            self.previous = self.current
        self.current = self._make()
        self._epoch = now


class QualityMonitor:
    """Serving-side quality monitor: score drift + feedback join.

    One per :class:`~..workflow.serving.QueryServer`;
    the serving path records every answered query, the rollout manager
    records shadow candidates' answers, and user feedback events join
    through :meth:`record_feedback`.
    """

    def __init__(
        self,
        metrics,
        clock: Callable[[], float] = time.monotonic,
        config: Optional[QualityConfig] = None,
    ):
        self.config = config or QualityConfig()
        self.clock = clock
        self._lock = threading.Lock()
        cfg = self.config
        self._windows: Dict[str, _RollingPair] = {
            _BASELINE: self._fresh_window(),
            _CANDIDATE: self._fresh_window(),
        }
        #: the distribution pinned at model LIVE 
        self._pinned: Optional[QuantileSketch] = None
        self._served: "OrderedDict[str, List]" = OrderedDict()
        self._feedback_hits = 0
        self._feedback_total = 0
        self._rank_sketch = self._make_sketch()

        self._feedback_events = metrics.counter(
            "pio_quality_feedback_events_total",
            "Feedback events joined to served lists, by outcome",
            labelnames=("outcome",),
        )
        # variant / q are closed vocabularies: safe labels
        for variant in (_BASELINE, _CANDIDATE):
            metrics.gauge_callback(
                "pio_quality_score_psi",
                (
                    lambda v=variant: (
                        p if (p := self.score_psi(v)) is not None else -1.0
                    )
                ),
                "Served-score PSI vs the pinned baseline snapshot "
                "(-1 = abstaining: no pin yet or not enough samples)",
                labels={"variant": variant},
            )
            metrics.gauge_callback(
                "pio_quality_score_samples",
                (lambda v=variant: self._window_count(v)),
                "Score samples in the rolling window",
                labels={"variant": variant},
            )
            for q in cfg.quantiles:
                metrics.gauge_callback(
                    "pio_quality_score_quantile",
                    (lambda v=variant, qq=q: self.score_quantile(v, qq)),
                    "Served-score quantiles over the rolling window",
                    labels={"variant": variant, "q": f"{q:g}"},
                )
        metrics.gauge_callback(
            "pio_quality_feedback_hit_rate",
            self._feedback_hit_rate_export,
            "Fraction of joined feedback events whose item was in the "
            "user's last served list (-1 = no joined feedback yet)",
        )
        metrics.gauge_callback(
            "pio_quality_feedback_mean_rank",
            self._feedback_mean_rank,
            "Mean served rank (1-based) of feedback items that hit",
        )

    def _make_sketch(self) -> QuantileSketch:
        """The ONE place this monitor's sketch accuracy is set: every
        window and the rank sketch must share it, or psi() rejects the
        comparison at read time."""
        return QuantileSketch(rel_err=self.config.rel_err)

    def _fresh_window(self) -> _RollingPair:
        return _RollingPair(
            self.clock, self.config.window_s, self._make_sketch
        )

    # -- intake -----------------------------------------------------------
    def observe_result(self, variant: str, payload, result) -> None:
        """One answered query from the live serving path: score
        distribution + the served-list record the feedback join reads —
        ONE lock round-trip per request (the serving hot path, same
        discipline as ingest's ``record_event``)."""
        items, scores = scores_from_result(result)
        if variant not in self._windows or not scores:
            return
        key = (
            feedback_key(payload)
            if items and any(item is not None for item in items)
            else None
        )
        with self._lock:
            snapshot_to_write = self._record_scores_locked(variant, scores)
            if key is not None:
                self._record_served_locked(key, items)
        if snapshot_to_write is not None:
            self._write_snapshot(snapshot_to_write)

    def record_scores(self, variant: str, scores: Sequence[float]) -> None:
        """Score samples for one variant (the shadow path records the
        candidate's answers here without touching the served lists —
        a shadow answer was never shown to a user)."""
        if variant not in self._windows or not scores:
            return
        with self._lock:
            snapshot_to_write = self._record_scores_locked(variant, scores)
        if snapshot_to_write is not None:
            self._write_snapshot(snapshot_to_write)

    def _record_scores_locked(
        self, variant: str, scores: Sequence[float]
    ) -> Optional[dict]:
        """Returns the baseline-pin snapshot to persist (OUTSIDE the
        lock), or None."""
        window = self._windows[variant]
        window.rotate()
        for score in scores:
            window.current.add(score)
        if (
            self._pinned is None
            and variant == _BASELINE
            # counts add across epochs — don't pay the full sketch
            # merge on every pre-pin serving call just to compare
            and window.previous.count + window.current.count
            >= self.config.pin_min_samples
        ):
            self._pinned = self._merged_locked(_BASELINE)
            return self._snapshot_locked("baseline-pin")
        return None

    def record_served(self, key: str, items: Sequence) -> None:
        with self._lock:
            self._record_served_locked(key, items)

    def _record_served_locked(self, key: str, items: Sequence) -> None:
        served = self._served
        served[key] = list(items)
        served.move_to_end(key)
        while len(served) > self.config.served_capacity:
            served.popitem(last=False)

    def record_feedback(self, key, item) -> Optional[int]:
        """Join one user-feedback event to what was served: returns the
        1-based served rank on a hit, None otherwise. Only *joinable*
        events — users present in the served LRU — count toward the
        hit-rate: an unknown user (evicted, or feedback from before this
        process served anyone — e.g. the watcher's historical backlog on
        first start) is counted as ``unjoined`` and excluded, so the
        rate measures served-list quality, not LRU coverage."""
        rank: Optional[int] = None
        joined = False
        with self._lock:
            served = self._served.get(str(key))
            if served is not None:
                joined = True
                try:
                    rank = served.index(item) + 1
                except ValueError:
                    rank = None
                self._feedback_total += 1
                if rank is not None:
                    self._feedback_hits += 1
                    self._rank_sketch.add(rank)
        outcome = "unjoined" if not joined else (
            "hit" if rank is not None else "miss"
        )
        self._feedback_events.inc(1, outcome=outcome)
        return rank

    # -- signals ----------------------------------------------------------
    def _merged_locked(self, variant: str) -> QuantileSketch:
        window = self._windows[variant]
        window.rotate()
        return window.previous.copy().merge(window.current)

    def _window_count(self, variant: str) -> int:
        with self._lock:
            return self._merged_locked(variant).count

    def score_psi(self, variant: str) -> Optional[float]:
        """PSI of ``variant``'s rolling window against the reference
        distribution: the pinned baseline snapshot when one exists, else
        (for the candidate only) the baseline's concurrent window — the
        delta-gate spirit when a pin has not formed yet. None until both
        sides hold ``min_psi_samples``."""
        if variant not in self._windows:
            return None
        with self._lock:
            current = self._merged_locked(variant)
            reference = self._pinned
            if reference is None:
                if variant == _BASELINE:
                    return None  # nothing to drift *from* yet
                reference = self._merged_locked(_BASELINE)
            if (
                current.count < self.config.min_psi_samples
                or reference.count < self.config.min_psi_samples
            ):
                return None
            return psi(reference, current)

    def psi_for_sketch(self, sketch: QuantileSketch) -> Optional[float]:
        """PSI of an externally built score sketch against the reference
        :meth:`score_psi` uses: the continuous loop scores a candidate's
        offline replay here before submitting it. The sketch must be built
        with this monitor's ``config.rel_err``."""
        with self._lock:
            reference = self._pinned
            if reference is None:
                reference = self._merged_locked(_BASELINE)
            if (reference.count < self.config.min_psi_samples
                    or sketch.count < self.config.min_psi_samples):
                return None
            return psi(reference, sketch)

    def score_quantile(self, variant: str, q: float) -> float:
        if variant not in self._windows:
            return 0.0
        with self._lock:
            return self._merged_locked(variant).quantile(q)

    def feedback_hit_rate(self) -> float:
        with self._lock:
            if not self._feedback_total:
                return 0.0
            return self._feedback_hits / self._feedback_total

    def _feedback_hit_rate_export(self) -> float:
        """The /metrics view of the hit rate: -1 abstention sentinel
        while nothing has joined, same contract as the PSI gauges — an
        external alert on the raw gauge must never read 'no data' as a
        measured 0% hit rate."""
        with self._lock:
            if not self._feedback_total:
                return -1.0
            return self._feedback_hits / self._feedback_total

    def _feedback_mean_rank(self) -> float:
        with self._lock:
            return self._rank_sketch.mean()

    def pinned(self) -> bool:
        with self._lock:
            return self._pinned is not None

    def online_quality(self) -> dict:
        """The feedback join's digest: samples, hits, hit rate and the
        served rank."""
        with self._lock:
            out = {
                "feedbackSamples": self._feedback_total,
                "hits": self._feedback_hits,
                "hitRate": (
                    round(self._feedback_hits / self._feedback_total, 4)
                    if self._feedback_total
                    else None
                ),
            }
            if self._rank_sketch.count:
                out["meanServedRank"] = round(self._rank_sketch.mean(), 3)
                out["servedRankP50"] = round(
                    self._rank_sketch.quantile(0.5), 3
                )
            return out

    # -- model lifecycle ---------------------------------------------------
    def reset_variant(self, variant: str) -> None:
        """Drop one variant's rolling window (the rollout manager calls
        this for the candidate at every rollout START: a previously
        rolled-back candidate's skewed scores must not contaminate the
        NEXT candidate's PSI for up to 2x window_s — the quarantine
        livelock the offline path already guards against)."""
        if variant not in self._windows:
            return
        with self._lock:
            self._windows[variant] = self._fresh_window()

    def model_live(self, source: str) -> None:
        """A new model went LIVE: persist the closing snapshot, drop the
        old pin and windows, and let the next ``pin_min_samples`` of
        live traffic pin the NEW baseline distribution — drift is always
        measured against the distribution of the model actually serving."""
        with self._lock:
            closing = self._snapshot_locked(f"model-live:{source}")
            self._pinned = None
            for variant in self._windows:
                self._windows[variant] = self._fresh_window()
        self._write_snapshot(closing)

    # -- snapshots ---------------------------------------------------------
    def _snapshot_locked(self, source: str) -> dict:
        serving = {}
        psi_out = {}
        for variant in self._windows:
            merged = self._merged_locked(variant)
            if merged.count:
                serving[variant] = merged.to_dict()
            reference = self._pinned
            if reference is None and variant == _CANDIDATE:
                reference = self._merged_locked(_BASELINE)
            value = (
                psi(reference, merged)
                if reference is not None
                and reference.count >= self.config.min_psi_samples
                and merged.count >= self.config.min_psi_samples
                else None
            )
            if value is not None:
                psi_out[variant] = round(value, 6)
        out: dict = {
            "schema": SNAPSHOT_SCHEMA,
            "kind": "quality",
            "source": source,
            "serving": serving,
            "psi": psi_out,
            # the deployment's configured floor rides the snapshot so
            # `pio quality --diff` abstains at the SAME bar the live
            # reads used, not a hard-coded default
            "minPsiSamples": self.config.min_psi_samples,
            "feedback": {
                "total": self._feedback_total,
                "hits": self._feedback_hits,
            },
        }
        if self._pinned is not None:
            out["pinnedBaseline"] = self._pinned.to_dict()
        return out

    def snapshot(self, source: str = "live") -> dict:
        with self._lock:
            return self._snapshot_locked(source)

    def summary(self) -> dict:
        """Small status-page / bench digest (no bucket payloads)."""
        with self._lock:
            out: dict = {
                "pinned": self._pinned is not None,
                "samples": {
                    variant: self._merged_locked(variant).count
                    for variant in self._windows
                },
            }
        out["scorePsi"] = {
            variant: (
                round(value, 6)
                if (value := self.score_psi(variant)) is not None
                else None
            )
            for variant in (_BASELINE, _CANDIDATE)
        }
        out["online"] = self.online_quality()
        return out

    def _write_snapshot(self, snap: dict) -> None:
        """Durable JSONL append (OUTSIDE the monitor lock — the fsync
        must never block a scrape or the serving path)."""
        path = self.config.snapshot_path or os.environ.get(SNAPSHOTS_ENV)
        if not path:
            return
        try:
            append_snapshot(path, snap)
        except OSError:
            pass  # evidence persistence must never fail serving


class IngestQualityMonitor:
    """Event-server-side data-quality monitor: per-app violation
    counters and event-type mix drift vs a durable baseline."""

    def __init__(
        self,
        metrics,
        clock: Callable[[], float] = time.monotonic,
        config: Optional[QualityConfig] = None,
        baseline_dir: Optional[str] = None,
    ):
        self.config = config or QualityConfig()
        self.clock = clock
        self._metrics = metrics
        self._baseline_dir = baseline_dir
        self._lock = threading.Lock()
        #: app_id -> rolling event-name count window
        self._mix: Dict[int, _RollingPair] = {}
        #: app_id -> cumulative event count (auto-pin trigger)
        self._totals: Dict[int, int] = {}
        #: app_id -> pinned {event_name: count} baseline
        self._baselines: Dict[int, Optional[Dict[str, float]]] = {}
        self._violations = metrics.counter(
            "pio_quality_ingest_violations_total",
            "Ingest data-quality violations by app and kind "
            "(schema / range / poison)",
            labelnames=("app", "kind"),
        )
        self._events = metrics.counter(
            "pio_quality_ingest_events_total",
            "Accepted events counted by the ingest quality monitor",
            labelnames=("app",),
        )

    # -- intake -----------------------------------------------------------
    def _ensure_app(self, app_id: int) -> None:
        """Lazily create the per-app window, load any durable baseline,
        and register the per-app PSI gauge (bounded by the app count —
        a closed operator-controlled set). The baseline read is disk
        I/O, so it happens OUTSIDE the monitor lock (same discipline as
        the write side) with a double-checked insert; the losing thread
        discards its read."""
        with self._lock:
            if app_id in self._mix:
                return
        loaded = self._load_baseline(app_id)
        with self._lock:
            if app_id in self._mix:
                return
            self._mix[app_id] = _RollingPair(
                self.clock, self.config.window_s, dict
            )
            self._totals[app_id] = 0
            self._baselines[app_id] = loaded
        # the registry takes its own lock; callbacks fire at collect
        # time and take the monitor lock — registering outside both
        # keeps the ordering acyclic
        self._metrics.gauge_callback(
            "pio_quality_event_mix_psi",
            (
                lambda a=app_id: (
                    p if (p := self.mix_psi(a)) is not None else -1.0
                )
            ),
            "Event-type mix PSI vs the app's pinned baseline "
            "(-1 = abstaining: no baseline yet or an empty window)",
            labels={"app": str(app_id)},
        )

    def record_event(self, app_id: int, event) -> None:
        """One accepted event: mix accounting + value-quality checks.
        Violations are counted, never rejected here — the schema gate
        already ran; these are *quality* signals."""
        name = getattr(event, "event", None) or "?"
        violation: Optional[str] = None
        if name == "rate":
            rating = None
            props = getattr(event, "properties", None)
            if props is not None:
                try:
                    rating = props.to_dict().get("rating")
                except Exception:
                    rating = None
            if not isinstance(rating, (int, float)) or isinstance(
                rating, bool
            ) or (isinstance(rating, float) and math.isnan(rating)):
                violation = "poison"  # a rate with no usable rating
            else:
                low, high = self.config.rating_range
                if not (low <= float(rating) <= high):
                    violation = "range"
        pin: Optional[Dict[str, float]] = None
        ensured = False
        while True:
            # hot path: one lock round-trip per event — the membership
            # check rides the accounting lock; only an app's FIRST event
            # falls out to the lazy-init (disk-reading) slow path
            with self._lock:
                window = self._mix.get(app_id)
                if window is not None:
                    window.rotate()
                    counts = window.current
                    counts[name] = counts.get(name, 0) + 1
                    self._totals[app_id] += 1
                    if (
                        self._baselines.get(app_id) is None
                        and self._totals[app_id]
                        >= self.config.baseline_min_events
                    ):
                        pin = self._merged_mix_locked(app_id)
                        self._baselines[app_id] = pin
                    break
            if ensured:  # _ensure_app ran yet the window vanished: bail
                return   # rather than spin (nothing removes apps today)
            self._ensure_app(app_id)
            ensured = True
        self._events.inc(1, app=str(app_id))
        if violation is not None:
            self._violations.inc(1, app=str(app_id), kind=violation)
        if pin is not None:
            self._persist_baseline(app_id, pin)

    def record_rejected(self, app_id: int) -> None:
        """A 400 the schema gate produced for an authenticated app."""
        self._ensure_app(app_id)
        self._violations.inc(1, app=str(app_id), kind="schema")

    # -- signals ----------------------------------------------------------
    def _merged_mix_locked(self, app_id: int) -> Dict[str, float]:
        window = self._mix[app_id]
        window.rotate()
        merged = dict(window.previous)
        for name, n in window.current.items():
            merged[name] = merged.get(name, 0) + n
        return merged

    def mix_psi(self, app_id: int) -> Optional[float]:
        with self._lock:
            if app_id not in self._mix:
                return None
            baseline = self._baselines.get(app_id)
            if not baseline:
                return None
            current = self._merged_mix_locked(app_id)
            return categorical_psi(baseline, current)

    def pin_baseline(self, app_id: int) -> Optional[Dict[str, float]]:
        """Explicitly (re)pin the app's mix baseline from the current
        window (operators re-baseline after an intentional mix change)."""
        with self._lock:
            if app_id not in self._mix:
                return None
            pin = self._merged_mix_locked(app_id)
            self._baselines[app_id] = pin
        self._persist_baseline(app_id, pin)
        return pin

    def summary(self) -> dict:
        with self._lock:
            apps = sorted(self._mix)
            out = {
                str(app_id): {
                    "events": self._totals.get(app_id, 0),
                    "baselinePinned": bool(self._baselines.get(app_id)),
                }
                for app_id in apps
            }
        for app_id in apps:
            value = self.mix_psi(app_id)
            if value is not None:
                out[str(app_id)]["mixPsi"] = round(value, 6)
        return out

    # -- durable baselines -------------------------------------------------
    def _baseline_path(self, app_id: int) -> Optional[str]:
        if not self._baseline_dir:
            return None
        return os.path.join(
            self._baseline_dir, f"ingest_baseline_{app_id}.json"
        )

    def _load_baseline(self, app_id: int) -> Optional[Dict[str, float]]:
        path = self._baseline_path(app_id)
        if not path:
            return None
        try:
            with open(path, encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(data, dict):
            return None
        counts = data.get("mix")
        if not isinstance(counts, dict):
            return None
        out: Dict[str, float] = {}
        for name, n in counts.items():
            try:
                out[str(name)] = float(n)
            except (TypeError, ValueError):
                continue
        return out or None

    def _persist_baseline(
        self, app_id: int, counts: Dict[str, float]
    ) -> None:
        """Durable write OUTSIDE the monitor lock (fsync discipline)."""
        path = self._baseline_path(app_id)
        if not path:
            return
        try:
            from ..utils.durability import atomic_write_bytes

            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write_bytes(
                path,
                json.dumps(
                    {"schema": SNAPSHOT_SCHEMA, "app": app_id,
                     "mix": counts}
                ).encode(),
            )
        except OSError:
            pass  # a read-only state dir degrades to in-memory baselines


# -- snapshot persistence / comparison ---------------------------------------


def append_snapshot(path: str, snap: dict) -> None:
    """One fsynced JSONL line (the perf ledger's append discipline)."""
    from .perfledger import append_record

    append_record(path, snap)


def load_snapshots(path: str) -> List[dict]:
    """Every parseable quality snapshot in file order; torn or foreign
    lines are skipped, never fatal."""
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
                if (
                    isinstance(parsed, dict)
                    and parsed.get("kind") == "quality"
                ):
                    out.append(parsed)
    except OSError:
        return []
    return out


def snapshot_psi(
    reference: dict,
    current: dict,
    variant: str = _BASELINE,
    min_samples: int = QualityConfig.min_psi_samples,
) -> Optional[float]:
    """PSI between the same variant's serving sketch in two snapshots
    (the ``pio quality --diff`` comparison). None when either snapshot
    lacks that variant, the accuracy parameters disagree, or either
    side holds fewer than ``min_samples`` — the same floor every live
    PSI read applies: a handful-of-queries closing snapshot is sampling
    noise, not a drift verdict."""
    ref_doc = (reference.get("serving") or {}).get(variant)
    cur_doc = (current.get("serving") or {}).get(variant)
    if not isinstance(ref_doc, dict) or not isinstance(cur_doc, dict):
        return None
    try:
        ref_sketch = QuantileSketch.from_dict(ref_doc)
        cur_sketch = QuantileSketch.from_dict(cur_doc)
        if (
            ref_sketch.count < min_samples
            or cur_sketch.count < min_samples
        ):
            return None
        return psi(ref_sketch, cur_sketch)
    except (TypeError, ValueError):
        return None
