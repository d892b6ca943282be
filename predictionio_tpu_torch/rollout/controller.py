"""RolloutController: promotion-gate evaluation over sliding windows.

Copy of ``predictionio_tpu/rollout/controller.py``, the decision half of
the rollout plane. The query server feeds every served request into a
per-variant :class:`VariantWindow` (and every shadow comparison into a
divergence window); :meth:`RolloutController.evaluate` reduces them and
the stage's residence time to one verdict:

- ``rollback`` — a gate is violated with ``min_samples`` candidate
  observations; fires at once, at any stage.
- ``promote`` — every gate passes, the candidate has enough samples and
  the stage's hold time has elapsed.
- ``hold`` — not enough evidence yet, or the hold is still running.

Gates are deltas against the baseline over the same window: candidate
error rate above the baseline's by at most ``max_error_rate_delta``,
candidate p99 at most ``max_p99_latency_ratio`` times the baseline's and
(shadow) mean divergence at most ``max_divergence``. The clock is
injected and nothing here touches storage or the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Optional, Tuple

from ..storage.metadata import ROLLOUT_SHADOW
from .plan import GateConfig

__all__ = ["RolloutController", "VariantWindow"]

#: evaluate() verdicts
HOLD = "hold"
PROMOTE = "promote"
ROLLBACK = "rollback"


class VariantWindow:
    """Sliding window of (timestamp, latency, ok) samples for one
    variant. Bounded two ways: by age (``window_s``, pruned against the
    injected clock on every touch) and by count (``max_samples``, a
    memory cap — the gates need a recent representative sample, not
    every request at a million QPS).

    Gate evaluation runs on the serving hot path (once per request), so
    ``count``/``error_rate`` are O(1) off a running error counter; only
    ``p99`` pays a sort, and the caller only reaches it once both
    windows hold ``min_samples``."""

    def __init__(
        self,
        clock: Callable[[], float],
        window_s: float,
        max_samples: int = 4096,
    ):
        self._clock = clock
        self._window_s = window_s
        self._max_samples = max_samples
        self._samples: Deque[Tuple[float, float, bool]] = deque()
        self._errors = 0
        self._p99_cache: Optional[float] = None
        self._since_p99 = 0
        self._lock = threading.Lock()

    def record(self, latency_s: float, ok: bool) -> None:
        now = self._clock()
        with self._lock:
            if len(self._samples) >= self._max_samples:
                self._evict_oldest()
            self._samples.append((now, latency_s, ok))
            if not ok:
                self._errors += 1
            self._since_p99 += 1
            self._prune(now)

    def _evict_oldest(self) -> None:
        _t, _lat, ok = self._samples.popleft()
        if not ok:
            self._errors -= 1

    def _prune(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._evict_oldest()

    def count(self) -> int:
        with self._lock:
            self._prune(self._clock())
            return len(self._samples)

    def error_rate(self) -> float:
        with self._lock:
            self._prune(self._clock())
            if not self._samples:
                return 0.0
            return self._errors / len(self._samples)

    #: recompute the p99 sort at most once per this many new samples —
    #: evaluate() runs per request, and a per-request O(n log n) sort of
    #: a full window under the manager lock is hot-path poison; a p99
    #: that lags by <32 samples changes no gate decision
    _P99_REFRESH_EVERY = 32

    def p99(self) -> float:
        """p99 over the window: an exact sort, cached and refreshed
        every ``_P99_REFRESH_EVERY`` recorded samples."""
        with self._lock:
            self._prune(self._clock())
            if (
                self._p99_cache is not None
                and self._since_p99 < self._P99_REFRESH_EVERY
            ):
                return self._p99_cache
            lats = sorted(lat for _, lat, ok in self._samples if ok)
            if not lats:
                value = 0.0
            else:
                rank = max(0, min(len(lats) - 1, int(0.99 * len(lats))))
                value = lats[rank]
            self._p99_cache = value
            self._since_p99 = 0
            return value

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()
            self._errors = 0
            self._p99_cache = None
            self._since_p99 = 0


class RolloutController:
    """Gate evaluator for one rollout: owns the windows, the stage
    timer, and the promote/hold/rollback verdict."""

    def __init__(
        self,
        gates: GateConfig,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.gates = gates
        self.clock = clock
        self.baseline = VariantWindow(clock, gates.window_s)
        self.candidate = VariantWindow(clock, gates.window_s)
        self._divergence: Deque[Tuple[float, float]] = deque(maxlen=4096)
        self._div_lock = threading.Lock()
        self.stage_started = clock()
        #: optional served-score drift source for the ``max_score_psi``
        #: gate: a zero-arg callable returning the candidate's current
        #: PSI vs the quality monitor's pinned baseline, or None while
        #: there is not enough data (the gate abstains on None). The
        #: RolloutManager wires this to
        #: ``QualityMonitor.score_psi("candidate")`` — kept as an
        #: injected callable so the gate logic stays testable without a
        #: monitor.
        self.quality_psi: Optional[Callable[[], Optional[float]]] = None

    # -- sample intake ----------------------------------------------------
    def record(self, variant_is_candidate: bool, latency_s: float, ok: bool) -> None:
        (self.candidate if variant_is_candidate else self.baseline).record(
            latency_s, ok
        )

    def record_divergence(self, value: float) -> None:
        now = self.clock()
        with self._div_lock:
            self._divergence.append((now, value))

    def mean_divergence(self) -> Optional[float]:
        cutoff = self.clock() - self.gates.window_s
        with self._div_lock:
            while self._divergence and self._divergence[0][0] < cutoff:
                self._divergence.popleft()
            values = [v for _, v in self._divergence]
        if not values:
            return None
        return sum(values) / len(values)

    def enter_stage(self) -> None:
        """Reset the residence timer on a stage transition. The metric
        windows carry over deliberately: a candidate that was erroring
        in shadow does not get a clean slate in canary."""
        self.stage_started = self.clock()

    def stage_elapsed_s(self) -> float:
        return max(0.0, self.clock() - self.stage_started)

    # -- verdict ----------------------------------------------------------
    def evaluate(self, stage: str) -> Tuple[str, str]:
        """One (verdict, reason) pair for the current windows. Pure with
        respect to the injected clock — calling it never mutates gate
        state beyond window pruning."""
        g = self.gates
        cand_n = self.candidate.count()
        base_n = self.baseline.count()

        # Violation checks first: enough candidate evidence + a tripped
        # gate rolls back NOW, hold timers notwithstanding.
        if cand_n >= g.min_samples:
            base_err = self.baseline.error_rate() if base_n else 0.0
            delta = self.candidate.error_rate() - base_err
            if delta > g.max_error_rate_delta:
                return ROLLBACK, (
                    f"error-rate delta {delta:.4f} exceeds "
                    f"{g.max_error_rate_delta:.4f} "
                    f"(candidate {self.candidate.error_rate():.4f} vs "
                    f"baseline {base_err:.4f} over {cand_n}/{base_n} samples)"
                )
            if base_n >= g.min_samples:
                base_p99 = self.baseline.p99()
                cand_p99 = self.candidate.p99()
                if base_p99 > 0 and cand_p99 > base_p99 * g.max_p99_latency_ratio:
                    return ROLLBACK, (
                        f"candidate p99 {cand_p99 * 1000:.2f}ms exceeds "
                        f"{g.max_p99_latency_ratio:.1f}x baseline p99 "
                        f"{base_p99 * 1000:.2f}ms"
                    )
            if stage == ROLLOUT_SHADOW:
                mean_div = self.mean_divergence()
                if mean_div is not None and mean_div > g.max_divergence:
                    return ROLLBACK, (
                        f"mean shadow divergence {mean_div:.4f} exceeds "
                        f"{g.max_divergence:.4f}"
                    )
            if g.max_score_psi > 0 and self.quality_psi is not None:
                # score-distribution drift (both stages: shadow answers
                # feed the candidate sketch too, so a skewed candidate
                # rolls back before it ever serves a user). Abstains on
                # None — "not enough data" must hold, never promote a
                # drift verdict either way.
                score_psi = self.quality_psi()
                if score_psi is not None and score_psi > g.max_score_psi:
                    return ROLLBACK, (
                        f"candidate score PSI {score_psi:.4f} exceeds "
                        f"{g.max_score_psi:.4f} vs the baseline score "
                        "distribution"
                    )

        if cand_n < g.min_samples:
            return HOLD, (
                f"waiting for candidate samples ({cand_n}/{g.min_samples})"
            )
        hold_s = g.shadow_hold_s if stage == ROLLOUT_SHADOW else g.canary_hold_s
        elapsed = self.stage_elapsed_s()
        if elapsed < hold_s:
            return HOLD, f"holding {stage} ({elapsed:.1f}/{hold_s:.1f}s)"
        return PROMOTE, (
            f"gates passed over {cand_n} candidate / {base_n} baseline "
            f"samples after {elapsed:.1f}s in {stage}"
        )
