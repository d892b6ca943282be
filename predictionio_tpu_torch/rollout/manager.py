"""RolloutManager: the query server's deployment-lifecycle state machine.

Trimmed copy of ``predictionio_tpu/rollout/manager.py``. One manager per
:class:`~..workflow.serving.QueryServer` drives a candidate
``EngineInstance`` from trained to live:

- **SHADOW** — the candidate is resident on the card beside the
  baseline; every served query is duplicated to it on a two-worker pool
  with a cap on pending work (answer discarded; latency, errors and the
  prediction divergence recorded). Clients see baseline answers only.
- **CANARY** — a sticky share of keys (``RolloutPlan.salt`` and
  ``percent``) is served by the candidate; a candidate failure is served
  again from the baseline inside the same request.
- **LIVE** — the candidate becomes ``server.deployment``; the retired
  baseline's model references are dropped, so its tables on the card can
  be freed.
- **ROLLED_BACK / ABORTED** — the candidate is retired and the baseline
  keeps all traffic; the terminal stage and its reason are stored.

The candidate's queries (shadow duplicates and canary traffic) go
through a micro-batcher of their own, so each deployment's batches, and
so its top-k kernel launches, are counted apart
(:attr:`RolloutManager.candidate_batches`). The controller decides every
transition after each recorded sample; transitions are written to the
metadata store (a failed write is retried on later requests) and to the
flight recorder, and a server restarted mid-rollout resumes the same
plan (same salt, same split) from ``rollout_plan_get_active``.
"""

from __future__ import annotations

import dataclasses
import logging
import secrets
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Deque, List, Optional

from ..obs.flight import record as flight_record
from ..storage.event import to_millis, utcnow
from ..storage.metadata import (
    ROLLOUT_ABORTED,
    ROLLOUT_CANARY,
    ROLLOUT_LIVE,
    ROLLOUT_ROLLED_BACK,
    ROLLOUT_SHADOW,
    STATUS_COMPLETED,
    RolloutPlan,
)
from .controller import PROMOTE, ROLLBACK, RolloutController
from .plan import (
    BASELINE,
    CANDIDATE,
    GateConfig,
    plan_to_json,
    prediction_divergence,
    sticky_key,
    variant_for_key,
)

logger = logging.getLogger(__name__)

__all__ = ["RolloutError", "RolloutManager"]

#: pio_rollout_stage gauge vocabulary
_STAGE_CODES = {
    None: 0,
    ROLLOUT_SHADOW: 1,
    ROLLOUT_CANARY: 2,
    ROLLOUT_LIVE: 3,
    ROLLOUT_ROLLED_BACK: 4,
    ROLLOUT_ABORTED: 5,
}

#: divergence lives in [0, 1]
_DIVERGENCE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

#: shadow duplicates in flight before new ones are dropped (counted as
#: kind="shadow_dropped"): shadow evaluation samples, it never queues
#: without bound behind a slow candidate
_SHADOW_PENDING_CAP = 32

#: the shadow pool's workers
SHADOW_WORKERS = 2


class RolloutError(ValueError):
    """Lifecycle misuse (no active plan, a plan already active, an
    unknown or unloadable candidate) → HTTP 409 on the rollout routes."""


class RolloutManager:
    """One query server's rollout state: the durable plan, the resident
    candidate deployment and its micro-batcher, the gate controller and
    the shadow pool."""

    def __init__(self, server):
        self.server = server
        self.clock = server.clock
        self._lock = threading.RLock()
        self.plan: Optional[RolloutPlan] = None
        self.candidate_dep = None
        #: the candidate deployment's own micro-batcher (None between rollouts)
        self.candidate_batcher = None
        self.controller: Optional[RolloutController] = None
        #: set when a transition's metadata write failed; retried on the
        #: next request until it lands (serving never blocks on it)
        self._persist_pending = False
        self._shadow_pool = ThreadPoolExecutor(
            max_workers=SHADOW_WORKERS, thread_name_prefix="shadow"
        )
        self._shadow_pending = 0
        self._shadow_futures: Deque = deque(maxlen=256)
        self._shadow_counts = dict.fromkeys(("submitted", "ok", "errors", "dropped"), 0)
        self._shadow_last_error: Optional[str] = None
        #: batchers retired by a transition, closed outside the lock
        self._retiring: List[Any] = []
        self._retired_batches = 0
        #: max_score_psi gate cache, recomputed every _PSI_RECHECK_EVERY
        #: evaluates (score_psi() merges sketch copies)
        self._psi_cached: Optional[float] = None
        self._psi_countdown = 0

        metrics = server.metrics
        self._hist = metrics.histogram(
            "pio_rollout_request_seconds",
            "Per-variant serving latency while a rollout is active",
            labelnames=("variant",),
        )
        self._events = metrics.counter(
            "pio_rollout_events_total",
            "Rollout serving outcomes by variant",
            labelnames=("variant", "kind"),
        )
        self._div_hist = metrics.histogram(
            "pio_rollout_divergence",
            "Shadow candidate-vs-baseline prediction divergence",
            buckets=_DIVERGENCE_BUCKETS,
        )
        self._transitions = metrics.counter(
            "pio_rollout_transitions_total",
            "Rollout plan state transitions",
            labelnames=("to",),
        )
        metrics.gauge_callback(
            "pio_rollout_stage",
            self._stage_code,
            "Rollout stage (0 none, 1 shadow, 2 canary, 3 live, "
            "4 rolled-back, 5 aborted)",
        )
        metrics.gauge_callback(
            "pio_rollout_percent",
            self._live_percent,
            "Traffic share the candidate currently serves",
        )

    # -- introspection (scrape-thread callbacks take the lock) -------------
    def _stage_code(self) -> int:
        with self._lock:
            plan = self.plan
            return _STAGE_CODES.get(plan.stage if plan else None, 0)

    def _live_percent(self) -> float:
        with self._lock:
            plan = self.plan
            if plan is None:
                return 0.0
            if plan.stage == ROLLOUT_CANARY:
                return float(plan.percent)
            return 100.0 if plan.stage == ROLLOUT_LIVE else 0.0

    @property
    def active(self) -> bool:
        plan = self.plan
        return plan is not None and plan.stage in (ROLLOUT_SHADOW, ROLLOUT_CANARY)

    @property
    def stage(self) -> Optional[str]:
        plan = self.plan
        return plan.stage if plan else None

    @property
    def candidate_batches(self) -> int:
        """Batches the candidate batchers of this manager dispatched, the
        retired ones included: one top-k kernel launch each on the card."""
        with self._lock:
            live = self.candidate_batcher
            total = self._retired_batches
        return total + (live.stats["batches"] if live is not None else 0)

    def _md(self):
        return self.server.registry.get_metadata()

    def _load(self, instance_id: str):
        """``prepare_deployment`` of one instance under the server's
        config and context (its device): the candidate's tables go where
        the baseline's are."""
        from ..workflow.serving import prepare_deployment

        cfg = dataclasses.replace(self.server.config, engine_instance_id=instance_id)
        return prepare_deployment(self.server.engine, self.server.registry, cfg,
                                  self.server.ctx)

    def _install(self, plan: RolloutPlan, candidate_dep, gate_cfg: GateConfig) -> None:
        """Adopt ``plan`` with its resident candidate (lock held)."""
        self.plan = plan
        self.candidate_dep = candidate_dep
        self.candidate_batcher = self.server._new_batcher("candidate-batch")
        self.controller = RolloutController(gate_cfg, clock=self.clock)
        self.controller.quality_psi = self._candidate_score_psi
        self._psi_cached = None
        self._psi_countdown = 0
        self._shadow_counts = dict.fromkeys(self._shadow_counts, 0)
        self._shadow_last_error = None

    # -- lifecycle --------------------------------------------------------
    def start(
        self,
        candidate_instance_id: Optional[str] = None,
        percent: Optional[float] = None,
        gates: Optional[dict] = None,
        reason: str = "rollout started",
    ) -> dict:
        """Open a new plan in SHADOW: load the candidate beside the
        baseline (outside the lock: a model load must not stall
        ``status()`` and every request) and store the plan before the
        first duplicated query. A candidate that is missing, not
        completed or fails to load raises :class:`RolloutError`."""
        with self._lock:
            if self.active:
                raise RolloutError(
                    f"rollout {self.plan.id} is already active "
                    f"(stage {self.plan.stage}); promote or abort it first"
                )
            baseline = self.server.deployment.instance
        md = self._md()
        if candidate_instance_id:
            inst = md.engine_instance_get(candidate_instance_id)
            if inst is None:
                raise RolloutError(f"engine instance {candidate_instance_id!r} not found")
        else:
            inst = md.engine_instance_get_latest_completed(
                baseline.engine_id, baseline.engine_version, baseline.engine_variant)
            if inst is None or inst.id == baseline.id:
                raise RolloutError(
                    "no completed candidate newer than the deployed "
                    f"baseline {baseline.id}; train first or pass an "
                    "explicit instanceId"
                )
        if inst.status != STATUS_COMPLETED:
            raise RolloutError(
                f"engine instance {inst.id} has status {inst.status}, not COMPLETED")
        gate_cfg = GateConfig.from_dict(gates or {})
        if percent is not None:
            gate_cfg = dataclasses.replace(gate_cfg, canary_percent=float(percent))
        p = gate_cfg.canary_percent
        if not (0.0 < p <= 100.0):  # NaN fails both comparisons too
            raise RolloutError(
                f"canary percent must be in (0, 100], got {p!r} — a NaN or "
                "out-of-range split would 500 every canary query"
            )
        try:
            candidate_dep = self._load(inst.id)
        except Exception as exc:
            raise RolloutError(f"candidate {inst.id} could not be loaded: {exc}") from exc
        with self._lock:
            if self.active:  # lost a race with a concurrent start
                raise RolloutError(
                    f"rollout {self.plan.id} is already active "
                    f"(stage {self.plan.stage}); promote or abort it first"
                )
            baseline = self.server.deployment.instance
            now = utcnow()
            plan = RolloutPlan(
                id="",
                stage=ROLLOUT_SHADOW,
                engine_id=baseline.engine_id,
                engine_version=baseline.engine_version,
                engine_variant=baseline.engine_variant,
                baseline_instance_id=baseline.id,
                candidate_instance_id=inst.id,
                percent=gate_cfg.canary_percent,
                salt=secrets.token_hex(8),
                created_time=now,
                updated_time=now,
                gates=gate_cfg.to_dict(),
                history=[self._history_entry(ROLLOUT_SHADOW, reason)],
            )
            pid = md.rollout_plan_upsert(plan)
            self._install(dataclasses.replace(plan, id=pid), candidate_dep, gate_cfg)
            # a fresh rollout judges THIS candidate's score distribution
            quality = getattr(self.server, "quality", None)
            if quality is not None:
                quality.reset_variant(CANDIDATE)
            self._persist_pending = False
            self._transitions.inc(1, to=ROLLOUT_SHADOW)
            flight_record("rollout", "rollout.stage", plan=pid, to=ROLLOUT_SHADOW,
                          candidate=inst.id)
            logger.info("rollout %s: candidate %s shadowing baseline %s",
                        pid, inst.id, baseline.id)
            return self.status()

    def resume(self) -> None:
        """Re-resolve the active plan from metadata and rebuild the same
        routing (same salt, same percent). Called at server start; a
        missing or broken plan leaves plain baseline serving."""
        with self._lock:
            deployed = self.server.deployment.instance
            md = self._md()
            plan = md.rollout_plan_get_active(
                deployed.engine_id, deployed.engine_version, deployed.engine_variant)
            if plan is None:
                self._quarantine_rolled_back(md, deployed)
                return
            candidate_dep = None
            if deployed.id == plan.candidate_instance_id:
                # the candidate is the latest completed instance, so a
                # restarted server loaded it by default: reload the plan's
                # baseline and keep the candidate as candidate
                try:
                    baseline_dep = self._load(plan.baseline_instance_id)
                except Exception as exc:
                    self._persist_terminal(
                        plan, ROLLOUT_ABORTED,
                        f"baseline unloadable on resume: {exc}; the "
                        "candidate remains deployed")
                    return
                with self.server._deploy_lock:
                    candidate_dep = self.server.deployment
                    self.server.deployment = baseline_dep
                self.server._export_train_phases()
            elif deployed.id != plan.baseline_instance_id:
                self._persist_terminal(
                    plan, ROLLOUT_ABORTED, f"superseded by deployed instance {deployed.id}")
                return
            if candidate_dep is None:
                try:
                    candidate_dep = self._load(plan.candidate_instance_id)
                except Exception as exc:
                    self._persist_terminal(
                        plan, ROLLOUT_ABORTED, f"candidate unloadable on resume: {exc}")
                    return
            gate_cfg = GateConfig.from_dict(plan.gates) if plan.gates else GateConfig()
            self._install(plan, candidate_dep, gate_cfg)
            logger.info("rollout %s resumed at stage %s (candidate %s)",
                        plan.id, plan.stage, plan.candidate_instance_id)

    def _quarantine_rolled_back(self, md, deployed) -> None:
        """No active plan, but the instance this server loaded (the latest
        completed one) may be a candidate a finished plan rolled back:
        serve that plan's baseline instead. An explicit
        ``engine_instance_id`` still wins."""
        if self.server.config.engine_instance_id:
            return
        latest = md.rollout_plan_get_latest(
            deployed.engine_id, deployed.engine_version, deployed.engine_variant)
        if (latest is None or latest.stage not in (ROLLOUT_ROLLED_BACK, ROLLOUT_ABORTED)
                or deployed.id != latest.candidate_instance_id):
            return
        try:
            baseline_dep = self._load(latest.baseline_instance_id)
        except Exception:
            self.plan = latest
            logger.exception(
                "rollout %s: quarantine failed — baseline %s unloadable; the %s "
                "candidate %s remains deployed", latest.id,
                latest.baseline_instance_id, latest.stage, latest.candidate_instance_id)
            return
        with self.server._deploy_lock:
            self.server.deployment = baseline_dep
        self.server._export_train_phases()
        self.plan = latest
        logger.warning(
            "rollout %s: candidate %s is quarantined (%s); serving its baseline %s",
            latest.id, latest.candidate_instance_id, latest.stage,
            latest.baseline_instance_id)

    def promote(self, reason: str = "manual promote") -> dict:
        """Operator override: advance one stage regardless of gates."""
        try:
            with self._lock:
                if not self.active:
                    raise RolloutError("no active rollout to promote")
                self._advance_stage(reason)
                return self.status()
        finally:
            self._close_retired()

    def abort(self, reason: str = "manual abort") -> dict:
        """Operator override: retire the candidate, baseline takes 100 %."""
        try:
            with self._lock:
                if not self.active:
                    raise RolloutError("no active rollout to abort")
                self._retire_candidate(ROLLOUT_ABORTED, reason)
                return self.status()
        finally:
            self._close_retired()

    def close(self) -> None:
        self._shadow_pool.shutdown(wait=False)
        with self._lock:
            if self.candidate_batcher is not None:
                self._retiring.append(self.candidate_batcher)
                self.candidate_batcher = None
        self._close_retired()

    # -- request-path hooks (QueryServer.handle_query) --------------------
    def variant_for(self, payload: Any) -> str:
        """Sticky variant of one query; only CANARY routes real traffic
        to the candidate."""
        plan = self.plan
        if plan is None or plan.stage != ROLLOUT_CANARY or self.candidate_dep is None:
            return BASELINE
        return variant_for_key(plan.salt, sticky_key(payload), plan.percent)

    def candidate_deployment(self):
        return self.candidate_dep

    _PSI_RECHECK_EVERY = 16

    def _candidate_score_psi(self):
        """The ``max_score_psi`` gate's source: the candidate's
        served-score PSI off the server's quality monitor (None while
        there is too little data), recomputed every
        ``_PSI_RECHECK_EVERY`` evaluates."""
        quality = getattr(self.server, "quality", None)
        if quality is None:
            return None
        self._psi_countdown -= 1
        if self._psi_countdown < 0:
            self._psi_cached = quality.score_psi(CANDIDATE)
            self._psi_countdown = self._PSI_RECHECK_EVERY - 1
        return self._psi_cached

    def observe(self, variant: str, latency_s: float, ok: bool) -> None:
        """Record one served request and re-evaluate the gates."""
        try:
            with self._lock:
                if not self.active or self.controller is None:
                    return
                self.controller.record(variant == CANDIDATE, latency_s, ok)
                self._hist.observe(latency_s, variant=variant)
                self._events.inc(1, variant=variant, kind="ok" if ok else "error")
                self._maybe_advance()
        finally:
            self._close_retired()

    def retry_pending_persist(self) -> None:
        """Land a transition whose metadata write failed (called once a
        request; lock-free when nothing is pending): a terminal
        transition has no later ``observe()`` to ride."""
        if not self._persist_pending:
            return
        with self._lock:
            if self._persist_pending and self.plan is not None:
                self._try_persist(self.plan)

    def submit_shadow(self, payload: Any, baseline_result: Any):
        """Duplicate one query to the resident candidate (SHADOW): on the
        bounded pool, answer discarded, outcome recorded. Returns the
        Future, or None when dropped."""
        with self._lock:
            if (not self.active or self.plan.stage != ROLLOUT_SHADOW
                    or self.candidate_dep is None):
                return None
            if self._shadow_pending >= _SHADOW_PENDING_CAP:
                self._shadow_counts["dropped"] += 1
                self._events.inc(1, variant=CANDIDATE, kind="shadow_dropped")
                return None
            self._shadow_pending += 1
            self._shadow_counts["submitted"] += 1
            dep = self.candidate_dep
            plan_id = self.plan.id
        try:
            future = self._shadow_pool.submit(
                self._run_shadow, dep, payload, baseline_result, plan_id)
        except RuntimeError:  # pool shut down mid-stop
            with self._lock:
                self._shadow_pending -= 1
            return None
        with self._lock:
            self._shadow_futures.append(future)
        return future

    def drain_shadow(self, timeout_s: float = 30.0) -> None:
        """Wait for every outstanding shadow duplicate (deterministic
        tests and the chip smoke; never on the request path)."""
        while True:
            with self._lock:
                if not self._shadow_futures:
                    # the next gate read must see every drained score
                    self._psi_countdown = 0
                    return
                future = self._shadow_futures.popleft()
            future.result(timeout=timeout_s)

    def _run_shadow(self, dep, payload, baseline_result, plan_id) -> None:
        t0 = self.clock()
        divergence: Optional[float] = None
        ok = False
        error = None
        try:
            from ..workflow.serving import encode_result

            _query, prediction = self.server._serve_one(dep, payload, None, CANDIDATE)
            encoded = encode_result(prediction)
            divergence = prediction_divergence(baseline_result, encoded)
            # the candidate's answers feed its score sketch while it is
            # shadow only, so the drift gate can catch it before it serves;
            # recorded only while OUR plan is active (checked under the lock)
            quality = getattr(self.server, "quality", None)
            if quality is not None:
                from ..obs.quality import scores_from_result

                scores = scores_from_result(encoded)[1]
                with self._lock:
                    if self.active and self.plan.id == plan_id:
                        quality.record_scores(CANDIDATE, scores)
            ok = True
        except Exception as exc:
            error = f"{type(exc).__name__}: {exc}"
        try:
            elapsed = max(0.0, self.clock() - t0)
            with self._lock:
                self._shadow_pending -= 1
                if self.active and self.plan.id == plan_id and self.plan.stage == ROLLOUT_SHADOW:
                    self._shadow_counts["ok" if ok else "errors"] += 1
                    if error is not None:
                        self._shadow_last_error = error
                        logger.warning("rollout %s: shadow query on candidate failed: %s",
                                       plan_id, error)
                    self.controller.record(True, elapsed, ok)
                    self._hist.observe(elapsed, variant=CANDIDATE)
                    self._events.inc(1, variant=CANDIDATE,
                                     kind="shadow_ok" if ok else "shadow_error")
                    if divergence is not None:
                        self.controller.record_divergence(divergence)
                        self._div_hist.observe(divergence)
                    self._maybe_advance()
        finally:
            self._close_retired()

    # -- state machine ----------------------------------------------------
    def _maybe_advance(self) -> None:
        """Gate check after each sample (lock held)."""
        if self._persist_pending:
            self._try_persist(self.plan)
        if not self.active or self.controller is None:
            return
        verdict, reason = self.controller.evaluate(self.plan.stage)
        if verdict == PROMOTE:
            self._advance_stage(reason)
        elif verdict == ROLLBACK:
            self._retire_candidate(ROLLOUT_ROLLED_BACK, reason)

    def _advance_stage(self, reason: str) -> None:
        """SHADOW → CANARY → LIVE (lock held)."""
        if self.plan.stage == ROLLOUT_SHADOW:
            self._set_stage(ROLLOUT_CANARY, reason)
            self.controller.enter_stage()
            logger.info("rollout %s: candidate %s takes %.1f%% of traffic (%s)",
                        self.plan.id, self.plan.candidate_instance_id,
                        self.plan.percent, reason)
            return
        # CANARY → LIVE: the candidate becomes THE deployment; the retired
        # baseline's last server reference goes with the swap (in-flight
        # queries finish on the deployment they were routed to)
        candidate_dep = self.candidate_dep
        self.server._adopt_deployment(candidate_dep)
        self._drop_candidate()
        self._set_stage(ROLLOUT_LIVE, reason)
        logger.info("rollout %s: candidate %s is live, baseline %s retired (%s)",
                    self.plan.id, self.plan.candidate_instance_id,
                    self.plan.baseline_instance_id, reason)

    def _retire_candidate(self, stage: str, reason: str) -> None:
        """Rollback or abort (lock held): drop the candidate, the resident
        baseline keeps serving."""
        self._drop_candidate()
        self._set_stage(stage, reason)
        logger.warning("rollout %s: candidate %s retired -> %s (%s)",
                       self.plan.id, self.plan.candidate_instance_id, stage, reason)

    def _drop_candidate(self) -> None:
        """Forget the candidate (lock held); its batcher is closed by
        :meth:`_close_retired` once the lock is released."""
        self.candidate_dep = None
        self.controller = None
        if self.candidate_batcher is not None:
            self._retiring.append(self.candidate_batcher)
            self.candidate_batcher = None

    def _close_retired(self) -> None:
        """Close the retired candidate batchers (their queued queries run
        first) and add their batches to :attr:`candidate_batches`. Never
        under the lock: a close waits for in-flight batches."""
        if not self._retiring:  # every request passes here: no lock when idle
            return
        while True:
            with self._lock:
                if not self._retiring:
                    return
                batcher = self._retiring.pop()
            batcher.close()
            with self._lock:
                self._retired_batches += batcher.stats["batches"]

    @staticmethod
    def _history_entry(stage: str, reason: str) -> dict:
        return {"stage": stage, "atMs": to_millis(utcnow()), "reason": reason}

    def _set_stage(self, stage: str, reason: str) -> None:
        self.plan = dataclasses.replace(
            self.plan, stage=stage, updated_time=utcnow(),
            history=list(self.plan.history) + [self._history_entry(stage, reason)])
        self._transitions.inc(1, to=stage)
        flight_record("rollout", "rollout.stage", plan=self.plan.id, to=stage, reason=reason)
        self._try_persist(self.plan)

    def _try_persist(self, plan: RolloutPlan) -> None:
        """Store ``plan``; a storage failure defers the write (retried on
        every later request) instead of failing the request that happened
        to trigger the transition."""
        try:
            self._md().rollout_plan_upsert(plan)
            self._persist_pending = False
        except Exception as exc:
            self._persist_pending = True
            logger.warning("rollout %s: could not persist stage %s (%s); will retry",
                           plan.id, plan.stage, exc)

    def _persist_terminal(self, plan: RolloutPlan, stage: str, reason: str) -> None:
        """Finish a plan this manager does not adopt (resume paths)."""
        finished = dataclasses.replace(
            plan, stage=stage, updated_time=utcnow(),
            history=list(plan.history) + [self._history_entry(stage, reason)])
        self.plan = finished
        self._transitions.inc(1, to=stage)
        flight_record("rollout", "rollout.stage", plan=plan.id, to=stage, reason=reason)
        self._try_persist(finished)
        logger.warning("rollout %s: %s (%s)", plan.id, stage, reason)

    # -- status -----------------------------------------------------------
    def status(self) -> dict:
        """The ``GET /rollout.json`` body: the plan, and while it is
        active the gate windows, the verdict and the shadow pool's
        outcomes (a failing duplicate is counted here, never swallowed)."""
        with self._lock:
            plan = self.plan
            out: dict = {"active": self.active}
            if plan is None:
                return out
            out["plan"] = plan_to_json(plan)
            out["shadow"] = {**self._shadow_counts, "pending": self._shadow_pending,
                             "lastError": self._shadow_last_error}
            if self.active and self.controller is not None:
                verdict, reason = self.controller.evaluate(plan.stage)
                mean_div = self.controller.mean_divergence()
                out["windows"] = {
                    name: {"samples": w.count(),
                           "errorRate": round(w.error_rate(), 6),
                           "p99Ms": round(w.p99() * 1000, 3)}
                    for name, w in (("baseline", self.controller.baseline),
                                    ("candidate", self.controller.candidate))
                }
                if mean_div is not None:
                    out["windows"]["meanDivergence"] = round(mean_div, 6)
                out["decision"] = {"verdict": verdict, "reason": reason}
            return out
