"""Continuous-training controller: delta → candidate → rollout, no human.

Copy of ``predictionio_tpu/continuous/controller.py`` for one feed. One
controller rides inside a :class:`~..workflow.serving.QueryServer`:

1. **Watch** — :class:`~.watcher.FeedWatcher` tails the changefeed from
   its durable cursor; a cycle triggers when the pending delta reaches
   ``min_events`` or its oldest event is ``max_staleness_s`` old.
2. **Train** — :func:`~.foldin.decide_mode` picks fold-in (the changed
   rows only, ``ALSAlgorithm.fold_in``: kernels 3 and 2 on the card) or
   a full retrain (``run_train`` on the server's device). Either way the
   candidate lands as a COMPLETED engine instance.
3. **Score** — the candidate replays the most recent baseline-served
   ``pio_pr`` feedback queries (one ``batch_predict`` an algorithm:
   kernel 1) and is quarantined before it sees traffic when its answers
   diverge past ``max_offline_divergence`` (or its score PSI past the
   gates' ``max_score_psi``).
4. **Submit and monitor** — :meth:`RolloutManager.start`, then SHADOW →
   CANARY → LIVE. A busy rollout backs off on the shared
   :class:`~..utils.resilience.RetryPolicy` schedule; a rollback
   quarantines the candidate, forces the next cycle to a full retrain and
   cools down. LIVE commits the cursor and records freshness (oldest
   folded event → model live).

Decisions run on injected clocks; the background thread is ``tick()`` on
an interval. ``continuous_state.json`` (the in-flight candidate, the
quarantine list) and the durable cursor let a restarted server resume
where it stopped. Each cycle records its split in ``lastCycle.splitS``
(feed poll, read, fold or retrain, persist, offline score). A paused
controller reads no op but learns the feed's head on each tick, so
``pio_continuous_feed_lag_ops`` counts what the pause holds back (the
JAX package's stays where the last poll left it). Folding a
partitioned store's feeds (``fold_in_partitioned`` across per-partition
cursors) is ROADMAP.md queue 1 item 12's remainder.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from ..obs.flight import record as flight_record
from ..storage.metadata import ROLLOUT_ABORTED, ROLLOUT_LIVE, ROLLOUT_ROLLED_BACK
from ..utils.durability import atomic_write_bytes
from ..utils.resilience import RetryPolicy
from .foldin import FOLD_IN, FULL_RETRAIN, FoldInPolicy, decide_mode
from .watcher import FeedGap, RemoteFeed, make_watcher

logger = logging.getLogger(__name__)

__all__ = ["ContinuousConfig", "ContinuousController", "STATE_NAME"]

STATE_NAME = "continuous_state.json"

#: controller states (status()["state"])
WATCHING = "WATCHING"
SUBMIT_PENDING = "SUBMIT_PENDING"
MONITORING = "MONITORING"
COOLDOWN = "COOLDOWN"
PAUSED = "PAUSED"


def _default_event_values() -> Dict[str, object]:
    # the recommendation template's rate/buy rules (workflow/infeed.py)
    return {"rate": "rating", "buy": 4.0}


@dataclasses.dataclass(frozen=True)
class ContinuousConfig:
    """Policy knobs of one continuous-learning loop."""

    #: app whose feedback stream feeds the loop
    app_id: int = 1
    #: event name → value rule (property name or fixed float)
    event_values: Mapping[str, object] = dataclasses.field(
        default_factory=_default_event_values)
    #: storage primary tailed over ``GET /replicate/changes``; None = the
    #: caller passes a feed object (an in-process oplog)
    feed_url: Optional[str] = None
    #: cursor and state directory (default ``$PIO_FS_BASEDIR/continuous``)
    state_dir: Optional[str] = None
    #: delta size that triggers a cycle
    min_events: int = 10
    #: trigger below ``min_events`` once the oldest pending event is this stale
    max_staleness_s: float = 300.0
    #: background tick cadence
    poll_interval_s: float = 1.0
    #: fold-vs-retrain escalation thresholds
    policy: FoldInPolicy = dataclasses.field(default_factory=FoldInPolicy)
    #: forwarded to ``RolloutManager.start``
    rollout_percent: Optional[float] = None
    rollout_gates: Optional[Mapping[str, object]] = None
    #: recent ``pio_pr`` feedback events replayed for offline scoring
    score_window: int = 200
    #: scored samples before the offline gate can veto
    min_score_samples: int = 5
    #: mean candidate-vs-served divergence above which the candidate is
    #: quarantined without being submitted
    max_offline_divergence: float = 0.75
    #: cooldown after a rollback or quarantine
    quarantine_backoff_s: float = 300.0
    #: checkpoint cadence of FULL retrains (``--checkpoint-every``): the
    #: batch slug is stable ("continuous-retrain"), so a retrain killed
    #: mid-run resumes from its last valid step next time. None defers to
    #: the engine params / ``PIO_CKPT_EVERY``; 0 forces off
    retrain_checkpoint_every: Optional[int] = None
    #: start the background tick thread with the server
    autostart: bool = True


class ContinuousController:
    """One query server's continuous-learning loop."""

    def __init__(self, server, config: ContinuousConfig, feed=None,
                 clock: Optional[Callable[[], float]] = None,
                 wall: Callable[[], float] = time.time,
                 retry_policy: Optional[RetryPolicy] = None):
        self.server = server
        self.config = config
        self.clock = clock or server.clock
        self.wall = wall
        self._retry = retry_policy or RetryPolicy(attempts=1, base_delay_s=1.0,
                                                  max_delay_s=60.0)
        if feed is None:
            if not config.feed_url:
                raise ValueError(
                    "continuous learning needs a changefeed: pass feed_url "
                    "(a storage primary's URL) or an explicit feed object")
            # a partitioned or HA URL raises here (item 12)
            feed = RemoteFeed(config.feed_url)
        state_dir = config.state_dir
        if state_dir is None:
            from ..storage.registry import base_dir

            # the server's storage environment, not os.environ: a registry
            # rooted elsewhere keeps its cursor there too
            state_dir = os.path.join(base_dir(getattr(server.registry, "_env", None)),
                                     "continuous")
        self._state_dir = state_dir
        self._state_path = os.path.join(state_dir, STATE_NAME)
        self.watcher = make_watcher(feed, config.app_id, config.event_values, state_dir)
        # feedback join: each accepted delta event is a user acting on an
        # item, recorded against the user's last served list
        self.watcher.on_event = self._observe_feedback
        health = getattr(server, "health", None)
        self._watchdog = health.watchdog if health is not None else None
        self._tap_errors = server.metrics.counter(
            "pio_observer_errors_total", "Swallowed observer/monitor exceptions by site",
            labelnames=("site",))
        self.watcher.on_event_error = lambda: self._tap_errors.inc(
            1, site="continuous.feedback")
        if self._watchdog is not None:
            self.watcher.heartbeat = lambda: self._watchdog.beat("continuous.feed")
        self._lock = threading.Lock()
        self._ticking = False  # a flag, not a held lock: a tick trains
        self._paused = False
        self._force_full = False
        # a gap retrain must RESYNC the cursor at LIVE, not commit it
        self._feed_gap = False
        self._trigger = False
        # {"instanceId", "uptoSeq", "oldestMs", "mode", "submitted", "createdS"}
        self._candidate: Optional[dict] = None
        self._quarantined: List[str] = []
        self._cooldown_until = 0.0
        self._next_submit_s = 0.0
        self._submit_attempts = 0
        self._last_cycle: Optional[dict] = None
        self._last_freshness_s: Optional[float] = None
        self._last_error: Optional[str] = None
        self._last_poll_s = 0.0
        self._cycles = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._load_state()

        metrics = server.metrics
        self._folds = metrics.counter("pio_continuous_folds_total",
                                      "Continuous-training cycle outcomes",
                                      labelnames=("kind",))
        metrics.gauge_callback(
            "pio_continuous_feed_lag_ops", self.watcher.feed_lag,
            "Changefeed ops between the continuous cursor and the feed head")
        metrics.gauge_callback(
            "pio_continuous_candidate_age_seconds", self._candidate_age_s,
            "Age of the in-flight continuous candidate (0 = none)")

    # -- durable state ----------------------------------------------------
    def _load_state(self) -> None:
        try:
            with open(self._state_path) as fh:
                state = json.load(fh)
        except (OSError, ValueError):
            return
        with self._lock:
            self._candidate = state.get("candidate")
            self._quarantined = list(state.get("quarantined", []))
            self._last_freshness_s = state.get("lastFreshnessS")
            self._last_cycle = state.get("lastCycle")

    def _persist_state(self) -> None:
        """Crash-safe controller state (call with ``_lock`` held)."""
        atomic_write_bytes(self._state_path, json.dumps({
            "candidate": self._candidate,
            "quarantined": self._quarantined,
            "lastFreshnessS": self._last_freshness_s,
            "lastCycle": self._last_cycle,
        }).encode())

    def _observe_feedback(self, event) -> None:
        """Watcher tap: join one feedback event to the served-list LRU."""
        quality = getattr(self.server, "quality", None)
        if quality is not None:
            quality.record_feedback(event.user, event.item)

    def _candidate_age_s(self) -> float:
        with self._lock:
            cand = self._candidate
            if cand is None or "createdS" not in cand:
                return 0.0
            return max(0.0, self.clock() - float(cand["createdS"]))

    def _fold_event(self, kind: str) -> None:
        """One cycle outcome: the counter and a flight-recorder entry."""
        self._folds.inc(1, kind=kind)
        flight_record("continuous", "continuous.fold", outcome=kind)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Run the background tick loop (idempotent)."""
        self._stop.clear()
        with self._lock:
            self._paused = False
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(target=self._loop, name="continuous",
                                            daemon=True)
            self._thread.start()
        self._watch()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self.tick()
            except Exception:  # the loop must survive anything
                logger.exception("continuous tick failed")

    def _watch(self) -> None:
        """Register the loop's stall expectations; generous, since a tick
        that retrains fully blocks the loop for the whole run."""
        if self._watchdog is None:
            return
        gap = max(8 * self.config.poll_interval_s, 900.0)
        self._watchdog.expect("continuous.tick", max_gap_s=gap)
        self._watchdog.expect("continuous.feed", max_gap_s=gap)

    def _unwatch(self) -> None:
        if self._watchdog is not None:
            self._watchdog.unexpect("continuous.tick")
            self._watchdog.unexpect("continuous.feed")

    def stop(self) -> None:
        self._unwatch()
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)

    def pause(self) -> dict:
        # a paused loop is not a stall
        self._unwatch()
        with self._lock:
            self._paused = True
        return self.status()

    def resume_watching(self) -> dict:
        with self._lock:
            self._paused = False
        if self._thread is not None:
            self._watch()
        return self.status()

    def trigger(self, full: bool = False) -> dict:
        """Force a cycle on the next tick regardless of thresholds."""
        with self._lock:
            self._trigger = True
            self._force_full = self._force_full or full
            self._cooldown_until = 0.0
            self._next_submit_s = 0.0
        return self.status()

    # -- the tick ---------------------------------------------------------
    def tick(self) -> dict:
        """One deterministic controller step. Never raises on feed, train
        or storage trouble: failures land in ``status()["lastError"]``."""
        if self._watchdog is not None:
            self._watchdog.beat("continuous.tick")
        with self._lock:
            if self._ticking:
                return self.status()
            self._ticking = True
        try:
            self._tick_inner()
        finally:
            with self._lock:
                self._ticking = False
        return self.status()

    def _tick_inner(self) -> None:
        with self._lock:
            paused = self._paused
        if paused:
            # nothing is read or trained, but the feed's head is learnt,
            # so pio_continuous_feed_lag_ops shows what a pause holds back
            try:
                self.watcher.refresh_head()
            except Exception as exc:
                with self._lock:
                    self._last_error = f"feed checkpoint failed: {exc}"
            return
        now = self.clock()
        t = time.monotonic()
        try:
            self.watcher.poll()
            with self._lock:
                self._last_error = None
        except FeedGap as exc:
            # the delta stream is incomplete: only a full retrain (which
            # reads the whole store) covers what the feed lost
            flight_record("continuous", "continuous.gap", error=str(exc))
            with self._lock:
                self._force_full = True
                self._feed_gap = True
                self._trigger = True
                self._last_error = f"feed gap: {exc}"
            logger.warning("continuous: %s — escalating to full retrain", exc)
        except Exception as exc:
            with self._lock:
                self._last_error = f"feed poll failed: {exc}"
            return
        self._last_poll_s = time.monotonic() - t

        if self._check_rollout(now):
            return  # a candidate is still in flight: one cycle at a time
        with self._lock:
            if now < self._cooldown_until:
                return
            pending = self.watcher.pending_count()
            oldest_ms = self.watcher.oldest_pending_ms()
            stale_s = (max(0.0, self.wall() * 1000.0 - oldest_ms) / 1000.0
                       if oldest_ms else 0.0)
            due = (self._trigger or pending >= self.config.min_events
                   or (pending > 0 and stale_s >= self.config.max_staleness_s))
            if not due:
                return
            self._trigger = False
            force_full = self._force_full
        self._run_cycle(force_full)

    # -- rollout monitoring ----------------------------------------------
    def _check_rollout(self, now: float) -> bool:
        """Advance the in-flight candidate's lifecycle; True while a
        candidate still occupies the loop."""
        with self._lock:
            cand = self._candidate
        if cand is None:
            return False
        if not cand.get("submitted"):
            # submitted or backed off, the candidate claims the loop: its
            # delta stays uncommitted until its rollout ends
            self._try_submit(cand, now)
            return True
        rollout = self.server.rollout
        plan = rollout.plan if rollout is not None else None
        if plan is None or plan.candidate_instance_id != cand["instanceId"]:
            # replaced or aborted out of band: drop the claim, keep the
            # delta for the next candidate
            with self._lock:
                self._candidate = None
                self._persist_state()
            logger.warning("continuous: candidate %s lost its rollout (plan %s); "
                           "the pending delta stays queued",
                           cand["instanceId"], plan.id if plan else None)
            return False
        if plan.stage == ROLLOUT_LIVE:
            freshness_s = None
            if cand.get("oldestMs"):
                freshness_s = max(0.0, self.wall() * 1000.0 - cand["oldestMs"]) / 1000.0
            if cand.get("resync"):
                # a gap retrain covered the lost history from the store:
                # jump the cursor to the head, or the gap fires again
                try:
                    self.watcher.resync()
                    with self._lock:
                        self._feed_gap = False
                        self._force_full = False
                except Exception as exc:
                    with self._lock:
                        self._last_error = f"resync failed: {exc}"
            else:
                try:
                    self.watcher.commit(int(cand["uptoSeq"]))
                except (TypeError, ValueError) as exc:
                    # a cursor of another feed layout (a per-partition map
                    # from the JAX package's partitioned loop): resync and
                    # retrain fully rather than wedge the LIVE path
                    logger.warning("continuous: candidate cursor %r does not match the "
                                   "feed (%s); resyncing and forcing a full retrain",
                                   cand["uptoSeq"], exc)
                    with self._lock:
                        self._force_full = True
                        self._trigger = True
                    try:
                        self.watcher.resync()
                    except Exception as resync_exc:
                        with self._lock:
                            self._last_error = f"resync failed: {resync_exc}"
            with self._lock:
                self._candidate = None
                self._last_freshness_s = freshness_s
                self._submit_attempts = 0
                if self._last_cycle is not None:
                    self._last_cycle["outcome"] = "live"
                    self._last_cycle["freshnessS"] = freshness_s
                self._persist_state()
            self._fold_event("promoted")
            logger.info("continuous: candidate %s is LIVE (freshness %.3fs)",
                        cand["instanceId"], freshness_s or -1.0)
            return False
        if plan.stage in (ROLLOUT_ROLLED_BACK, ROLLOUT_ABORTED):
            with self._lock:
                if cand["instanceId"] not in self._quarantined:
                    self._quarantined.append(cand["instanceId"])
                self._candidate = None
                # the gates rejected a fold of this delta: retrain next
                self._force_full = True
                self._cooldown_until = now + self.config.quarantine_backoff_s
                if self._last_cycle is not None:
                    self._last_cycle["outcome"] = plan.stage.lower()
                self._persist_state()
            self._fold_event("quarantined")
            logger.warning("continuous: candidate %s was %s by the rollout gates; "
                           "quarantined, cooling down %.0fs, next cycle is a full retrain",
                           cand["instanceId"], plan.stage, self.config.quarantine_backoff_s)
            return False
        return True  # SHADOW or CANARY: keep monitoring

    def _try_submit(self, cand: dict, now: float) -> bool:
        """Submit a produced candidate; on a busy rollout, schedule a
        jittered retry. True on success."""
        with self._lock:
            if now < self._next_submit_s:
                return False
        from ..rollout.manager import RolloutError

        try:
            self.server.rollout.start(
                candidate_instance_id=cand["instanceId"],
                percent=self.config.rollout_percent,
                gates=dict(self.config.rollout_gates) if self.config.rollout_gates else None,
                reason="continuous controller auto-submit")
        except RolloutError as exc:
            # another rollout is in flight: back off on the shared schedule
            with self._lock:
                delay = self._retry.delay_for(min(self._submit_attempts, 6))
                self._submit_attempts += 1
                self._next_submit_s = now + max(delay, self.config.poll_interval_s)
                self._last_error = f"rollout busy: {exc}"
            return False
        except Exception as exc:
            with self._lock:
                self._last_error = f"rollout start failed: {exc}"
                self._quarantined.append(cand["instanceId"])
                self._candidate = None
                self._cooldown_until = now + self.config.quarantine_backoff_s
                self._persist_state()
            self._fold_event("quarantined")
            logger.exception("continuous: submitting candidate %s failed",
                             cand["instanceId"])
            return False
        with self._lock:
            cand["submitted"] = True
            self._candidate = cand
            self._submit_attempts = 0
            self._persist_state()
        logger.info("continuous: candidate %s submitted to the rollout plane",
                    cand["instanceId"])
        return True

    # -- one training cycle ----------------------------------------------
    def _run_cycle(self, force_full: bool) -> None:
        now = self.clock()
        batch = self.watcher.take_batch()
        if batch is None and not force_full:
            return
        dep = self.server.deployment
        split = {"poll": self._last_poll_s}
        pd = None
        if not force_full and batch is not None:
            # read before deciding: the delta fraction is then exact
            t = time.monotonic()
            pd = self._read_prepared(dep)
            split["read"] = time.monotonic() - t
        mode, reason = self._decide(dep, batch, force_full, pd)
        cycle: dict = {"mode": mode, "reason": reason,
                       "deltaEvents": len(batch.events) if batch else 0,
                       "atS": round(now, 3), "splitS": split}
        try:
            if mode == FOLD_IN:
                instance_id, fold_stats = self._fold_in_candidate(dep, batch, pd, split)
                if fold_stats is not None:
                    cycle["foldIn"] = fold_stats
                if instance_id is None:  # drift escalation inside the fold
                    mode = FULL_RETRAIN
                    cycle["mode"] = mode
                    cycle["reason"] = (
                        f"fold-in RMSE drift "
                        f"{fold_stats['rmseDrift'] if fold_stats else '?'} exceeded "
                        f"policy {self.config.policy.max_rmse_drift}: escalated")
                    self._fold_event("escalated")
            if mode == FULL_RETRAIN:
                t = time.monotonic()
                instance_id = self._full_retrain_candidate(dep)
                split["retrain"] = time.monotonic() - t
        except Exception as exc:
            with self._lock:
                self._last_error = f"{mode} failed: {exc}"
                cycle["outcome"] = "error"
                cycle["error"] = str(exc)
                self._last_cycle = cycle
                self._persist_state()
            logger.exception("continuous: %s cycle failed", mode)
            return
        self._fold_event(mode)
        with self._lock:
            self._cycles += 1
            self._force_full = False

        t = time.monotonic()
        score = self._offline_score(instance_id)
        split["score"] = time.monotonic() - t
        cycle["offlineScore"] = score
        if not score.get("ok", True):
            with self._lock:
                self._quarantined.append(instance_id)
                # the next cycle must not re-fold the same delta into an
                # identical candidate: it retrains fully instead
                self._force_full = True
                self._cooldown_until = self.clock() + self.config.quarantine_backoff_s
                cycle["outcome"] = "offline_quarantined"
                self._last_cycle = cycle
                self._persist_state()
            self._fold_event("quarantined")
            logger.warning("continuous: candidate %s failed offline scoring (%s); "
                           "quarantined before submission", instance_id, score.get("reason"))
            return

        with self._lock:
            needs_resync = self._feed_gap
        cand = {
            "instanceId": instance_id,
            "uptoSeq": batch.upto_seq if batch else self.watcher.position,
            "oldestMs": batch.oldest_event_ms if batch else None,
            "mode": mode,
            "submitted": False,
            "createdS": now,
            "resync": needs_resync,
        }
        with self._lock:
            self._candidate = cand
            cycle["candidateInstanceId"] = instance_id
            cycle["outcome"] = "submitted"
            self._last_cycle = cycle
            self._persist_state()
        self._try_submit(cand, self.clock())

    def _read_prepared(self, dep):
        """Read and prepare the current training data through the engine's
        own components; None when the engine cannot fold or the read fails
        (→ full retrain)."""
        if not dep.algorithms or not all(
                hasattr(a, "fold_in") and getattr(a, "fold_in_supported", True)
                for a in dep.algorithms):
            return None
        try:
            engine, ctx, ep = self.server.engine, self.server.ctx, dep.engine_params
            data_source = engine._data_source(ep)
            preparator = engine._preparator(ep)
            return preparator.prepare(ctx, data_source.read_training(ctx))
        except Exception as exc:
            logger.warning("continuous: reading data for fold-in failed (%s); "
                           "deciding without it", exc)
            return None

    def _decide(self, dep, batch, force_full: bool, pd) -> Tuple[str, str]:
        if force_full:
            return FULL_RETRAIN, "escalation forced (feed gap or quarantine)"
        if batch is None:
            return FULL_RETRAIN, "no delta batch (explicit trigger)"
        fold_available = pd is not None
        known = new = total = 0
        if fold_available:
            try:
                model = dep.models[0]
                known = len(model.user_map) + len(model.item_map)
                new = (sum(1 for u in batch.user_ids if model.user_map.get(u) is None)
                       + sum(1 for i in batch.item_ids if model.item_map.get(i) is None))
                # the exact corpus size when the prepared data has its
                # interactions; the entity count as a lower bound otherwise
                ratings = getattr(pd, "ratings", None)
                total = len(ratings) if ratings is not None else known
            except (AttributeError, TypeError):
                fold_available = False
        return decide_mode(self.config.policy,
                           total_events=max(total, len(batch.events)),
                           delta_events=len(batch.events), known_entities=known,
                           new_entities=new, fold_in_available=fold_available)

    def _fold_in_candidate(self, dep, batch, pd, split: dict) -> Tuple[Optional[str], Optional[dict]]:
        """A fold-in candidate through the persist path: ``(instance_id,
        stats)``, or ``(None, stats)`` when RMSE drift demands a retrain."""
        ctx = self.server.ctx
        with self.server.tracer.span("continuous.fold"):
            t = time.monotonic()
            models = []
            stats_json: Optional[dict] = None
            for algo, model in zip(dep.algorithms, dep.models):
                folded, stats = algo.fold_in(ctx, model, pd, batch.user_ids, batch.item_ids,
                                             policy=self.config.policy)
                if stats.rmse_drift > self.config.policy.max_rmse_drift:
                    split["fold"] = time.monotonic() - t
                    return None, stats.to_json()
                stats_json = stats.to_json()
                models.append(folded)
            split["fold"] = time.monotonic() - t
            t = time.monotonic()
            instance_id = self._persist_candidate(dep, models, FOLD_IN)
            split["persist"] = time.monotonic() - t
        return instance_id, stats_json

    def _full_retrain_candidate(self, dep) -> str:
        """The train/persist path, parameter-identical to the deployed
        baseline, on the server's device with a context of its own
        (``run_train`` stops its context when done)."""
        from ..controller.engine import WorkflowParams
        from ..workflow.context import WorkflowContext
        from ..workflow.core_workflow import run_train

        inst = dep.instance
        with self.server.tracer.span("continuous.retrain"):
            return run_train(
                self.server.engine, dep.engine_params, self.server.registry,
                engine_id=inst.engine_id, engine_version=inst.engine_version,
                engine_variant=inst.engine_variant, engine_factory=inst.engine_factory,
                # the stable batch slug keeps the derived checkpoint
                # directory stable, so a killed retrain's steps are found
                workflow_params=WorkflowParams(
                    batch="continuous-retrain",
                    checkpoint_every=self.config.retrain_checkpoint_every),
                ctx=WorkflowContext(device=self.server.ctx.device))

    def _persist_candidate(self, dep, models, mode: str) -> str:
        """The instance record and model blob path a full ``run_train``
        walks, so a fold-in candidate is like any other downstream."""
        import pickle

        from ..storage import STATUS_COMPLETED, Model, new_engine_instance, utcnow
        from ..workflow.context import pio_env_vars

        inst = dep.instance
        md = self.server.registry.get_metadata()
        env = pio_env_vars()
        env["PIO_CONTINUOUS"] = mode
        record = new_engine_instance(
            engine_id=inst.engine_id, engine_version=inst.engine_version,
            engine_variant=inst.engine_variant, engine_factory=inst.engine_factory,
            batch=f"continuous-{mode}", env=env,
            **{k: getattr(inst, k) for k in ("data_source_params", "preparator_params",
                                             "algorithms_params", "serving_params")})
        instance_id = md.engine_instance_insert(record)
        persisted = self.server.engine.make_serializable_models(
            self.server.ctx, dep.engine_params, instance_id, models)
        self.server.registry.get_models().insert(
            Model(id=instance_id, models=pickle.dumps(persisted)))
        stored = md.engine_instance_get(instance_id)
        md.engine_instance_update(dataclasses.replace(stored, status=STATUS_COMPLETED,
                                                      end_time=utcnow()))
        return instance_id

    # -- offline scoring ---------------------------------------------------
    def _offline_score(self, instance_id: str) -> dict:
        """Replay recent baseline-served ``pio_pr`` feedback queries
        through the candidate (one ``batch_predict`` an algorithm) and
        compare with what the baseline served. No feedback: the gate
        abstains (the rollout's shadow stage still guards)."""
        from ..obs.quality import scores_from_result
        from ..obs.sketch import QuantileSketch
        from ..rollout.plan import BASELINE, prediction_divergence
        from ..storage.events import EventFilter
        from ..workflow.serving import decode_query, encode_result, prepare_deployment

        out: dict = {"samples": 0, "ok": True, "batches": 0}
        quality = getattr(self.server, "quality", None)
        try:
            max_psi = float((self.config.rollout_gates or {}).get("max_score_psi", 0.0) or 0.0)
        except (TypeError, ValueError):
            max_psi = 0.0
        score_sketch = (QuantileSketch(rel_err=quality.config.rel_err)
                        if quality is not None else None)
        with self.server.tracer.span("continuous.score"):
            try:
                events = list(self.server.registry.get_events().find(
                    self.config.app_id,
                    EventFilter(entity_type="pio_pr", event_names=["predict"],
                                limit=self.config.score_window, reversed=True)))
            except Exception as exc:
                out["reason"] = f"feedback read failed: {exc}"
                return out  # abstain: scoring must not block the loop
            if not events:
                out["reason"] = "no feedback events to score against"
                return out
            try:
                cfg = dataclasses.replace(self.server.config, engine_instance_id=instance_id)
                cand = prepare_deployment(self.server.engine, self.server.registry, cfg,
                                          self.server.ctx)
            except Exception as exc:
                out["ok"] = False
                out["reason"] = f"candidate unloadable: {exc}"
                return out
            divergences: List[float] = []
            replay: List[tuple] = []  # (query, what the baseline served)
            for event in events:
                props = event.properties.to_dict()
                if props.get("variant", BASELINE) != BASELINE:
                    continue  # score against what the BASELINE served
                payload, served = props.get("query"), props.get("prediction")
                if payload is None or served is None:
                    continue
                try:
                    replay.append((decode_query(cand.algorithms, payload), served))
                except Exception:
                    divergences.append(1.0)  # undecodable: maximal divergence
            if replay:
                indexed = list(enumerate(q for q, _ in replay))
                try:
                    per_algo = []
                    for algo, model in zip(cand.algorithms, cand.models):
                        per_algo.append(dict(algo.batch_predict(model, indexed)))
                        out["batches"] += 1
                    for j, (query, served) in enumerate(replay):
                        try:
                            replayed = encode_result(
                                cand.serving.serve(query, [p[j] for p in per_algo]))
                            divergences.append(prediction_divergence(served, replayed))
                            if score_sketch is not None:
                                score_sketch.extend(scores_from_result(replayed)[1])
                        except Exception:
                            divergences.append(1.0)  # unservable, not a crash
                except Exception:
                    divergences.extend([1.0] * len(replay))
            out["samples"] = len(divergences)
            if divergences:
                mean_div = sum(divergences) / len(divergences)
                out["meanDivergence"] = round(mean_div, 6)
                if (len(divergences) >= self.config.min_score_samples
                        and mean_div > self.config.max_offline_divergence):
                    out["ok"] = False
                    out["reason"] = (
                        f"mean offline divergence {mean_div:.4f} exceeds "
                        f"{self.config.max_offline_divergence:.4f} over "
                        f"{len(divergences)} replayed queries")
            if out["ok"] and score_sketch is not None and score_sketch.count:
                psi_value = quality.psi_for_sketch(score_sketch)
                if psi_value is not None:
                    out["scorePsi"] = round(psi_value, 6)
                    if max_psi > 0 and psi_value > max_psi:
                        out["ok"] = False
                        out["reason"] = (f"offline score PSI {psi_value:.4f} exceeds "
                                         f"{max_psi:.4f} vs the baseline score distribution")
            return out

    # -- status -----------------------------------------------------------
    def state(self) -> str:
        with self._lock:
            if self._paused:
                return PAUSED
            if self._candidate is not None:
                return MONITORING if self._candidate.get("submitted") else SUBMIT_PENDING
            if self.clock() < self._cooldown_until:
                return COOLDOWN
            return WATCHING

    def status(self) -> dict:
        """The ``GET /continuous.json`` / ``pio continuous status`` body."""
        state = self.state()
        # the watcher's and the monitor's reads take their own locks:
        # outside the controller's (one lock at a time)
        feed_lag = self.watcher.feed_lag()
        pending = self.watcher.pending_count()
        quality = getattr(self.server, "quality", None)
        online_quality = quality.online_quality() if quality is not None else None
        with self._lock:
            out: dict = {
                "enabled": True,
                "state": state,
                "appId": self.config.app_id,
                "cursorSeq": self.watcher.cursor_seq,
                "position": self.watcher.position,
                "feedLagOps": feed_lag,
                "pendingEvents": pending,
                "cycles": self._cycles,
                "quarantined": list(self._quarantined),
            }
            if online_quality is not None:
                out["onlineQuality"] = online_quality
            if self._candidate is not None:
                out["candidate"] = dict(self._candidate)
            if self._last_cycle is not None:
                out["lastCycle"] = dict(self._last_cycle)
            if self._last_freshness_s is not None:
                out["lastFreshnessS"] = round(self._last_freshness_s, 3)
            if self._last_error:
                out["lastError"] = self._last_error
            if self.clock() < self._cooldown_until:
                out["cooldownRemainingS"] = round(self._cooldown_until - self.clock(), 3)
        return out
