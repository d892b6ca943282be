"""The port's continuous loop (``predictionio_tpu_torch/continuous/
{watcher,controller}.py``, the ``/continuous*`` routes and ``pio
continuous``) against the JAX package's, on the CPU.

Mirrors ``TestFeedWatcher`` and ``TestContinuousController``
(``tests/test_continuous.py``) on the recommendation template's ALS —
the port runs no sample engine — with the ported
``testing/clock.FakeClock`` and no sleeps on a decision path, and the ALS
cases of ``TestClosedLoopE2E``. Parity: one seeded event stream and one
baseline (``als_model_from_numpy`` / the JAX ``ALSModel`` of the same
tables) go through both packages' changefeeds, watchers and controllers.
The watchers' cursors and filtering agree exactly; the controllers take
the same decisions (``mode``, ``reason``, ``deltaEvents``, ``uptoSeq``);
folded factors agree within the JAX package's spread between its solve
paths (rtol 2e-3 / atol 2e-4, as ``tests/test_torch_foldin.py``), with new
entities seeded by the JAX package's ``seeded_rows`` in both.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import pickle

import numpy as np
import pytest

from predictionio_tpu.continuous import foldin as jfold
from predictionio_tpu.continuous import watcher as jwatcher
from predictionio_tpu.continuous.controller import (
    ContinuousConfig as JaxContinuousConfig,
    ContinuousController as JaxContinuousController,
)
from predictionio_tpu.storage import changefeed as jcf
from predictionio_tpu.storage import oplog as joplog
from predictionio_tpu.testing.clock import FakeClock as JaxFakeClock
from predictionio_tpu_torch.continuous import (
    FOLD_IN,
    FULL_RETRAIN,
    ContinuousConfig,
    ContinuousController,
    FeedGap,
    FeedWatcher,
    FoldInPolicy,
    LocalFeed,
    make_watcher,
)
from predictionio_tpu_torch.continuous import foldin
from predictionio_tpu_torch.storage import Event, StorageRegistry
from predictionio_tpu_torch.storage import registry as port_registry_module
from predictionio_tpu_torch.storage.changefeed import Changefeed
from predictionio_tpu_torch.storage.metadata import (
    ROLLOUT_CANARY,
    ROLLOUT_LIVE,
    ROLLOUT_ROLLED_BACK,
    ROLLOUT_SHADOW,
)
from predictionio_tpu_torch.storage.oplog import OpLog
from predictionio_tpu_torch.testing import faults
from predictionio_tpu_torch.testing.clock import FakeClock

from torch_plane import closed_port, request, seeded_tables

SEED = 29
RANK, N_USERS, N_ITEMS = 4, 24, 16
RTOL, ATOL = 2e-3, 2e-4
T0 = dt.datetime(2026, 5, 1, tzinfo=dt.timezone.utc)
ALS = dict(rank=RANK, num_iterations=3, lambda_=0.05, seed=0)


@pytest.fixture(autouse=True)
def _no_faults():
    faults.deactivate()
    yield
    faults.deactivate()


def _rate(cls, user, item, rating, name="rate", k=0):
    return cls(event=name, entity_type="user", entity_id=user, target_entity_type="item",
               target_entity_id=item,
               properties={"rating": rating} if name == "rate" else {},
               event_time=T0 + dt.timedelta(seconds=k))


def seed_ratings(rng):
    """(user, item, rating) triples over every user and item, seeded."""
    out = [(f"u{u}", f"i{(u + j) % N_ITEMS}", float(rng.integers(1, 11)) / 2)
           for u in range(N_USERS) for j in range(6)]
    return out


def delta_ratings(rng, start: int, n: int, new_users: int = 0, new_items: int = 0):
    """A delta over known users and items, plus new ones."""
    out = [(f"u{int(rng.integers(N_USERS))}", f"i{int(rng.integers(N_ITEMS))}",
            float(rng.integers(1, 11)) / 2) for _ in range(n)]
    out += [(f"nu{start + k}", f"i{k % N_ITEMS}", 4.5) for k in range(new_users)]
    out += [(f"u{k % N_USERS}", f"ni{start + k}", 3.0) for k in range(new_items)]
    return out


def _gates(**overrides):
    g = {"min_samples": 5, "window_s": 100_000.0, "shadow_hold_s": 10.0,
         "canary_hold_s": 10.0, "max_divergence": 1.0, "max_p99_latency_ratio": 1_000.0}
    g.update(overrides)
    return g


def _use_jax_rows(monkeypatch):
    """New entities' rows from the JAX package's ``seeded_rows`` in the
    port too (``jax.random`` rows cannot be drawn here)."""
    monkeypatch.setattr(foldin, "seeded_rows", lambda n, rank, seed, offset=0: np.asarray(
        jfold.seeded_rows(n, rank, seed, offset), dtype=np.float32))


class PortLoop:
    """The port's loop over its ALS template: a store with the seeded
    ratings, the baseline persisted from ``als_model_from_numpy``, a
    query server on the CPU with a FakeClock, and a controller tailing an
    in-process changefeed."""

    def __init__(self, tmp_path, monkeypatch, feed=None, **cfg_kw):
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.models import recommendation as rec
        from predictionio_tpu_torch.workflow import QueryServer, ServerConfig, persist_instance

        self.registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "port")})
        monkeypatch.setattr(port_registry_module, "_default_registry", self.registry)
        store = self.registry.get_events()
        store.init(1)
        store.write([_rate(Event, u, i, r, k=k)
                     for k, (u, i, r) in enumerate(seed_ratings(np.random.default_rng(SEED)))], 1)
        uf, itf = seeded_tables(SEED, N_USERS, N_ITEMS, RANK)
        model = rec.als_model_from_numpy(RANK, uf, itf, [f"u{i}" for i in range(N_USERS)],
                                         [f"i{i}" for i in range(N_ITEMS)])
        self.engine = rec.engine_factory()
        self.ep = EngineParams(data_source_params=("", rec.RecDataSourceParams(app_id=1)),
                               algorithm_params_list=[("als", rec.ALSAlgorithmParams(**ALS))])
        self.baseline_id = persist_instance(self.registry, self.ep, [model])
        self.changefeed = Changefeed(OpLog(str(tmp_path / "oplog")), store,
                                     self.registry.get_metadata(), self.registry.get_models())
        self.clock = FakeClock()
        self.server = QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu",
                                               engine_instance_id=self.baseline_id),
                                  self.engine, self.registry, clock=self.clock)
        defaults = dict(app_id=1, min_events=3, max_staleness_s=1e9, rollout_gates=_gates(),
                        quarantine_backoff_s=60.0, score_window=50,
                        state_dir=str(tmp_path / "cstate"))
        defaults.update(cfg_kw)
        self.config = ContinuousConfig(**defaults)
        self.ctl = ContinuousController(self.server, self.config,
                                        feed=feed or LocalFeed(self.changefeed.oplog),
                                        clock=self.clock)
        self.server.continuous = self.ctl

    def post(self, triples, start: int = 0):
        for k, (u, i, r) in enumerate(triples):
            self.changefeed.insert_event(_rate(Event, u, i, r, k=start + k), 1)

    def drive(self, n, start=0):
        for k in range(start, start + n):
            self.server.handle_query({"user": f"u{k % N_USERS}", "num": 3}, info={})
        self.server.rollout.drain_shadow()

    def promote_to_live(self):
        for rnd in range(6):
            if not self.server.rollout.active:
                break
            self.drive(8, start=1000 + rnd * 100)
            self.clock.advance(11.0)
            self.drive(2, start=2000 + rnd * 100)
        self.ctl.tick()

    def close(self):
        self.server.server_close()


class JaxLoop:
    """The JAX package's loop on the same ratings and baseline tables."""

    def __init__(self, tmp_path, monkeypatch, **cfg_kw):
        import predictionio_tpu.storage.registry as jregmod
        from predictionio_tpu.controller.engine import EngineParams, serialize_engine_params
        from predictionio_tpu.models import recommendation as jrec
        from predictionio_tpu.storage import BiMap, Model, StorageRegistry as JaxRegistry
        from predictionio_tpu.storage.event import Event as JaxEvent
        from predictionio_tpu.storage.metadata import STATUS_COMPLETED, new_engine_instance
        from predictionio_tpu.workflow.serving import QueryServer, ServerConfig

        self.registry = JaxRegistry(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
        monkeypatch.setattr(jregmod, "_default_registry", self.registry)
        store = self.registry.get_events()
        store.init(1)
        store.write([_rate(JaxEvent, u, i, r, k=k)
                     for k, (u, i, r) in enumerate(seed_ratings(np.random.default_rng(SEED)))], 1)
        uf, itf = seeded_tables(SEED, N_USERS, N_ITEMS, RANK)
        model = jrec.ALSModel(rank=RANK, user_factors=uf, item_factors=itf,
                              user_map=BiMap({f"u{i}": i for i in range(N_USERS)}),
                              item_map=BiMap({f"i{i}": i for i in range(N_ITEMS)}))
        self.engine = jrec.engine_factory()
        ep = EngineParams(data_source_params=("", jrec.RecDataSourceParams(app_id=1)),
                          algorithm_params_list=[("als", jrec.ALSAlgorithmParams(**ALS))])
        md = self.registry.get_metadata()
        iid = md.engine_instance_insert(new_engine_instance(
            engine_id="default", engine_version="1", engine_variant="engine.json",
            engine_factory="", **serialize_engine_params(ep)))
        self.registry.get_models().insert(Model(id=iid, models=pickle.dumps([model])))
        md.engine_instance_update(dataclasses.replace(md.engine_instance_get(iid),
                                                      status=STATUS_COMPLETED))
        self.baseline_id = iid
        self.event_cls = JaxEvent
        self.changefeed = jcf.Changefeed(joplog.OpLog(str(tmp_path / "joplog")), store, md,
                                         self.registry.get_models())
        self.clock = JaxFakeClock()
        self.server = QueryServer(ServerConfig(ip="127.0.0.1", port=0, batching=False,
                                               engine_instance_id=iid),
                                  self.engine, self.registry, clock=self.clock)
        defaults = dict(app_id=1, min_events=3, max_staleness_s=1e9, rollout_gates=_gates(),
                        quarantine_backoff_s=60.0, score_window=50,
                        state_dir=str(tmp_path / "jcstate"))
        defaults.update(cfg_kw)
        self.ctl = JaxContinuousController(
            self.server, JaxContinuousConfig(**defaults),
            feed=jwatcher.LocalFeed(self.changefeed.oplog), clock=self.clock)

    def post(self, triples, start: int = 0):
        for k, (u, i, r) in enumerate(triples):
            self.changefeed.insert_event(_rate(self.event_cls, u, i, r, k=start + k), 1)

    def close(self):
        self.server.server_close()


def decisions(status):
    cycle = status["lastCycle"]
    return {"mode": cycle["mode"], "reason": cycle["reason"],
            "deltaEvents": cycle["deltaEvents"], "outcome": cycle["outcome"],
            "uptoSeq": status["candidate"]["uptoSeq"], "state": status["state"]}


def candidate_factors(loop, status, port: bool):
    """The candidate instance's (user_map, item_map, uf, itf)."""
    iid = status["candidate"]["instanceId"]
    if port:
        from predictionio_tpu_torch.workflow import load_models

        (model,) = load_models(loop.registry, iid)
    else:
        from predictionio_tpu.workflow.core_workflow import load_models as jload

        (model,) = jload(loop.registry, iid)
    return (model.user_map.to_dict(), model.item_map.to_dict(),
            np.asarray(model.user_factors), np.asarray(model.item_factors))


# -- the watcher (TestFeedWatcher), each case held to the JAX watcher ---------
def _feeds(tmp_path):
    """One event script into both packages' changefeeds over their stores."""
    from predictionio_tpu.storage import (
        MetadataStore as JMd, SqliteEventStore as JEv)
    from predictionio_tpu.storage.event import Event as JaxEvent
    from predictionio_tpu.storage.model_store import SqliteModelStore as JMs
    from predictionio_tpu_torch.storage import MetadataStore, SqliteEventStore, SqliteModelStore

    port = Changefeed(OpLog(str(tmp_path / "p")), SqliteEventStore(":memory:"),
                      MetadataStore(":memory:"), SqliteModelStore(":memory:"))
    jax = jcf.Changefeed(joplog.OpLog(str(tmp_path / "j")), JEv(":memory:"),
                         JMd(":memory:"), JMs(":memory:"))
    return (port, Event, FeedWatcher, LocalFeed), (jax, JaxEvent, jwatcher.FeedWatcher,
                                                    jwatcher.LocalFeed)


def _both(tmp_path, script):
    """Run ``script(cf, event_cls, watcher_cls, feed_cls, state_dir)`` for
    each package; returns the two results."""
    out = []
    for name, (cf, ev, wcls, fcls) in zip(("p", "j"), _feeds(tmp_path)):
        out.append(script(cf, ev, wcls, fcls, str(tmp_path / f"st-{name}")))
    return out


class TestFeedWatcher:
    def test_filters_app_and_event_names(self, tmp_path):
        def script(cf, ev, wcls, fcls, state):
            w = wcls(fcls(cf.oplog), 1, {"rate": "rating", "buy": 4.0}, state)
            cf.insert_event(_rate(ev, "u1", "i1", 5.0), 1)
            cf.insert_event(_rate(ev, "u2", "i2", 3.0), 2)  # another app
            cf.insert_event(_rate(ev, "u3", "i3", 0, name="view"), 1)  # not watched
            cf.insert_event(_rate(ev, "u4", "i4", 0, name="buy"), 1)  # a fixed value
            cf.write_events([_rate(ev, "u5", "i5", 2.0)], 1, fresh=True)
            added = w.poll()
            batch = w.take_batch()
            return (added, [(e.user, e.item, e.value, e.seq) for e in batch.events],
                    w.feed_lag(), batch.upto_seq, cf.last_seq)

        port, jax = _both(tmp_path, script)
        assert port == jax
        assert port[0] == 3 and port[1][:3] == [("u1", "i1", 5.0, 1), ("u4", "i4", 4.0, 4),
                                                  ("u5", "i5", 2.0, 5)][:3]
        assert port[2] == 0 and port[3] == port[4]

    def test_commit_is_durable_and_restart_resumes_exact(self, tmp_path):
        def script(cf, ev, wcls, fcls, state):
            feed = fcls(cf.oplog)
            w = wcls(feed, 1, {"rate": "rating"}, state)
            cf.insert_event(_rate(ev, "u1", "i1", 5.0), 1)
            cf.insert_event(_rate(ev, "u2", "i1", 4.0), 1)
            w.poll()
            batch = w.take_batch()
            w2 = wcls(feed, 1, {"rate": "rating"}, state)  # a crash before commit
            trail = [len(batch.events), w2.cursor_seq, w2.poll()]
            w2.commit(batch.upto_seq)
            trail.append(w2.pending_count())
            w3 = wcls(feed, 1, {"rate": "rating"}, state)
            trail += [w3.cursor_seq, w3.poll()]
            cf.insert_event(_rate(ev, "u3", "i2", 1.0), 1)
            trail.append(w3.poll())  # only the new event, never a replay
            with open(f"{state}/continuous_cursor.json") as fh:
                trail.append(json.load(fh)["seq"])
            return trail

        port, jax = _both(tmp_path, script)
        assert port == jax == [2, 0, 2, 0, 2, 0, 1, 2]

    def test_poison_event_skipped_not_fatal(self, tmp_path):
        def script(cf, ev, wcls, fcls, state):
            w = wcls(fcls(cf.oplog), 1, {"rate": "rating"}, state)
            cf.insert_event(_rate(ev, "u1", "i1", 5.0), 1)
            cf.insert_event(ev(event="rate", entity_type="user", entity_id="u2",
                               target_entity_type="item", target_entity_id="i2",
                               properties={}), 1)  # no rating
            return w.poll(), w.skipped_events

        port, jax = _both(tmp_path, script)
        assert port == jax == (1, 1)

    def test_sequence_gap_raises_feedgap_and_resync_recovers(self, tmp_path):
        w = FeedWatcher(LocalFeed(OpLog(str(tmp_path / "oplog"), base_seq=5)), 1,
                        {"rate": "rating"}, str(tmp_path / "st"))
        with pytest.raises(FeedGap):
            w.poll()
        w.resync()
        assert w.cursor_seq == 5
        assert w.poll() == 0

    def test_generation_change_raises_feedgap(self, tmp_path):
        port_cf = _feeds(tmp_path)[0][0]
        w = FeedWatcher(LocalFeed(port_cf.oplog), 1, {"rate": "rating"},
                        str(tmp_path / "st"))
        port_cf.insert_event(_rate(Event, "u1", "i1", 5.0), 1)
        assert w.poll() == 1
        w._feed = LocalFeed(OpLog(str(tmp_path / "oplog2")))  # the store replaced
        with pytest.raises(FeedGap, match="generation"):
            w.poll()

    @pytest.mark.parametrize("feeds", [2, 3])
    def test_several_feeds_name_item_12(self, feeds, tmp_path):
        log = OpLog(str(tmp_path / "oplog"))
        with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
            make_watcher([LocalFeed(log)] * feeds, 1, {"rate": "rating"}, str(tmp_path))
        assert isinstance(make_watcher([LocalFeed(log)], 1, {}, str(tmp_path)), FeedWatcher)


def test_the_watchers_read_a_jax_written_log_alike(tmp_path):
    """The port's watcher over an oplog the JAX package wrote (and the
    reverse feed) accumulates the same delta, event for event."""
    rng = np.random.default_rng(SEED)
    (pcf, _, _, _), (jcf_, jev, _, _) = _feeds(tmp_path)
    for k, (u, i, r) in enumerate(delta_ratings(rng, 0, 40, new_users=3)):
        jcf_.insert_event(_rate(jev, u, i, r, k=k), 1)
    port_w = FeedWatcher(LocalFeed(OpLog(str(tmp_path / "j"))), 1, {"rate": "rating"},
                         str(tmp_path / "a"), batch_limit=7)
    jax_w = jwatcher.FeedWatcher(jwatcher.LocalFeed(jcf_.oplog), 1, {"rate": "rating"},
                                 str(tmp_path / "b"), batch_limit=7)
    assert port_w.poll() == jax_w.poll() == 43
    got, want = port_w.take_batch(), jax_w.take_batch()
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert (got.upto_seq, got.oldest_event_ms, got.user_ids) == \
        (want.upto_seq, want.oldest_event_ms, want.user_ids)


# -- the controller (TestContinuousController) on the ALS template ------------
class TestContinuousController:
    def test_no_delta_no_candidate(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch)
        try:
            status = loop.ctl.tick()
            assert status["state"] == "WATCHING" and status["cycles"] == 0
            assert "candidate" not in status and not loop.server.rollout.active
        finally:
            loop.close()

    def test_delta_below_min_events_waits(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch, min_events=5)
        try:
            loop.post(delta_ratings(np.random.default_rng(1), 0, 3))
            status = loop.ctl.tick()
            assert status["cycles"] == 0 and status["pendingEvents"] == 3
            assert status["feedLagOps"] == 0 and status["position"] == 3
        finally:
            loop.close()

    def test_fold_cycle_submits_and_commits_on_live(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch)
        try:
            loop.post(delta_ratings(np.random.default_rng(2), 0, 4))
            status = loop.ctl.tick()
            assert status["lastCycle"]["mode"] == FOLD_IN
            assert status["lastCycle"]["outcome"] == "submitted"
            assert set(status["lastCycle"]["splitS"]) >= {"poll", "read", "fold", "persist",
                                                          "score"}
            assert status["state"] == "MONITORING" and status["cursorSeq"] == 0
            cand_id = status["candidate"]["instanceId"]
            plan = loop.server.rollout.plan
            assert plan.stage == ROLLOUT_SHADOW and plan.candidate_instance_id == cand_id
            assert plan.history[0]["reason"] == "continuous controller auto-submit"
            loop.promote_to_live()
            status = loop.ctl.status()
            assert loop.server.rollout.plan.stage == ROLLOUT_LIVE
            assert loop.server.deployment.instance.id == cand_id
            assert status["state"] == "WATCHING"
            assert status["cursorSeq"] == loop.changefeed.last_seq == 4
            assert status["lastCycle"]["outcome"] == "live"
            assert status["lastFreshnessS"] is not None
            assert loop.ctl._folds.value(kind=FOLD_IN) == 1
            assert loop.ctl._folds.value(kind="promoted") == 1
            with open(tmp_path / "cstate" / "continuous_cursor.json") as fh:
                assert json.load(fh)["seq"] == 4
        finally:
            loop.close()

    def test_busy_rollout_backs_off_then_submits(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.workflow import persist_instance

        loop = PortLoop(tmp_path, monkeypatch)
        try:
            from predictionio_tpu_torch.workflow import load_models

            op_cand = persist_instance(loop.registry, loop.ep,
                                       load_models(loop.registry, loop.baseline_id),
                                       batch="operator")
            loop.server.rollout.start(candidate_instance_id=op_cand, gates=_gates())
            loop.post(delta_ratings(np.random.default_rng(3), 0, 4))
            status = loop.ctl.tick()
            assert status["state"] == "SUBMIT_PENDING"
            assert "rollout busy" in status["lastError"]
            loop.ctl.tick()
            assert loop.server.rollout.plan.candidate_instance_id == op_cand
            loop.server.rollout.abort("operator done")
            loop.clock.advance(120.0)
            status = loop.ctl.tick()
            assert status["state"] == "MONITORING"
            assert loop.server.rollout.plan.candidate_instance_id == \
                status["candidate"]["instanceId"]
        finally:
            loop.close()

    def test_gate_rollback_quarantines_and_forces_full_retrain(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch, rollout_gates=_gates(canary_hold_s=100_000.0))
        rng = np.random.default_rng(4)
        try:
            loop.post(delta_ratings(rng, 0, 4))
            cand_id = loop.ctl.tick()["candidate"]["instanceId"]
            loop.drive(6)
            loop.clock.advance(11.0)
            loop.drive(1, start=50)
            assert loop.server.rollout.stage == ROLLOUT_CANARY
            with faults.inject(faults.FaultSpec(site="serving.candidate", kind="refuse")):
                loop.drive(100, start=100)
            assert loop.server.rollout.stage == ROLLOUT_ROLLED_BACK
            status = loop.ctl.tick()
            assert cand_id in status["quarantined"] and status["state"] == "COOLDOWN"
            assert status["lastCycle"]["outcome"] == "rolled_back"
            loop.post(delta_ratings(rng, 100, 5), start=100)
            assert loop.ctl.tick()["cycles"] == 1  # the cooldown holds the loop
            loop.clock.advance(61.0)
            status = loop.ctl.tick()
            assert status["cycles"] == 2 and status["lastCycle"]["mode"] == FULL_RETRAIN
            assert "forced" in status["lastCycle"]["reason"]
            assert "retrain" in status["lastCycle"]["splitS"]
        finally:
            loop.close()

    def test_offline_divergence_quarantines_before_submission(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch, max_offline_divergence=0.5,
                        min_score_samples=3)
        try:
            store = loop.registry.get_events()
            for k in range(6):
                store.insert(Event(event="predict", entity_type="pio_pr", entity_id=f"pr{k}",
                                   properties={"engineInstanceId": loop.baseline_id,
                                               "query": {"user": f"u{k}", "num": 3},
                                               "prediction": {"totally": "different"},
                                               "variant": "baseline"}), 1)
            loop.post(delta_ratings(np.random.default_rng(5), 0, 4))
            status = loop.ctl.tick()
            assert status["lastCycle"]["outcome"] == "offline_quarantined"
            assert not loop.server.rollout.active and status["quarantined"]
            score = status["lastCycle"]["offlineScore"]
            assert score["samples"] == 6 and score["meanDivergence"] > 0.5
            assert score["batches"] == 1  # one batch_predict for the replay
            loop.clock.advance(61.0)
            status = loop.ctl.tick()
            assert status["cycles"] == 2 and status["lastCycle"]["mode"] == FULL_RETRAIN
            assert "forced" in status["lastCycle"]["reason"]
        finally:
            loop.close()

    def test_offline_score_of_served_answers_is_zero_divergence(self, tmp_path, monkeypatch):
        """Feedback the baseline really served, replayed through a
        candidate equal to it, diverges by 0 (one batch_predict)."""
        loop = PortLoop(tmp_path, monkeypatch)
        try:
            store = loop.registry.get_events()
            for k in range(5):
                query = {"user": f"u{k}", "num": 3}
                served = loop.server.handle_query(query, info={})
                store.insert(Event(event="predict", entity_type="pio_pr", entity_id=f"pr{k}",
                                   properties={"query": query, "prediction": served,
                                               "variant": "baseline"}), 1)
            score = loop.ctl._offline_score(loop.baseline_id)
            assert score == {"samples": 5, "ok": True, "batches": 1, "meanDivergence": 0.0}
        finally:
            loop.close()

    def test_pause_and_trigger(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch, min_events=1000)
        try:
            loop.ctl.pause()
            loop.post(delta_ratings(np.random.default_rng(6), 0, 5))
            status = loop.ctl.tick()
            assert status["state"] == "PAUSED" and status["cycles"] == 0
            # nothing read, the held-back ops counted
            assert status["pendingEvents"] == 0 and status["feedLagOps"] == 5
            loop.ctl.resume_watching()
            assert loop.ctl.tick()["cycles"] == 0
            loop.ctl.trigger()
            assert loop.ctl.tick()["cycles"] == 1
        finally:
            loop.close()

    def test_http_surface_and_status_embed(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch, min_events=1000)
        try:
            loop.server.start_background()
            port = loop.server.bound_port
            status, body, _ = request(port, "GET", "/continuous.json")
            assert status == 200 and body["enabled"] is True and body["state"] == "WATCHING"
            assert request(port, "POST", "/continuous/pause", {})[1]["state"] == "PAUSED"
            assert request(port, "POST", "/continuous/start", {})[1]["state"] == "WATCHING"
            status, body, _ = request(port, "POST", "/continuous/trigger", {"full": True})
            assert status == 200
            assert request(port, "GET", "/status.json")[1]["continuous"]["enabled"] is True
            assert request(port, "POST", "/continuous/trigger", [1])[0] == 400
            metrics = request(port, "GET", "/metrics")[1]
            assert "pio_continuous_feed_lag_ops 0" in metrics
            assert "pio_continuous_candidate_age_seconds 0" in metrics
        finally:
            loop.ctl.stop()
            loop.close()

    @pytest.mark.parametrize("sub,state", [("status", "WATCHING"), ("pause", "PAUSED")])
    def test_cli_status_and_pause(self, sub, state, tmp_path, monkeypatch, capsys):
        from predictionio_tpu_torch.tools import console

        loop = PortLoop(tmp_path, monkeypatch, min_events=1000)
        try:
            loop.server.start_background()
            port = str(loop.server.bound_port)
            assert console.main(["continuous", sub, "--ip", "127.0.0.1", "--port", port],
                                loop.registry) == 0
            assert json.loads(capsys.readouterr().out)["state"] == state
            assert console.main(["continuous", "trigger", "--full", "--ip", "127.0.0.1",
                                 "--port", port], loop.registry) == 0
            assert json.loads(capsys.readouterr().out)["cycles"] == 0
        finally:
            loop.close()
        assert console.main(["continuous", "status", "--ip", "127.0.0.1", "--port",
                             str(closed_port())]) == 1
        assert "no query server" in json.loads(capsys.readouterr().out)["error"]

    def test_feed_gap_forces_retrain_then_resyncs_at_live(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch)
        try:
            loop.post(delta_ratings(np.random.default_rng(7), 0, 2))
            loop.ctl.tick()
            fresh = OpLog(str(tmp_path / "oplog2"))
            loop.ctl.watcher._feed = LocalFeed(fresh)
            status = loop.ctl.tick()
            assert status["lastCycle"]["mode"] == FULL_RETRAIN
            assert status["candidate"]["resync"] is True
            loop.promote_to_live()
            status = loop.ctl.status()
            assert status["lastCycle"]["outcome"] == "live"
            assert loop.ctl.watcher.generation == fresh.generation
            assert status["pendingEvents"] == 0
            cf2 = Changefeed(fresh, loop.registry.get_events(), loop.registry.get_metadata(),
                             loop.registry.get_models())
            cf2.insert_event(_rate(Event, "u7", "i1", 5.0), 1)
            status = loop.ctl.tick()
            assert "feed gap" not in (status.get("lastError") or "")
            assert status["pendingEvents"] == 1
        finally:
            loop.close()

    def test_restart_mid_cycle_resumes_cursor_and_rollout(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.workflow import QueryServer, ServerConfig

        loop = PortLoop(tmp_path, monkeypatch)
        try:
            loop.post(delta_ratings(np.random.default_rng(8), 0, 4))
            cand_id = loop.ctl.tick()["candidate"]["instanceId"]
            assert loop.server.rollout.stage == ROLLOUT_SHADOW
            n_instances = len(loop.registry.get_metadata().engine_instance_get_all())
        finally:
            loop.close()
        clock2 = FakeClock()
        srv2 = QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu"),
                           loop.engine, loop.registry, clock=clock2)
        try:
            assert srv2.rollout.stage == ROLLOUT_SHADOW
            assert srv2.rollout.plan.candidate_instance_id == cand_id
            ctl2 = ContinuousController(srv2, loop.config,
                                        feed=LocalFeed(loop.changefeed.oplog), clock=clock2)
            status = ctl2.tick()
            assert status["state"] == "MONITORING"
            assert status["candidate"]["instanceId"] == cand_id and status["cursorSeq"] == 0
            assert len(loop.registry.get_metadata().engine_instance_get_all()) == n_instances
            for rnd in range(6):
                if not srv2.rollout.active:
                    break
                for k in range(8):
                    srv2.handle_query({"user": f"u{k}", "num": 3}, info={})
                srv2.rollout.drain_shadow()
                clock2.advance(11.0)
                srv2.handle_query({"user": f"u{rnd}", "num": 3}, info={})
                srv2.rollout.drain_shadow()
            status = ctl2.tick()
            assert srv2.rollout.plan.stage == ROLLOUT_LIVE
            assert srv2.deployment.instance.id == cand_id
            assert status["cursorSeq"] == loop.changefeed.last_seq
            assert status["lastCycle"]["outcome"] == "live"
            ctl3 = ContinuousController(srv2, loop.config,
                                        feed=LocalFeed(loop.changefeed.oplog), clock=clock2)
            status = ctl3.tick()  # resumed at the committed cursor: no cycle
            assert status["feedLagOps"] == 0 and status["cycles"] == 0
            assert status["cursorSeq"] == loop.changefeed.last_seq
        finally:
            srv2.server_close()

    def test_a_controller_needs_a_feed(self, tmp_path, monkeypatch):
        loop = PortLoop(tmp_path, monkeypatch)
        try:
            with pytest.raises(ValueError, match="needs a changefeed"):
                ContinuousController(loop.server, ContinuousConfig(state_dir=str(tmp_path)))
            with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
                ContinuousController(loop.server, ContinuousConfig(
                    state_dir=str(tmp_path), feed_url="pio+ha://a:1,b:2"))
        finally:
            loop.close()


# -- both packages' controllers on one stream --------------------------------
@pytest.mark.parametrize("case", ["fold", "fold_new_entities", "delta_fraction"])
def test_the_controllers_decide_and_fold_as_the_jax_package_does(case, tmp_path, monkeypatch):
    _use_jax_rows(monkeypatch)
    rng = np.random.default_rng(SEED + 3)
    if case == "fold":
        delta, kw = delta_ratings(rng, 0, 6), {}
    elif case == "fold_new_entities":
        delta, kw = delta_ratings(rng, 0, 5, new_users=2, new_items=1), {}
    else:
        delta, kw = delta_ratings(rng, 0, 8), {"policy": FoldInPolicy(max_delta_fraction=0.05)}
    port = PortLoop(tmp_path, monkeypatch, **kw)
    jax = JaxLoop(tmp_path, monkeypatch,
                  **({"policy": jfold.FoldInPolicy(max_delta_fraction=0.05)} if kw else {}))
    try:
        port.post(delta)
        jax.post(delta)
        got, want = port.ctl.tick(), jax.ctl.tick()
        assert decisions(got) == decisions(want)
        assert got["state"] == "MONITORING" and got["cursorSeq"] == want["cursorSeq"] == 0
        if case == "delta_fraction":
            assert got["lastCycle"]["mode"] == FULL_RETRAIN
            assert "delta fraction" in got["lastCycle"]["reason"]
            return
        assert got["lastCycle"]["mode"] == FOLD_IN
        assert got["lastCycle"]["foldIn"]["newUsers"] == want["lastCycle"]["foldIn"]["newUsers"]
        pu, pi, puf, pif = candidate_factors(port, got, port=True)
        ju, ji, juf, jif = candidate_factors(jax, want, port=False)
        assert (pu, pi) == (ju, ji)
        np.testing.assert_allclose(puf, juf, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pif, jif, rtol=RTOL, atol=ATOL)
        # untouched rows are the baseline's, bit for bit
        uf, itf = seeded_tables(SEED, N_USERS, N_ITEMS, RANK)
        touched_u = {pu[u] for u, _, _ in delta if u in pu}
        keep = [r for r in range(N_USERS) if r not in touched_u]
        np.testing.assert_array_equal(puf[keep], uf[keep])
    finally:
        port.close()
        jax.close()
