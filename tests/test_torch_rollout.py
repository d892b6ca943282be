"""The port's rollout plane (``predictionio_tpu_torch/rollout``) against the
JAX package's (``predictionio_tpu/rollout``).

Seeded ALS tables (50 users × 40 items, rank 4) serve on the port's query
server on ``device="cpu"``; the gates, holds and windows read injected
fake clocks, so no test sleeps into a window.

- the sticky split: ``bucket_for_key`` and ``variant_for_key`` equal to
  the JAX package's for 10,000 seeded keys × 3 salts × 5 percents, the
  golden buckets, ``sticky_key`` and ``plan_epoch``;
- ``prediction_divergence`` on seeded ALS answers equal to JAX's (rtol
  1e-12); the controller's verdict sequence equal on one recorded stream;
  ``GateConfig`` round trip and strict decode;
- a plan upserted by one package's ``MetadataStore`` read by the other's
  from the same SQLite file, both ways;
- a JAX and a port query server stepping through SHADOW, 300 canary
  queries and LIVE on one script: the same stages, variant per key and
  served ids (outside ties), scores at 1e-5;
- mirrors of the JAX package's ``TestRolloutE2E``, ``TestRolloutHTTP``,
  ``TestFeedbackVariant``, ``TestShadowPoolConcurrency`` and the CLI
  (``pio rollout``), plus the port's own: the candidate's batcher counts
  its batches apart, a shadow failure is counted on ``/rollout.json``, a
  candidate that fails to load is a 409.

Left out, with the items they wait for: ``TestStickyAcrossFailover`` and
changefeed replication (queue 1 item 12, HA metadata), ``TestRolloutChaos``
(item 14, the load generator) and the dashboard's rollout pages (item 14).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import unittest.mock as mock
import weakref

import numpy as np
import pytest

import predictionio_tpu.rollout.controller as jax_controller
import predictionio_tpu.rollout.plan as jax_plan
import predictionio_tpu.storage.metadata as jax_md
import predictionio_tpu_torch.rollout.controller as port_controller
import predictionio_tpu_torch.rollout.plan as port_plan
import predictionio_tpu_torch.storage.metadata as port_md
from predictionio_tpu_torch.rollout import RolloutError
from predictionio_tpu_torch.rollout.plan import (
    BASELINE,
    CANDIDATE,
    GateConfig,
    prediction_divergence,
    sticky_key,
    variant_for_key,
)
from predictionio_tpu_torch.storage.metadata import (
    ROLLOUT_ABORTED,
    ROLLOUT_CANARY,
    ROLLOUT_LIVE,
    ROLLOUT_ROLLED_BACK,
    ROLLOUT_SHADOW,
    RolloutPlan,
    utcnow,
)
from predictionio_tpu_torch.testing import faults
from predictionio_tpu_torch.testing.clock import FakeClock

from torch_plane import close_server, jax_store, port_store, request, wait_until

N_USERS, N_ITEMS, RANK = 50, 40, 4
BASE_SEED, CAND_SEED = 3, 5


@pytest.fixture(autouse=True)
def _no_faults():
    faults.deactivate()
    yield
    faults.deactivate()


def _tables(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            rng.normal(size=(N_ITEMS, RANK)).astype(np.float32))


def _port_model(seed):
    from predictionio_tpu_torch.models.recommendation import als_model_from_numpy

    uf, itf = _tables(seed)
    return als_model_from_numpy(RANK, uf, itf, [f"u{i}" for i in range(N_USERS)],
                                [f"i{i}" for i in range(N_ITEMS)])


def _jax_model(seed):
    from predictionio_tpu.models.recommendation import ALSModel
    from predictionio_tpu.storage import BiMap

    uf, itf = _tables(seed)
    return ALSModel(rank=RANK, user_factors=uf, item_factors=itf,
                    user_map=BiMap({f"u{i}": i for i in range(N_USERS)}),
                    item_map=BiMap({f"i{i}": i for i in range(N_ITEMS)}))


def _port_server(registry, clock, instance_id=None, **config):
    from predictionio_tpu_torch.models.recommendation import engine_factory
    from predictionio_tpu_torch.workflow import QueryServer, ServerConfig

    return QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu",
                                    engine_instance_id=instance_id, **config),
                       engine_factory(), registry, clock=clock)


@pytest.fixture()
def pair(tmp_path):
    """(registry, baseline id, candidate id): two port instances."""
    registry, ids = port_store(tmp_path, [_port_model(BASE_SEED), _port_model(CAND_SEED)])
    return registry, ids[0], ids[1]


#: tight gates that converge in a handful of queries; the latency gate is
#: off (these drives record real latencies into tiny windows; the gate's
#: logic is pinned on the fake clock in the controller tests)
def _gates(**overrides):
    g = {"min_samples": 5, "window_s": 100_000.0, "shadow_hold_s": 10.0,
         "canary_hold_s": 10.0, "max_divergence": 1.0, "max_p99_latency_ratio": 1_000.0}
    g.update(overrides)
    return g


def _drive(server, n, start=0, num=4):
    """``n`` queries over distinct users; every one must answer (the
    zero-client-failures invariant); returns the variant counts."""
    counts: dict = {}
    for i in range(start, start + n):
        info: dict = {}
        server.handle_query({"user": f"u{i % N_USERS}", "num": num, "i": i}, info=info)
        v = info.get("variant", "-")
        counts[v] = counts.get(v, 0) + 1
    return counts


# -- the sticky split ------------------------------------------------------------------
SALTS = ("salt-a", "4f1c2d9e8b7a6f50", "")
PERCENTS = (0, 0.5, 10, 99.5, 100)


@pytest.mark.parametrize("salt", SALTS)
def test_buckets_and_variants_equal_the_jax_packages(salt):
    rng = np.random.default_rng(17)
    keys = [f"user={k}" for k in rng.integers(0, 10**9, 10_000)]
    for key in keys:
        assert port_plan.bucket_for_key(salt, key) == jax_plan.bucket_for_key(salt, key)
        for percent in PERCENTS:
            assert (port_plan.variant_for_key(salt, key, percent)
                    == jax_plan.variant_for_key(salt, key, percent))


def test_sticky_key_and_plan_epoch_equal_the_jax_packages():
    payloads = [{"user": "7", "num": 10}, {"userId": 3}, {"uid": 1.5}, {"entityId": True},
                {"item": "i3"}, {"id": 9}, {"z": 1, "a": [1, 2]}, {"user": {"nested": 1}},
                ["a", 1], "raw", 42, None, {"user": None, "entity_id": "e"}]
    for payload in payloads:
        assert port_plan.sticky_key(payload) == jax_plan.sticky_key(payload)
    assert port_plan.plan_epoch(None) == jax_plan.plan_epoch(None) == "-"
    now = utcnow()
    kw = dict(id="RO-1", stage="CANARY", engine_id="e", engine_version="1",
              engine_variant="engine.json", baseline_instance_id="EI-1",
              candidate_instance_id="EI-2", percent=12.5, salt="s", created_time=now,
              updated_time=now)
    assert (port_plan.plan_epoch(RolloutPlan(**kw))
            == jax_plan.plan_epoch(jax_md.RolloutPlan(**kw)))


class TestBucketGoldenVectors:
    """The JAX package's golden buckets, exactly (``tests/test_rollout.py``)."""

    GOLDEN = {
        ("fleet-golden", "user=0"): 1188,
        ("fleet-golden", "user=1"): 8857,
        ("fleet-golden", "user=2"): 4115,
        ("fleet-golden", "user=42"): 4945,
        ("fleet-golden", "entityId=abc"): 4878,
        ("fleet-golden", '{"q": 1}'): 5626,
        ("s2", "user=0"): 8615,
        ("s2", "user=1"): 8530,
        ("s2", "user=2"): 8835,
    }

    def test_exact_bucket_assignments(self):
        assert port_plan.NUM_BUCKETS == 10_000
        for (salt, key), expected in self.GOLDEN.items():
            assert port_plan.bucket_for_key(salt, key) == expected, (salt, key)

    def test_variant_threshold_derives_from_buckets(self):
        for (salt, key), bucket in self.GOLDEN.items():
            for percent in (0.0, 11.88, 11.89, 48.78, 50.0, 100.0):
                expected = (CANDIDATE if 0 < percent
                            and (percent >= 100 or bucket < round(percent * 100))
                            else BASELINE)
                assert variant_for_key(salt, key, percent) == expected


class TestStickySplit:
    def test_deterministic_and_percent_bounded(self):
        keys = [f"user={i}" for i in range(2000)]
        first = {k: variant_for_key("salt-a", k, 10.0) for k in keys}
        assert first == {k: variant_for_key("salt-a", k, 10.0) for k in keys}
        share = sum(v == CANDIDATE for v in first.values()) / len(keys)
        assert 0.05 < share < 0.15

    def test_percent_edges(self):
        assert variant_for_key("s", "k", 0) == BASELINE
        assert variant_for_key("s", "k", 100) == CANDIDATE

    def test_salt_rotates_the_sampled_subset(self):
        keys = [f"user={i}" for i in range(500)]
        a = {k for k in keys if variant_for_key("salt-a", k, 20.0) == CANDIDATE}
        b = {k for k in keys if variant_for_key("salt-b", k, 20.0) == CANDIDATE}
        assert a != b

    def test_sticky_key_prefers_entity_fields(self):
        assert sticky_key({"user": "7", "num": 10}) == "user=7"
        assert sticky_key({"entityId": 3}) == "entityId=3"
        assert sticky_key({"z": 1, "a": 2}) == sticky_key({"a": 2, "z": 1})


class TestPlanEpoch:
    class _Plan:
        def __init__(self, **kw):
            self.id = kw.get("id", "RP-1")
            self.stage = kw.get("stage", "CANARY")
            self.percent = kw.get("percent", 10.0)
            self.salt = kw.get("salt", "s")
            self.baseline_instance_id = kw.get("baseline", "EI-1")
            self.candidate_instance_id = kw.get("candidate", "EI-2")
            self.updated_time = kw.get("updated", "t0")

    def test_deterministic_and_none_is_its_own_epoch(self):
        assert port_plan.plan_epoch(None) == "-"
        assert port_plan.plan_epoch(self._Plan()) == port_plan.plan_epoch(self._Plan())

    @pytest.mark.parametrize("change", [{"id": "RP-2"}, {"stage": "SHADOW"},
                                        {"percent": 50.0}, {"salt": "other"},
                                        {"baseline": "EI-9"}, {"candidate": "EI-9"},
                                        {"updated": "t1"}])
    def test_every_serving_relevant_field_moves_the_epoch(self, change):
        assert port_plan.plan_epoch(self._Plan(**change)) != port_plan.plan_epoch(self._Plan())


# -- divergence, the gates -------------------------------------------------------------
def test_divergence_of_seeded_als_answers_equals_the_jax_packages(tmp_path):
    from predictionio_tpu_torch.workflow.serving import encode_result

    registry, (base_id, cand_id) = port_store(
        tmp_path, [_port_model(BASE_SEED), _port_model(CAND_SEED)])
    base = _port_server(registry, FakeClock(), base_id)
    cand = _port_server(registry, FakeClock(), cand_id)
    try:
        values = []
        for u in range(N_USERS):
            q = {"user": f"u{u}", "num": 1 + u % 12}
            a, b = encode_result(base.handle_query(q)), encode_result(cand.handle_query(q))
            mine, theirs = prediction_divergence(a, b), jax_plan.prediction_divergence(a, b)
            np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=0)
            assert prediction_divergence(a, a) == 0.0
            values.append(mine)
        assert 0.0 < float(np.mean(values)) <= 1.0
    finally:
        base.server_close()
        cand.server_close()


class TestDivergence:
    def test_identical_is_zero(self):
        result = {"items": [{"item": "a", "score": 1.5}], "n": 3}
        assert prediction_divergence(result, result) == 0.0

    def test_disjoint_is_one(self):
        assert prediction_divergence({"a": 1}, {"b": 2}) == 1.0

    def test_numeric_relative_distance(self):
        assert prediction_divergence({"score": 1.0}, {"score": 3.0}) == pytest.approx(0.5)

    def test_rank_shift_counts(self):
        a, b = {"items": ["x", "y"]}, {"items": ["y", "x"]}
        assert prediction_divergence(a, b) == 1.0
        assert prediction_divergence(a, a) == 0.0


def test_controller_verdicts_equal_the_jax_packages_on_one_stream():
    """One recorded stream (seeded latencies, errors, divergences and
    clock steps) through both controllers: the same verdict and reason
    after every step."""
    rng = np.random.default_rng(23)
    gates = dict(_gates(), max_p99_latency_ratio=3.0, max_divergence=0.3,
                 max_error_rate_delta=0.1, window_s=60.0)
    clocks = (jax_controller_clock := FakeClock(), FakeClock())
    ctls = (jax_controller.RolloutController(jax_plan.GateConfig.from_dict(gates),
                                             jax_controller_clock),
            port_controller.RolloutController(GateConfig.from_dict(gates), clocks[1]))
    stage = ROLLOUT_SHADOW
    verdicts = []
    for step in range(400):
        cand = bool(rng.integers(0, 2))
        latency = float(rng.lognormal(-4.0, 0.6 if not cand or step < 250 else 1.6))
        ok = bool(rng.random() > (0.02 if step < 300 else 0.3 if cand else 0.02))
        div = float(rng.uniform(0, 0.5 if step > 200 else 0.2))
        dt = float(rng.uniform(0, 0.5))
        got = []
        for clock, ctl in zip(clocks, ctls):
            clock.advance(dt)
            ctl.record(cand, latency, ok)
            if step % 3 == 0:
                ctl.record_divergence(div)
            got.append(ctl.evaluate(stage))
        assert got[0] == got[1], (step, got)
        verdicts.append(got[1][0])
        if got[1][0] == "promote" and stage == ROLLOUT_SHADOW:
            stage = ROLLOUT_CANARY
            for ctl in ctls:
                ctl.enter_stage()
    assert {"hold", "promote", "rollback"} <= set(verdicts)


class TestRolloutController:
    def _ctl(self, clock, **gates):
        return port_controller.RolloutController(GateConfig.from_dict(_gates(**gates)), clock)

    def test_holds_until_samples_then_hold_timer(self):
        clock = FakeClock()
        ctl = self._ctl(clock)
        verdict, reason = ctl.evaluate(ROLLOUT_SHADOW)
        assert verdict == "hold" and "samples" in reason
        for _ in range(5):
            ctl.record(True, 0.01, ok=True)
            ctl.record(False, 0.01, ok=True)
        verdict, reason = ctl.evaluate(ROLLOUT_SHADOW)
        assert verdict == "hold" and "holding" in reason
        clock.advance(11)
        assert ctl.evaluate(ROLLOUT_SHADOW)[0] == "promote"

    def test_error_gate_rolls_back_before_hold_elapses(self):
        ctl = self._ctl(FakeClock())
        for _ in range(10):
            ctl.record(False, 0.01, ok=True)
            ctl.record(True, 0.01, ok=False)
        verdict, reason = ctl.evaluate(ROLLOUT_CANARY)
        assert verdict == "rollback" and "error-rate" in reason

    def test_latency_gate(self):
        ctl = self._ctl(FakeClock(), max_p99_latency_ratio=2.0)
        for _ in range(20):
            ctl.record(False, 0.010, ok=True)
            ctl.record(True, 0.100, ok=True)
        verdict, reason = ctl.evaluate(ROLLOUT_CANARY)
        assert verdict == "rollback" and "p99" in reason

    def test_divergence_gate_shadow_only(self):
        clock = FakeClock()
        ctl = self._ctl(clock, max_divergence=0.25)
        for _ in range(10):
            ctl.record(False, 0.01, ok=True)
            ctl.record(True, 0.01, ok=True)
            ctl.record_divergence(0.9)
        verdict, reason = ctl.evaluate(ROLLOUT_SHADOW)
        assert verdict == "rollback" and "divergence" in reason
        clock.advance(11)
        assert ctl.evaluate(ROLLOUT_CANARY)[0] == "promote"

    def test_score_psi_gate_abstains_on_none_and_fires_above_the_bar(self):
        ctl = self._ctl(FakeClock(), max_score_psi=0.25)
        for _ in range(10):
            ctl.record(False, 0.01, ok=True)
            ctl.record(True, 0.01, ok=True)
        ctl.quality_psi = lambda: None
        assert ctl.evaluate(ROLLOUT_CANARY)[0] == "hold"
        ctl.quality_psi = lambda: 0.9
        verdict, reason = ctl.evaluate(ROLLOUT_CANARY)
        assert verdict == "rollback" and "score PSI" in reason

    def test_window_expires_old_samples(self):
        clock = FakeClock()
        ctl = self._ctl(clock, window_s=60.0)
        for _ in range(10):
            ctl.record(True, 0.01, ok=False)
        assert ctl.candidate.count() == 10
        clock.advance(61)
        assert ctl.candidate.count() == 0

    def test_gate_config_rejects_unknown_keys(self):
        with pytest.raises(ValueError, match="unknown gate option"):
            GateConfig.from_dict({"max_errors": 1})


def test_gate_config_round_trips_like_the_jax_packages():
    cfg = GateConfig.from_dict({"min_samples": 7.0, "canary_percent": 12.5,
                                "max_score_psi": 0.3})
    assert cfg.min_samples == 7 and isinstance(cfg.min_samples, int)
    assert GateConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == jax_plan.GateConfig.from_dict(cfg.to_dict()).to_dict()
    assert GateConfig().to_dict() == jax_plan.GateConfig().to_dict()


# -- the durable plan ------------------------------------------------------------------
def _plan(module, **kw):
    now = module.utcnow()
    defaults = dict(id="", stage="SHADOW", engine_id="default", engine_version="1",
                    engine_variant="engine.json", baseline_instance_id="EI-base",
                    candidate_instance_id="EI-cand", percent=10.0, salt="abc123",
                    created_time=now, updated_time=now, gates={"min_samples": 5.0},
                    history=[{"stage": "SHADOW", "atMs": 1, "reason": "start"}])
    defaults.update(kw)
    return module.RolloutPlan(**defaults)


def _fields(plan):
    return {f: getattr(plan, f) for f in (
        "id", "stage", "engine_id", "engine_version", "engine_variant",
        "baseline_instance_id", "candidate_instance_id", "percent", "salt", "gates",
        "history")} | {"created_ms": int(plan.created_time.timestamp() * 1000),
                       "updated_ms": int(plan.updated_time.timestamp() * 1000)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_plan_crosses_one_sqlite_file_both_ways(writer, tmp_path):
    path = str(tmp_path / "metadata.db")
    stores = {"jax": jax_md.MetadataStore(path), "port": port_md.MetadataStore(path)}
    modules = {"jax": jax_md, "port": port_md}
    reader = "port" if writer == "jax" else "jax"
    try:
        pid = stores[writer].rollout_plan_upsert(_plan(modules[writer], stage="CANARY"))
        got = stores[reader].rollout_plan_get(pid)
        want = stores[writer].rollout_plan_get(pid)
        assert _fields(got) == _fields(want)
        assert stores[reader].rollout_plan_get_active("default", "1", "engine.json").id == pid
        # the reader closes it; the writer sees the terminal plan
        stores[reader].rollout_plan_upsert(
            _plan(modules[reader], id=pid, stage="ROLLED_BACK"))
        assert stores[writer].rollout_plan_get_active("default", "1", "engine.json") is None
        latest = stores[writer].rollout_plan_get_latest("default", "1", "engine.json")
        assert latest.id == pid and latest.stage == "ROLLED_BACK"
        assert [p.id for p in stores[writer].rollout_plan_get_all()] == [pid]
    finally:
        for store in stores.values():
            store.close()


def test_plan_dao_roundtrip_and_active_selection():
    md = port_md.MetadataStore(":memory:")
    pid = md.rollout_plan_upsert(_plan(port_md))
    assert pid.startswith("RO-")
    got = md.rollout_plan_get(pid)
    assert got.salt == "abc123" and got.gates == {"min_samples": 5.0}
    assert got.history[0]["reason"] == "start"
    assert md.rollout_plan_get_active("default", "1", "engine.json").id == pid
    md.rollout_plan_upsert(_plan(port_md, id=pid, stage=ROLLOUT_ROLLED_BACK))
    assert md.rollout_plan_get_active("default", "1", "engine.json") is None
    assert md.rollout_plan_get_latest("default", "1", "engine.json").stage == ROLLOUT_ROLLED_BACK


# -- the shadow pool -----------------------------------------------------------------------
class TestShadowPoolConcurrency:
    def _manager(self):
        import time as _time

        from predictionio_tpu_torch.obs.metrics import MetricsRegistry
        from predictionio_tpu_torch.rollout.manager import RolloutManager

        class _Stub:
            pass

        server = _Stub()
        server.clock = _time.monotonic
        server.metrics = MetricsRegistry()
        return RolloutManager(server)

    def test_concurrent_drains_never_double_pop_or_indexerror(self):
        import threading
        from concurrent.futures import Future

        mgr = self._manager()
        try:
            errors = []
            for _round in range(8):
                for _ in range(200):
                    fut = Future()
                    fut.set_result(None)
                    mgr._shadow_futures.append(fut)

                def drain():
                    try:
                        mgr.drain_shadow(timeout_s=5)
                    except Exception as exc:
                        errors.append(exc)

                threads = [threading.Thread(target=drain) for _ in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
                assert not mgr._shadow_futures
            assert errors == []
        finally:
            mgr.close()

    def test_gauge_callbacks_read_under_the_manager_lock(self):
        import threading

        mgr = self._manager()
        try:
            got = []
            mgr._lock.acquire()
            try:
                t = threading.Thread(target=lambda: got.append(
                    (mgr._stage_code(), mgr._live_percent())))
                t.start()
                t.join(timeout=0.05)
                assert t.is_alive()  # blocked on the lock
            finally:
                mgr._lock.release()
            t.join(timeout=30)
            assert got == [(0, 0.0)]
        finally:
            mgr.close()

    def test_the_pool_has_two_workers_and_a_pending_cap(self):
        from predictionio_tpu_torch.rollout import manager

        mgr = self._manager()
        try:
            assert mgr._shadow_pool._max_workers == manager.SHADOW_WORKERS == 2
            assert manager._SHADOW_PENDING_CAP == 32
        finally:
            mgr.close()


# -- the state machine end to end (the port's server on the CPU, fake clock) ---------------
class TestRolloutE2E:
    def test_shadow_canary_live_when_gates_pass(self, pair):
        registry, base_id, cand_id = pair
        clock = FakeClock()
        srv = _port_server(registry, clock, base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=10, gates=_gates())
            assert srv.rollout.stage == ROLLOUT_SHADOW
            counts = _drive(srv, 10)
            srv.rollout.drain_shadow()
            assert counts == {"baseline": 10}
            assert srv.rollout.controller.candidate.count() >= 5
            assert srv.rollout.controller.mean_divergence() is not None
            clock.advance(11)
            _drive(srv, 1, start=100)
            srv.rollout.drain_shadow()
            assert srv.rollout.stage == ROLLOUT_CANARY
            counts = _drive(srv, 300, start=1000)
            assert counts.get("candidate", 0) >= 1
            assert counts["baseline"] > counts.get("candidate", 0)
            clock.advance(11)
            _drive(srv, 5, start=5000)
            assert srv.rollout.stage == ROLLOUT_LIVE
            assert srv.deployment.instance.id == cand_id
            plan = registry.get_metadata().rollout_plan_get_all()[0]
            assert [h["stage"] for h in plan.history] == [
                ROLLOUT_SHADOW, ROLLOUT_CANARY, ROLLOUT_LIVE]
            srv2 = _port_server(registry, FakeClock())
            try:
                assert srv2.deployment.instance.id == cand_id
                assert not srv2.rollout.active
            finally:
                srv2.server_close()
        finally:
            srv.server_close()

    def test_restart_mid_canary_resumes_same_sticky_split(self, pair):
        registry, base_id, cand_id = pair
        clock = FakeClock()
        srv = _port_server(registry, clock, base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=50, gates=_gates())
            _drive(srv, 6)
            srv.rollout.drain_shadow()
            clock.advance(11)
            _drive(srv, 1, start=50)
            srv.rollout.drain_shadow()
            assert srv.rollout.stage == ROLLOUT_CANARY
            srv2 = _port_server(registry, FakeClock())
            try:
                assert srv2.rollout.stage == ROLLOUT_CANARY
                assert srv2.deployment.instance.id == base_id
                assert srv2.rollout.candidate_dep.instance.id == cand_id
                assert srv2.rollout.plan.salt == srv.rollout.plan.salt
                for i in range(100):
                    payload = {"user": f"u{i}"}
                    assert srv.rollout.variant_for(payload) == srv2.rollout.variant_for(payload)
            finally:
                srv2.server_close()
        finally:
            srv.server_close()

    def test_failing_candidate_auto_rolls_back_with_zero_client_failures(self, pair):
        registry, base_id, cand_id = pair
        clock = FakeClock()
        srv = _port_server(registry, clock, base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=50,
                              gates=_gates(canary_hold_s=100_000.0))
            _drive(srv, 6)
            srv.rollout.drain_shadow()
            clock.advance(11)
            _drive(srv, 1, start=50)
            srv.rollout.drain_shadow()
            assert srv.rollout.stage == ROLLOUT_CANARY
            with faults.inject(faults.FaultSpec(site="serving.candidate", kind="refuse")) as plan:
                _drive(srv, 100, start=1000)  # every query answers
                assert plan.fired("serving.candidate") > 0
            assert srv.rollout.stage == ROLLOUT_ROLLED_BACK
            assert _drive(srv, 50, start=9000) == {"-": 50}
            assert srv.deployment.instance.id == base_id
            durable = registry.get_metadata().rollout_plan_get_all()[0]
            assert durable.stage == ROLLOUT_ROLLED_BACK
            assert "error-rate" in durable.history[-1]["reason"]
            srv2 = _port_server(registry, FakeClock())
            try:  # the rolled-back candidate is quarantined on restart
                assert not srv2.rollout.active
                assert srv2.deployment.instance.id == base_id
                assert srv2.rollout.plan.stage == ROLLOUT_ROLLED_BACK
            finally:
                srv2.server_close()
        finally:
            srv.server_close()

    def test_terminal_persist_retried_after_metadata_outage(self, pair, monkeypatch):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, gates=_gates())
            md = registry.get_metadata()
            real_upsert = md.rollout_plan_upsert
            outage = {"on": True}

            def flaky(plan):
                if outage["on"]:
                    raise RuntimeError("metadata down")
                return real_upsert(plan)

            monkeypatch.setattr(md, "rollout_plan_upsert", flaky)
            srv.rollout.abort("during outage")
            assert md.rollout_plan_get_all()[0].stage == ROLLOUT_SHADOW
            outage["on"] = False
            srv.handle_query({"user": "u1", "num": 3})  # the retry lands it
            assert md.rollout_plan_get_all()[0].stage == ROLLOUT_ABORTED
        finally:
            srv.server_close()

    def test_resume_with_unloadable_baseline_closes_the_plan(self, tmp_path):
        registry, (cand_id,) = port_store(tmp_path, [_port_model(CAND_SEED)])
        md = registry.get_metadata()
        md.rollout_plan_upsert(_plan(port_md, stage=ROLLOUT_CANARY,
                                     baseline_instance_id="EI-missing",
                                     candidate_instance_id=cand_id))
        srv = _port_server(registry, FakeClock())
        try:
            assert not srv.rollout.active
            assert srv.rollout.plan.stage == ROLLOUT_ABORTED
            assert "baseline unloadable" in srv.rollout.plan.history[-1]["reason"]
            assert srv.deployment.instance.id == cand_id
            assert md.rollout_plan_get_all()[0].stage == ROLLOUT_ABORTED
        finally:
            srv.server_close()

    def test_client_deadline_expiry_not_charged_to_candidate(self, pair):
        from predictionio_tpu_torch.utils.resilience import Deadline, DeadlineExceeded

        registry, base_id, cand_id = pair
        clock = FakeClock()
        srv = _port_server(registry, clock, base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=100, gates=_gates())
            srv.rollout.promote("straight to canary")
            before = srv.rollout.controller.candidate.count()
            expired = Deadline.after_ms(1, clock)
            clock.advance(1.0)
            with pytest.raises(DeadlineExceeded):
                srv.handle_query({"user": "u1"}, deadline=expired)
            assert srv.rollout.controller.candidate.count() == before
        finally:
            srv.server_close()

    def test_fleet_wide_errors_do_not_trip_the_delta_gate(self, pair):
        from predictionio_tpu_torch.controller import FirstServing

        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=50,
                              gates=_gates(canary_hold_s=100_000.0))
            srv.rollout.promote("straight to canary")
            with mock.patch.object(FirstServing, "serve", side_effect=RuntimeError("dep down")):
                for i in range(60):
                    with pytest.raises(RuntimeError, match="dep down"):
                        srv.handle_query({"user": f"u{i % N_USERS}", "i": i})
            ctl = srv.rollout.controller
            assert ctl.baseline.error_rate() > 0.5 and ctl.candidate.error_rate() > 0.5
            assert srv.rollout.stage == ROLLOUT_CANARY
        finally:
            srv.server_close()

    def test_start_rejects_out_of_range_percent(self, pair):
        registry, _base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), _base_id)
        try:
            for bad in (0, -5, 150, float("nan")):
                with pytest.raises(RolloutError, match="percent"):
                    srv.rollout.start(candidate_instance_id=cand_id, percent=bad,
                                      gates=_gates())
            assert not srv.rollout.active
        finally:
            srv.server_close()

    def test_a_candidate_that_fails_to_load_fails_start(self, pair, monkeypatch):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        try:
            with pytest.raises(RolloutError, match="not found"):
                srv.rollout.start(candidate_instance_id="EI-nope", gates=_gates())
            registry.get_models().delete(cand_id)  # its blob is gone
            with pytest.raises(RolloutError, match=f"candidate {cand_id} could not be loaded"):
                srv.rollout.start(candidate_instance_id=cand_id, gates=_gates())
            assert not srv.rollout.active and srv.rollout.candidate_batcher is None
        finally:
            srv.server_close()

    def test_reload_refused_while_rollout_active(self, pair):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, gates=_gates())
            with pytest.raises(RuntimeError, match="promote or abort"):
                srv.reload()
            srv.rollout.abort("test cleanup")
            srv.reload()
        finally:
            srv.server_close()

    def test_live_swap_and_rollback_drop_model_references(self, pair):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, gates=_gates())
            _drive(srv, 3)
            srv.rollout.drain_shadow()
            cand_ref = weakref.ref(srv.rollout.candidate_dep.models[0])
            srv.rollout.abort("teardown test")
            gc.collect()
            assert cand_ref() is None
            srv.rollout.start(candidate_instance_id=cand_id, gates=_gates())
            base_ref = weakref.ref(srv.deployment.models[0])
            srv.rollout.promote("to canary")
            srv.rollout.promote("to live")
            gc.collect()
            assert base_ref() is None
            assert srv.deployment.instance.id == cand_id
        finally:
            srv.server_close()

    def test_the_candidate_batcher_counts_its_batches_apart(self, pair):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=100, gates=_gates())
            for i in range(4):  # one batch a query, and one a drained duplicate
                _drive(srv, 1, start=i)
                srv.rollout.drain_shadow()
            assert srv.rollout.candidate_batches == 4
            assert srv._batcher.stats["batches"] == 4
            srv.rollout.promote("to canary")
            assert _drive(srv, 6, start=10) == {"candidate": 6}
            assert srv.rollout.candidate_batches == 10
            assert srv._batcher.stats["batches"] == 4
            srv.rollout.promote("to live")
            assert srv.rollout.candidate_batcher is None
            assert srv.rollout.candidate_batches == 10  # the retired batcher counted
            assert _drive(srv, 3, start=20) == {"-": 3}
            assert srv._batcher.stats["batches"] == 7
        finally:
            srv.server_close()

    def test_a_shadow_failure_is_counted_on_rollout_json(self, pair):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        srv.start_background()
        try:
            srv.rollout.start(candidate_instance_id=cand_id, gates=_gates(min_samples=1000))
            with faults.inject(faults.FaultSpec(site="serving.candidate", kind="refuse")):
                assert _drive(srv, 5) == {"baseline": 5}
                srv.rollout.drain_shadow()
            _drive(srv, 2, start=5)
            srv.rollout.drain_shadow()
            status, body, _ = request(srv.bound_port, "GET", "/rollout.json")
            assert status == 200 and body["active"]
            assert body["shadow"]["submitted"] == 7
            assert body["shadow"]["errors"] == 5 and body["shadow"]["ok"] == 2
            assert "ConnectionRefusedError" in body["shadow"]["lastError"]
            assert body["windows"]["candidate"]["errorRate"] == pytest.approx(5 / 7, abs=1e-6)
        finally:
            close_server(srv)


# -- both servers side by side -----------------------------------------------------------
def test_jax_and_port_servers_step_through_the_same_rollout(tmp_path):
    """One script on both packages' servers under fake clocks: SHADOW, 300
    canary queries, LIVE. The plan's salt is set alike on both (it is
    minted at random): the same stages, the same variant per key, the
    same served ids outside ties and scores at 1e-5."""
    from predictionio_tpu.models.recommendation import engine_factory as jax_factory
    from predictionio_tpu.workflow.serving import QueryServer as JaxServer
    from predictionio_tpu.workflow.serving import ServerConfig as JaxConfig

    jreg, (jbase, jcand) = jax_store(tmp_path, [_jax_model(BASE_SEED), _jax_model(CAND_SEED)])
    preg, (pbase, pcand) = port_store(tmp_path, [_port_model(BASE_SEED), _port_model(CAND_SEED)])
    jclock, pclock = FakeClock(), FakeClock()
    jsrv = JaxServer(JaxConfig(ip="127.0.0.1", port=0, batching=False,
                               engine_instance_id=jbase), jax_factory(), jreg, clock=jclock)
    psrv = _port_server(preg, pclock, pbase)
    rng = np.random.default_rng(29)
    try:
        stages = {"jax": [], "port": []}
        answers = {"jax": [], "port": []}
        for name, srv, cand in (("jax", jsrv, jcand), ("port", psrv, pcand)):
            srv.rollout.start(candidate_instance_id=cand, percent=10, gates=_gates())
            # one salt on both: the split is then a pure function of the key
            with srv.rollout._lock:
                srv.rollout.plan = dataclasses.replace(srv.rollout.plan, salt="side-by-side")
        users = [f"u{u}" for u in rng.integers(0, N_USERS, 316)]
        nums = [int(n) for n in rng.integers(1, 15, 316)]
        script = ([("q", 0, 10)] + [("tick", 11.0, None)] + [("q", 10, 11)]
                  + [("q", 11, 311)] + [("tick", 11.0, None)] + [("q", 311, 316)])
        for name, srv, clock in (("jax", jsrv, jclock), ("port", psrv, pclock)):
            for step, a, b in script:
                if step == "tick":
                    clock.advance(a)
                    continue
                for u, n in zip(users[a:b], nums[a:b]):
                    info: dict = {}
                    got = srv.handle_query({"user": u, "num": n}, info=info)
                    result = got[0] if name == "jax" else got
                    answers[name].append((info.get("variant", "-"), result))
                    stages[name].append(srv.rollout.stage)
                srv.rollout.drain_shadow()
        assert stages["jax"] == stages["port"]
        assert stages["port"][0] == ROLLOUT_SHADOW and stages["port"][-1] == ROLLOUT_LIVE
        assert ROLLOUT_CANARY in stages["port"]
        variants = [v for v, _ in answers["port"]]
        assert variants == [v for v, _ in answers["jax"]]
        assert 1 <= variants.count(CANDIDATE) < 100
        for (_, want), (_, got) in zip(answers["jax"], answers["port"]):
            w = [(e["item"], e["score"]) for e in want["itemScores"]]
            g = [(e["item"], e["score"]) for e in got["itemScores"]]
            assert len(w) == len(g)
            ws, gs = np.array([s for _, s in w]), np.array([s for _, s in g])
            close = np.isclose(gs, ws, rtol=1e-5, atol=1e-5)
            assert close.all()
            assert all(a == b or c for (a, _), (b, _), c in zip(g, w, close))
        assert psrv.deployment.instance.id == pcand and jsrv.deployment.instance.id == jcand
        jplan = jreg.get_metadata().rollout_plan_get_all()[0]
        pplan = preg.get_metadata().rollout_plan_get_all()[0]
        assert [h["stage"] for h in jplan.history] == [h["stage"] for h in pplan.history]
    finally:
        jsrv.server_close()
        psrv.server_close()


# -- the HTTP surface ----------------------------------------------------------------------
class TestRolloutHTTP:
    @pytest.fixture()
    def live(self, pair):
        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        srv.start_background()
        yield srv, registry, cand_id
        close_server(srv)

    def test_post_reload_accepted(self, live, tmp_path):
        from predictionio_tpu_torch.controller import EngineParams
        from predictionio_tpu_torch.models.recommendation import ALSAlgorithmParams
        from predictionio_tpu_torch.workflow import persist_instance

        srv, registry, _cand = live
        newest = persist_instance(registry, EngineParams(algorithm_params_list=[
            ("als", ALSAlgorithmParams(rank=RANK))]), [_port_model(11)])
        assert request(srv.bound_port, "POST", "/reload")[0] == 200
        assert srv.deployment.instance.id == newest
        assert request(srv.bound_port, "GET", "/reload")[0] == 200

    def test_rollout_routes(self, live):
        srv, _registry, cand_id = live
        port = srv.bound_port
        status, body, _ = request(port, "POST", "/rollout/start",
                                  {"instanceId": cand_id, "percent": 20, "gates": _gates()})
        assert status == 200 and body["active"]
        assert body["plan"]["stage"] == ROLLOUT_SHADOW and body["plan"]["percent"] == 20
        assert request(port, "POST", "/rollout/start", {})[0] == 409
        assert request(port, "POST", "/reload")[0] == 409
        assert request(port, "GET", "/rollout.json")[1]["active"]
        assert request(port, "GET", "/status.json")[1]["rollout"]["active"]
        status, body, _ = request(port, "POST", "/rollout/promote", {"reason": "t"})
        assert status == 200 and body["plan"]["stage"] == ROLLOUT_CANARY
        status, body, _ = request(port, "POST", "/rollout/abort", {"reason": "done"})
        assert status == 200 and body["plan"]["stage"] == ROLLOUT_ABORTED
        assert request(port, "POST", "/rollout/promote", {})[0] == 409
        assert request(port, "POST", "/rollout/start", [1])[0] == 400

    def test_bad_gate_option_is_400(self, live):
        srv, _registry, cand_id = live
        status, body, _ = request(srv.bound_port, "POST", "/rollout/start",
                                  {"instanceId": cand_id, "gates": {"nope": 1}})
        assert status == 400 and "unknown gate option" in body["message"]

    def test_unknown_candidate_is_409(self, live):
        srv, _registry, _cand = live
        status, body, _ = request(srv.bound_port, "POST", "/rollout/start",
                                  {"instanceId": "EI-nope"})
        assert status == 409 and "not found" in body["message"]

    def test_response_counter_and_header_carry_the_variant(self, live):
        from predictionio_tpu_torch.obs.expo import render

        srv, _registry, cand_id = live
        port = srv.bound_port
        status, _, headers = request(port, "POST", "/queries.json", {"user": "u1"})
        assert status == 200 and headers["X-PIO-Variant"] == "-"
        srv.rollout.start(candidate_instance_id=cand_id, percent=100, gates=_gates())
        srv.rollout.promote("to canary")
        status, _, headers = request(port, "POST", "/queries.json", {"user": "u2"})
        assert status == 200 and headers["X-PIO-Variant"] == CANDIDATE
        text = render(srv.metrics)
        assert 'pio_http_responses_total{status="200",variant="-"}' in text
        assert 'pio_http_responses_total{status="200",variant="candidate"} 1' in text
        assert "pio_rollout_stage 2" in text and "pio_rollout_percent 100" in text


class TestFeedbackVariant:
    def test_feedback_event_tagged_with_serving_variant(self, pair, tmp_path):
        from predictionio_tpu_torch.api.event_server import (
            EventServerConfig,
            create_event_server,
        )
        from predictionio_tpu_torch.storage import EventFilter, StorageRegistry
        from predictionio_tpu_torch.storage.metadata import AccessKey, App

        registry, base_id, cand_id = pair
        ev_reg = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "events")})
        md = ev_reg.get_metadata()
        app_id = md.app_insert(App(id=0, name="fb"))
        md.access_key_insert(AccessKey(key="FBKEY", appid=app_id))
        ev_reg.get_events().init(app_id)
        events = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                     registry=ev_reg, block=False)
        srv = _port_server(registry, FakeClock(), base_id, feedback=True,
                           event_server_ip="127.0.0.1", event_server_port=events.bound_port,
                           access_key="FBKEY")
        try:
            srv.rollout.start(candidate_instance_id=cand_id, percent=100, gates=_gates())
            srv.handle_query({"user": "u4", "num": 3})  # SHADOW: the baseline answers
            srv.rollout.promote("straight to canary")
            info: dict = {}
            srv.handle_query({"user": "u5", "num": 3}, info=info)
            assert info["variant"] == CANDIDATE
            found = wait_until(lambda: (lambda evs: evs if len(evs) == 2 else None)(
                list(ev_reg.get_events().find(app_id, EventFilter(event_names=["predict"])))),
                what="two predict events")
            by_user = {e.properties.to_dict()["query"]["user"]: e.properties.to_dict()
                       for e in found}
            assert by_user["u4"]["variant"] == BASELINE
            assert by_user["u4"]["engineInstanceId"] == base_id
            assert by_user["u5"]["variant"] == CANDIDATE
            assert by_user["u5"]["engineInstanceId"] == cand_id
        finally:
            srv.server_close()
            close_server(events)


# -- pio rollout -----------------------------------------------------------------------------
class TestRolloutCLI:
    def test_rollout_help_renders(self):
        from predictionio_tpu_torch.tools.console import build_parser

        parser = build_parser()
        for argv in (["rollout", "--help"], ["rollout", "abort", "--help"]):
            with pytest.raises(SystemExit) as excinfo:
                parser.parse_args(argv)
            assert excinfo.value.code == 0

    def test_pio_rollout_drives_a_port_server(self, pair, capsys):
        from predictionio_tpu_torch.tools import console

        registry, base_id, cand_id = pair
        srv = _port_server(registry, FakeClock(), base_id)
        srv.start_background()
        where = ["--ip", "127.0.0.1", "--port", str(srv.bound_port)]
        try:
            assert console.main(["rollout", "start", "--instance-id", cand_id, "--percent",
                                 "25", "--gate", "min_samples=5", *where]) == 0
            started = json.loads(capsys.readouterr().out)
            assert started["plan"]["stage"] == ROLLOUT_SHADOW
            assert started["plan"]["gates"]["min_samples"] == 5
            assert console.main(["rollout", "status", *where]) == 0
            assert json.loads(capsys.readouterr().out)["active"]
            assert console.main(["rollout", "promote", "--reason", "ok", *where]) == 0
            assert json.loads(capsys.readouterr().out)["plan"]["stage"] == ROLLOUT_CANARY
            assert console.main(["rollout", "abort", *where]) == 0
            assert json.loads(capsys.readouterr().out)["plan"]["stage"] == ROLLOUT_ABORTED
            assert console.main(["rollout", "abort", *where]) == 1  # nothing active: 409
            assert "409" in json.loads(capsys.readouterr().out)["error"]
            assert console.main(["rollout", "start", "--gate", "oops", *where]) == 1
        finally:
            close_server(srv)
