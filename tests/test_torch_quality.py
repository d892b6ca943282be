"""The port's quality plane (``obs/sketch.py``, ``obs/quality.py``,
``tools/quality.py``) against the JAX package's.

- sketches: ``QuantileSketch`` quantiles, ``merge`` and ``to_dict`` equal
  to the JAX package's on seeded streams with negative values and zeros
  (rel 1e-12); ``psi`` and ``categorical_psi`` equal; a snapshot file
  written by one package is read by the other with ``snapshot_psi`` equal;
- mirrors of the JAX package's ``TestQuantileSketch``, ``TestPSI``,
  ``TestQualityMonitor``, ``TestIngestQualityMonitor`` and
  ``TestQualityCLI`` (its checked-in snapshot pair);
- the serving side: the port's query server exports
  ``pio_quality_score_psi{variant}`` for both variants during a rollout
  and ``pio quality --node`` reads it; the score-drift drill: a candidate
  whose scores are four times the baseline's (fast, error-free) is rolled
  back by ``max_score_psi`` with no client failure, durably, and
  quarantined on restart;
- the ingest side: the port's Event Server counts schema, range and
  poison events, only after the store accepted them, and a skewed batch
  raises ``pio_quality_event_mix_psi``.

Every monitor runs on a fake clock. Left out, with the items they wait
for: the perf-ledger quality records and the dashboard's quality panel
(queue 1 item 14), and ``pio top``'s DRIFT column (item 14).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest

import predictionio_tpu.obs.quality as jax_quality
import predictionio_tpu.obs.sketch as jax_sketch
import predictionio_tpu_torch.obs.quality as port_quality
from predictionio_tpu_torch.obs import expo
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.quality import (
    IngestQualityMonitor,
    QualityConfig,
    QualityMonitor,
    append_snapshot,
    feedback_key,
    load_snapshots,
    scores_from_result,
    snapshot_psi,
)
from predictionio_tpu_torch.obs.sketch import QuantileSketch, categorical_psi, psi
from predictionio_tpu_torch.testing.clock import FakeClock

from torch_plane import close_server, port_store, request

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
N_USERS, N_ITEMS, RANK = 50, 40, 4


def _streams(seed):
    """Seeded score streams: lognormal, mixed sign, with exact zeros and
    sub-``min_magnitude`` values."""
    rng = np.random.default_rng(seed)
    mixed = rng.normal(0.0, 3.0, 3000)
    mixed[::37] = 0.0
    mixed[::53] = 1e-12
    return {"lognormal": rng.lognormal(0.0, 1.0, 2500), "mixed": mixed,
            "negated": -rng.lognormal(1.0, 0.5, 2000),
            "scores": rng.normal(0.0, 1.0, 1200) * 4.0}


def _rel_equal(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=0)


# -- sketch parity with the JAX package -------------------------------------------------
@pytest.mark.parametrize("name", ["lognormal", "mixed", "negated", "scores"])
def test_sketches_equal_the_jax_packages(name):
    values = _streams(4)[name].tolist()
    mine, theirs = QuantileSketch(), jax_sketch.QuantileSketch()
    mine.extend(values)
    theirs.extend(values)
    for q in (0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        _rel_equal(mine.quantile(q), theirs.quantile(q))
    _rel_equal(mine.sum, theirs.sum)
    assert mine.to_dict() == theirs.to_dict()
    # merge: halves merged equal the whole, on both sides alike
    half = len(values) // 2
    a, b = QuantileSketch(), QuantileSketch()
    a.extend(values[:half])
    b.extend(values[half:])
    ja, jb = jax_sketch.QuantileSketch(), jax_sketch.QuantileSketch()
    ja.extend(values[:half])
    jb.extend(values[half:])
    merged, jmerged = a.merge(b), ja.merge(jb)
    assert merged.to_dict() == jmerged.to_dict()
    for q in (0.1, 0.5, 0.9):
        _rel_equal(merged.quantile(q), jmerged.quantile(q))
    # each package reads the other's serialized sketch
    assert (QuantileSketch.from_dict(theirs.to_dict()).to_dict()
            == jax_sketch.QuantileSketch.from_dict(mine.to_dict()).to_dict())


def test_psi_and_categorical_psi_equal_the_jax_packages():
    s = _streams(6)
    pairs = [("lognormal", "mixed"), ("scores", "mixed"), ("negated", "lognormal")]
    for left, right in pairs:
        a, b = QuantileSketch(), QuantileSketch()
        a.extend(s[left].tolist())
        b.extend(s[right].tolist())
        ja, jb = jax_sketch.QuantileSketch(), jax_sketch.QuantileSketch()
        ja.extend(s[left].tolist())
        jb.extend(s[right].tolist())
        for coarsen in (1, 4, 16):
            _rel_equal(psi(a, b, coarsen=coarsen), jax_sketch.psi(ja, jb, coarsen=coarsen))
    mixes = [({"rate": 800, "buy": 150, "view": 50}, {"rate": 50, "buy": 150, "view": 800}),
             ({"rate": 3}, {"view": 9, "rate": 1}), ({"a": 1, "b": 2}, {"a": 2, "b": 4})]
    for ref, cur in mixes:
        _rel_equal(categorical_psi(ref, cur), jax_sketch.categorical_psi(ref, cur))
    assert categorical_psi({}, {"a": 1}) is jax_sketch.categorical_psi({}, {"a": 1}) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_snapshot_file_crosses_both_ways(writer, tmp_path):
    rng = np.random.default_rng(31)
    path = str(tmp_path / "quality.jsonl")
    modules = {"jax": jax_quality, "port": port_quality}
    mod = modules[writer]
    clock = FakeClock()
    if writer == "jax":
        from predictionio_tpu.obs.metrics import MetricsRegistry as Registry
    else:
        Registry = MetricsRegistry
    monitor = mod.QualityMonitor(Registry(clock=clock), clock=clock, config=mod.QualityConfig(
        pin_min_samples=100, min_psi_samples=50, snapshot_path=path))
    monitor.record_scores("baseline", rng.lognormal(0.0, 0.5, 300).tolist())
    monitor.record_scores("candidate", (rng.lognormal(0.0, 0.5, 200) * 3.0).tolist())
    monitor.model_live("EI-7")
    for reader in (jax_quality, modules["port"]):
        snaps = reader.load_snapshots(path)
        assert [s["source"] for s in snaps] == ["baseline-pin", "model-live:EI-7"]
    mine = modules["port"].load_snapshots(path)
    theirs = jax_quality.load_snapshots(path)
    assert mine == theirs
    for variant in ("baseline", "candidate"):
        got = snapshot_psi(mine[0], mine[1], variant=variant)
        want = jax_quality.snapshot_psi(theirs[0], theirs[1], variant=variant)
        assert (got is None) == (want is None)
        if got is not None:
            _rel_equal(got, want)
    assert snapshot_psi(mine[0], mine[1]) == pytest.approx(0.0, abs=1e-6)


# -- mirrors of the JAX package's tests ---------------------------------------------------
class TestQuantileSketch:
    BOUND = 2 * 0.02

    def _assert_close(self, sketch, values, quantiles):
        for q in quantiles:
            exact = float(np.quantile(values, q))
            assert abs(sketch.quantile(q) - exact) <= self.BOUND * abs(exact) + 1e-9

    def test_golden_quantiles_within_documented_bound(self):
        rng = np.random.default_rng(7)
        for values in (rng.lognormal(0.0, 1.0, 4000), rng.uniform(0.5, 100.0, 4000),
                       -rng.lognormal(1.0, 0.5, 4000)):
            s = QuantileSketch()
            s.extend(values.tolist())
            assert s.count == len(values)
            self._assert_close(s, values, (0.01, 0.1, 0.5, 0.9, 0.99))

    def test_mixed_sign_walk_order(self):
        values = np.random.default_rng(11).normal(0.0, 10.0, 4000)
        s = QuantileSketch()
        s.extend(values.tolist())
        qs = [s.quantile(q) for q in (0.05, 0.25, 0.5, 0.75, 0.95)]
        assert qs == sorted(qs)
        self._assert_close(s, values, (0.05, 0.95))

    def test_merge_is_lossless_bucket_addition(self):
        values = np.random.default_rng(3).lognormal(0.0, 1.0, 2000)
        whole = QuantileSketch()
        whole.extend(values.tolist())
        a, b = QuantileSketch(), QuantileSketch()
        a.extend(values[:700].tolist())
        b.extend(values[700:].tolist())
        merged = a.merge(b)
        assert merged.count == whole.count
        assert merged.sum == pytest.approx(whole.sum)
        for q in (0.1, 0.5, 0.9, 0.99):
            assert merged.quantile(q) == whole.quantile(q)

    def test_merge_rejects_mismatched_accuracy(self):
        with pytest.raises(ValueError, match="accuracy"):
            QuantileSketch(rel_err=0.02).merge(QuantileSketch(rel_err=0.05))
        a, b = QuantileSketch(rel_err=0.02), QuantileSketch(rel_err=0.05)
        a.add(1.0)
        b.add(1.0)
        with pytest.raises(ValueError, match="accuracy"):
            psi(a, b)

    def test_bounded_memory_keeps_the_tail_accurate(self):
        values = np.logspace(-3, 3, 5000)
        s = QuantileSketch(max_buckets=16)
        s.extend(values.tolist())
        assert len(s._pos) <= 16
        exact = float(np.quantile(values, 0.99))
        assert abs(s.quantile(0.99) - exact) <= self.BOUND * exact

    def test_nan_skipped_inf_clamped_zero_bucketed(self):
        s = QuantileSketch()
        s.extend([1.0, 2.0, float("nan"), 0.0, 1e-12, math.inf])
        assert s.count == 5
        assert s.quantile(0.0) == 0.0
        assert s.quantile(1.0) >= 2.0 * (1 - 0.02)

    def test_inf_into_empty_store_ranks_as_the_extreme(self):
        s = QuantileSketch()
        s.add(math.inf)
        s.extend([1000.0] * 9)
        assert s.quantile(0.05) == pytest.approx(1000.0, rel=0.05)
        assert s.quantile(1.0) > 1e300
        assert math.isfinite(s.sum) and math.isfinite(s.max) and math.isfinite(s.mean())
        json.loads(json.dumps(s.to_dict(), allow_nan=False))
        s.extend([math.inf, math.inf, 1.7e308])
        other = QuantileSketch()
        other.extend([1.7e308, math.inf])
        s.merge(other)
        assert math.isfinite(s.sum) and math.isfinite(s.mean())
        json.loads(json.dumps(s.to_dict(), allow_nan=False))

    def test_near_max_finite_scores_never_overflow_reads(self):
        s = QuantileSketch()
        s.extend([1.7976e308, 1.5e308, -1.7e308, 1000.0])
        for q in (0.0, 0.25, 0.5, 0.75, 1.0):
            assert math.isfinite(s.quantile(q))
        assert s.quantile(1.0) > 1e300 and s.quantile(0.0) < -1e300

    def test_serialization_roundtrip_preserves_quantiles(self):
        s = QuantileSketch()
        s.extend(np.random.default_rng(5).lognormal(0.0, 1.0, 1000).tolist())
        back = QuantileSketch.from_dict(json.loads(json.dumps(s.to_dict())))
        assert back.count == s.count
        for q in (0.1, 0.5, 0.99):
            assert back.quantile(q) == s.quantile(q)
        assert psi(s, back) == pytest.approx(0.0, abs=1e-12)


class TestPSI:
    def test_identity_is_zero(self):
        s = QuantileSketch()
        s.extend(np.random.default_rng(2).lognormal(0, 1, 500).tolist())
        assert psi(s, s.copy()) == pytest.approx(0.0, abs=1e-12)

    def test_resampled_same_distribution_stays_stable(self):
        rng = np.random.default_rng(9)
        a, b = QuantileSketch(), QuantileSketch()
        a.extend(rng.lognormal(0.0, 1.0, 3000).tolist())
        b.extend(rng.lognormal(0.0, 1.0, 3000).tolist())
        assert psi(a, b) < 0.1

    def test_coarsened_bins_keep_small_samples_stable(self):
        values = np.random.default_rng(9).lognormal(0.0, 0.5, 640)
        small, big = QuantileSketch(), QuantileSketch()
        small.extend(values[:120].tolist())
        big.extend(values.tolist())
        assert psi(small, big) < 0.1
        assert psi(small, big, coarsen=1) > 0.25

    def test_scale_shift_exceeds_the_drift_threshold(self):
        values = np.random.default_rng(9).lognormal(0.0, 1.0, 2000)
        a, b = QuantileSketch(), QuantileSketch()
        a.extend(values.tolist())
        b.extend((values * 4.0).tolist())
        assert psi(a, b) > 0.25

    def test_empty_side_abstains(self):
        s = QuantileSketch()
        s.add(1.0)
        assert psi(s, QuantileSketch()) is None and psi(QuantileSketch(), s) is None

    def test_categorical_identity_shift_and_empty(self):
        mix = {"rate": 800, "buy": 150, "view": 50}
        assert categorical_psi(mix, dict(mix)) == pytest.approx(0.0, abs=1e-12)
        assert categorical_psi(mix, {k: 2 * v for k, v in mix.items()}) == pytest.approx(
            0.0, abs=1e-12)
        assert categorical_psi(mix, {"rate": 50, "buy": 150, "view": 800}) > 0.25
        assert categorical_psi({}, mix) is None and categorical_psi(mix, {}) is None


def _scores(rng, n, scale=1.0):
    return (rng.lognormal(0.0, 0.5, n) * scale).tolist()


class TestQualityMonitor:
    def _monitor(self, tmp_path=None, **overrides):
        clock = FakeClock()
        cfg = QualityConfig(
            pin_min_samples=overrides.pop("pin_min_samples", 100),
            min_psi_samples=overrides.pop("min_psi_samples", 100),
            snapshot_path=str(tmp_path / "quality.jsonl") if tmp_path else None,
            **overrides)
        registry = MetricsRegistry(clock=clock)
        return QualityMonitor(registry, clock=clock, config=cfg), (registry, clock)

    def test_baseline_pins_then_reads_stable(self):
        monitor, (registry, _clock) = self._monitor()
        rng = np.random.default_rng(1)
        assert not monitor.pinned() and monitor.score_psi("baseline") is None
        monitor.record_scores("baseline", _scores(rng, 120))
        assert monitor.pinned()
        monitor.record_scores("baseline", _scores(rng, 400))
        value = monitor.score_psi("baseline")
        assert value is not None and value < 0.1
        assert 'pio_quality_score_psi{variant="baseline"}' in expo.render(registry)

    def test_candidate_drift_detected_and_floors_respected(self):
        monitor, _ = self._monitor()
        rng = np.random.default_rng(4)
        monitor.record_scores("baseline", _scores(rng, 300))
        monitor.record_scores("candidate", _scores(rng, 50, scale=4.0))
        assert monitor.score_psi("candidate") is None
        monitor.record_scores("candidate", _scores(rng, 100, scale=4.0))
        assert monitor.score_psi("candidate") > 0.25

    def test_window_rotation_ages_samples_out(self):
        monitor, (_registry, clock) = self._monitor(window_s=60.0)
        monitor.record_scores("baseline", _scores(np.random.default_rng(6), 300))
        assert monitor.summary()["samples"]["baseline"] == 300
        clock.advance(200.0)
        assert monitor.summary()["samples"]["baseline"] == 0
        assert monitor.pinned()

    def test_feedback_join_hit_miss_and_rank(self):
        monitor, (registry, _clock) = self._monitor()
        monitor.record_served("u1", ["i3", "i7", "i9"])
        assert monitor.record_feedback("u1", "i7") == 2
        assert monitor.record_feedback("u1", "i0") is None
        assert monitor.record_feedback("ghost", "i7") is None
        assert monitor.feedback_hit_rate() == pytest.approx(1 / 2)
        online = monitor.online_quality()
        assert online["feedbackSamples"] == 2 and online["meanServedRank"] == 2.0
        counter = registry.counter("pio_quality_feedback_events_total",
                                   labelnames=("outcome",))
        assert [counter.value(outcome=o) for o in ("hit", "miss", "unjoined")] == [1, 1, 1]

    def test_served_lru_is_bounded(self):
        monitor, _ = self._monitor(served_capacity=4)
        for i in range(10):
            monitor.record_served(f"u{i}", ["a"])
        assert len(monitor._served) == 4
        assert monitor.record_feedback("u0", "a") is None
        assert monitor.record_feedback("u9", "a") == 1

    def test_reset_variant_drops_a_stale_candidate_window(self):
        monitor, _ = self._monitor()
        rng = np.random.default_rng(12)
        monitor.record_scores("baseline", _scores(rng, 300))
        monitor.record_scores("candidate", _scores(rng, 200, scale=4.0))
        assert monitor.score_psi("candidate") > 0.25
        monitor.reset_variant("candidate")
        assert monitor.summary()["samples"]["candidate"] == 0
        assert monitor.score_psi("candidate") is None
        monitor.record_scores("candidate", _scores(rng, 200))
        assert monitor.score_psi("candidate") < 0.25
        monitor.reset_variant("nonsense")

    def test_model_live_repins_and_persists_snapshots(self, tmp_path):
        monitor, _ = self._monitor(tmp_path)
        monitor.record_scores("baseline", _scores(np.random.default_rng(8), 300))
        assert monitor.pinned()
        monitor.model_live("EI-42")
        assert not monitor.pinned()
        assert monitor.summary()["samples"]["baseline"] == 0
        snaps = load_snapshots(str(tmp_path / "quality.jsonl"))
        assert [s["source"] for s in snaps] == ["baseline-pin", "model-live:EI-42"]
        assert snapshot_psi(snaps[0], snaps[1]) == pytest.approx(0.0, abs=1e-6)

    def test_abstaining_monitor_reads_as_unknown_not_stable(self, monkeypatch):
        from predictionio_tpu_torch.obs import top as top_mod
        from predictionio_tpu_torch.tools import quality as quality_tool

        monitor, (registry, _clock) = self._monitor()
        text = expo.render(registry)
        assert 'pio_quality_score_psi{variant="baseline"} -1' in text
        assert "pio_quality_feedback_hit_rate -1" in text
        monkeypatch.setattr(top_mod, "fetch_metrics",
                            lambda node, timeout=5.0: expo.parse_text(expo.render(registry)))
        report = quality_tool.node_report("fake:1")
        assert "scorePsi" not in report and "hitRate" not in report.get("feedback", {})
        monitor.record_feedback("nobody", "a")
        assert "hitRate" not in quality_tool.node_report("fake:1")["feedback"]
        monitor.record_scores("baseline", _scores(np.random.default_rng(5), 300))
        monitor.record_served("u1", ["a", "b"])
        monitor.record_feedback("u1", "a")
        report = quality_tool.node_report("fake:1")
        assert report["scorePsi"]["baseline"] >= 0
        assert report["feedback"]["hitRate"] == 1.0

    def test_snapshot_psi_abstains_on_corrupt_sketch_fields(self):
        sketch = QuantileSketch()
        sketch.extend(_scores(np.random.default_rng(3), 300))
        good = {"serving": {"baseline": sketch.to_dict()}}
        corrupt = {"serving": {"baseline": dict(sketch.to_dict())}}
        corrupt["serving"]["baseline"]["relErr"] = {}
        assert snapshot_psi(good, corrupt) is None and snapshot_psi(corrupt, good) is None

    def test_snapshot_psi_applies_the_live_sample_floor(self):
        rng = np.random.default_rng(9)
        big, small = QuantileSketch(), QuantileSketch()
        big.extend(_scores(rng, 300))
        small.extend(_scores(rng, 10))
        pin = {"serving": {"baseline": big.to_dict()}}
        thin = {"serving": {"baseline": small.to_dict()}}
        assert snapshot_psi(pin, thin) is None and snapshot_psi(thin, pin) is None
        assert snapshot_psi(pin, thin, min_samples=5) is not None

    def test_scores_from_result_shapes(self):
        items, scores = scores_from_result({"itemScores": [
            {"item": "a", "score": 1.5}, {"item": "b", "score": 2},
            {"item": "c", "score": "bad"}]})
        assert items == ["a", "b"] and scores == [1.5, 2.0]
        assert scores_from_result({"score": 0.7}) == ([None], [0.7])
        assert scores_from_result({"label": "spam"}) == ([], [])
        assert scores_from_result("not a dict") == ([], [])

    def test_feedback_key_field_preference(self):
        assert feedback_key({"user": "u1", "num": 5}) == "u1"
        assert feedback_key({"entityId": 7}) == "7"
        assert feedback_key("raw") == "raw"

    def test_append_snapshot_is_the_perf_ledgers_fsynced_line(self, tmp_path):
        path = str(tmp_path / "q.jsonl")
        append_snapshot(path, {"kind": "quality", "source": "a"})
        with open(path, "a") as fh:
            fh.write('{"torn": \n')
        append_snapshot(path, {"kind": "quality", "source": "b"})
        assert [s["source"] for s in load_snapshots(path)] == ["a", "b"]


class TestIngestQualityMonitor:
    class _Props:
        def __init__(self, d):
            self._d = d

        def to_dict(self):
            return self._d

    class _Event:
        def __init__(self, name, props=None):
            self.event = name
            self.properties = TestIngestQualityMonitor._Props(props) if props is not None else None

    def _monitor(self, baseline_dir=None, **overrides):
        clock = FakeClock()
        registry = MetricsRegistry(clock=clock)
        cfg = QualityConfig(baseline_min_events=overrides.pop("baseline_min_events", 20),
                            **overrides)
        return IngestQualityMonitor(registry, clock=clock, config=cfg,
                                    baseline_dir=baseline_dir), registry

    def test_violation_kinds_counted_not_rejected(self):
        monitor, registry = self._monitor()
        monitor.record_event(1, self._Event("rate", {"rating": 3.0}))
        monitor.record_event(1, self._Event("rate", {"rating": 42.0}))
        monitor.record_event(1, self._Event("rate", {}))
        monitor.record_event(1, self._Event("rate", {"rating": True}))
        monitor.record_rejected(1)
        counter = registry.counter("pio_quality_ingest_violations_total",
                                   labelnames=("app", "kind"))
        assert counter.value(app="1", kind="range") == 1
        assert counter.value(app="1", kind="poison") == 2
        assert counter.value(app="1", kind="schema") == 1
        assert monitor.summary()["1"]["events"] == 4

    def test_mix_baseline_pins_then_flags_drift(self):
        monitor, registry = self._monitor()
        monitor.record_event(7, self._Event("view"))
        assert 'pio_quality_event_mix_psi{app="7"} -1' in expo.render(registry)
        for _ in range(14):
            monitor.record_event(7, self._Event("view"))
        for _ in range(5):
            monitor.record_event(7, self._Event("buy"))
        assert monitor.summary()["7"]["baselinePinned"]
        assert monitor.mix_psi(7) < 0.1
        for _ in range(200):
            monitor.record_event(7, self._Event("rate", {"rating": 1.0}))
        assert monitor.mix_psi(7) > 0.25

    def test_baseline_survives_restart_via_durable_file(self, tmp_path):
        first, _ = self._monitor(baseline_dir=str(tmp_path))
        for _ in range(25):
            first.record_event(3, self._Event("view"))
        assert first.summary()["3"]["baselinePinned"]
        second, _ = self._monitor(baseline_dir=str(tmp_path))
        second.record_event(3, self._Event("buy"))
        assert second.summary()["3"]["baselinePinned"] and second.mix_psi(3) > 0.25

    def test_a_baseline_file_crosses_to_the_jax_package(self, tmp_path):
        """Both packages keep ``ingest_baseline_<app>.json`` alike: a pin
        the port wrote is the JAX monitor's baseline after a restart."""
        from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry

        first, _ = self._monitor(baseline_dir=str(tmp_path))
        for name in ["view"] * 15 + ["buy"] * 5:
            first.record_event(4, self._Event(name))
        clock = FakeClock()
        theirs = jax_quality.IngestQualityMonitor(
            JaxRegistry(clock=clock), clock=clock,
            config=jax_quality.QualityConfig(baseline_min_events=20),
            baseline_dir=str(tmp_path))
        theirs.record_event(4, self._Event("view"))
        mine, _ = self._monitor(baseline_dir=str(tmp_path))
        mine.record_event(4, self._Event("view"))
        _rel_equal(mine.mix_psi(4), theirs.mix_psi(4))


class TestQualityCLI:
    STABLE = os.path.join(FIXTURES, "snapshots_stable.jsonl")
    DRIFT = os.path.join(FIXTURES, "snapshots_drift.jsonl")

    def _main(self, *argv):
        from predictionio_tpu_torch.tools import quality as quality_mod

        return quality_mod.main(list(argv))

    def test_diff_exit_codes_pinned_0_1_2(self, tmp_path, capsys):
        assert self._main("--diff", "--snapshots", self.STABLE) == 0
        assert self._main("--diff", "--snapshots", self.DRIFT) == 1
        assert self._main("--diff", "--snapshots", str(tmp_path / "none.jsonl")) == 2
        single = tmp_path / "single.jsonl"
        with open(self.STABLE) as fh:
            single.write_text(fh.readline())
        assert self._main("--diff", "--snapshots", str(single)) == 2
        out = capsys.readouterr()
        assert "DRIFT" in out.out and "error" in out.err

    def test_diff_against_baseline_file_and_json(self, capsys):
        assert self._main("--diff", "--snapshots", self.DRIFT, "--baseline", self.STABLE,
                          "--json") == 1
        verdict = json.loads(capsys.readouterr().out)
        assert verdict["drift"] is True and verdict["psi"]["baseline"] > 0.25

    def test_raised_bar_turns_drift_into_ok(self):
        assert self._main("--diff", "--snapshots", self.DRIFT, "--max-psi", "1e6") == 0

    def test_diff_honors_the_snapshots_recorded_sample_floor(self, tmp_path):
        s = QuantileSketch()
        s.extend(_scores(np.random.default_rng(11), 20))
        path = tmp_path / "thin.jsonl"
        with open(path, "w") as fh:
            for _ in range(2):
                fh.write(json.dumps({"kind": "quality", "source": "t", "minPsiSamples": 10,
                                     "serving": {"baseline": s.to_dict()}}) + "\n")
        assert self._main("--diff", "--snapshots", str(path)) == 0
        assert self._main("--diff", "--snapshots", str(path), "--min-samples", "50") == 2

    def test_snapshot_report_renders(self, capsys):
        assert self._main("--snapshots", self.STABLE) == 0
        out = capsys.readouterr().out
        assert "baseline" in out and "hits=" in out

    def test_console_forwards_verbatim(self, capsys):
        from predictionio_tpu_torch.tools.console import main as console_main

        assert console_main(["quality", "--diff", "--snapshots", self.STABLE]) == 0
        assert "ok baseline" in capsys.readouterr().out

    def test_no_source_is_an_error(self, monkeypatch, capsys):
        monkeypatch.delenv("PIO_QUALITY_SNAPSHOTS", raising=False)
        assert self._main() == 2
        assert "nothing to report" in capsys.readouterr().err

    @pytest.mark.parametrize("argv", [["--snapshots", "STABLE"], ["--diff", "--snapshots",
                                                                   "DRIFT", "--json"]])
    def test_reports_equal_the_jax_clis(self, argv, capsys):
        from predictionio_tpu.tools import quality as jax_tool

        argv = [getattr(self, a) if a in ("STABLE", "DRIFT") else a for a in argv]
        codes, outs = [], []
        for main in (jax_tool.main, self._main):
            codes.append(main(list(argv)) if main is jax_tool.main else main(*argv))
            outs.append(capsys.readouterr().out)
        assert codes[0] == codes[1] and outs[0] == outs[1]


# -- the serving and ingest sides on live servers ------------------------------------------------
def _tables(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_USERS, RANK)).astype(np.float32),
            (rng.normal(size=(N_ITEMS, RANK)) * scale).astype(np.float32))


def _model(seed, scale=1.0, uf=None):
    from predictionio_tpu_torch.models.recommendation import als_model_from_numpy

    users, items = _tables(seed, scale)
    return als_model_from_numpy(RANK, users if uf is None else uf, items,
                                [f"u{i}" for i in range(N_USERS)],
                                [f"i{i}" for i in range(N_ITEMS)])


def _server(registry, clock, instance_id=None, **config):
    from predictionio_tpu_torch.models.recommendation import engine_factory
    from predictionio_tpu_torch.workflow import QueryServer, ServerConfig

    return QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu",
                                    engine_instance_id=instance_id, **config),
                       engine_factory(), registry, clock=clock)


DRILL_GATES = {"min_samples": 20, "window_s": 100_000.0, "shadow_hold_s": 10.0,
               "canary_hold_s": 100_000.0, "max_divergence": 1.0,
               "max_p99_latency_ratio": 1_000.0, "max_score_psi": 0.25}


class TestScoreDriftDrill:
    def test_psi_gate_rolls_back_skewed_candidate(self, tmp_path, capsys):
        """A candidate whose scores are the baseline's times four (well
        formed, fast, error free: invisible to the other gates) is rolled
        back by ``max_score_psi`` with no client failure, a durable
        ROLLED_BACK plan and a quarantine on restart; ``pio quality
        --node`` reads the drift off the live server first."""
        from predictionio_tpu_torch.storage.metadata import ROLLOUT_ROLLED_BACK
        from predictionio_tpu_torch.tools import quality as quality_tool

        base = _model(7)
        skewed = _model(7, uf=base.user_factors * 4.0)
        registry, (base_id, cand_id) = port_store(tmp_path, [base, skewed])
        clock = FakeClock()
        snapshots = str(tmp_path / "quality.jsonl")
        srv = _server(registry, clock, base_id, quality=QualityConfig(
            pin_min_samples=200, min_psi_samples=100, snapshot_path=snapshots))
        srv.start_background()
        try:
            port = srv.bound_port
            for i in range(40):  # 400 scores: the baseline pins at 200
                assert request(port, "POST", "/queries.json",
                               {"user": f"u{i % N_USERS}", "num": 10})[0] == 200
            assert srv.quality.pinned()
            srv.rollout.start(candidate_instance_id=cand_id, percent=50, gates=DRILL_GATES)
            srv.rollout.promote("straight to canary")
            statuses = []
            for i in range(60):
                statuses.append(request(port, "POST", "/queries.json",
                                        {"user": f"u{i % N_USERS}", "num": 10})[0])
                if srv.rollout.stage == ROLLOUT_ROLLED_BACK:
                    break
            assert statuses == [200] * len(statuses)
            # the candidate's window outlives the rollback until the next start
            scraped = quality_tool.node_report(f"127.0.0.1:{port}")
            exit_code = quality_tool.main(["--node", f"127.0.0.1:{port}"])
            assert srv.rollout.stage == ROLLOUT_ROLLED_BACK
            durable = registry.get_metadata().rollout_plan_get_all()[0]
            assert durable.stage == ROLLOUT_ROLLED_BACK
            assert "score PSI" in durable.history[-1]["reason"]
            assert scraped["scorePsi"]["candidate"] > 0.25
            assert scraped["scorePsi"]["baseline"] < 0.1
            assert scraped["scoreSamples"]["candidate"] > 0 and exit_code == 0
            rendered = capsys.readouterr().out
            assert "candidate" in rendered and "psi=" in rendered
            for i in range(10):  # no candidate answers after the rollback
                status, _, headers = request(port, "POST", "/queries.json", {"user": f"u{i}"})
                assert status == 200 and headers["X-PIO-Variant"] == "-"
        finally:
            close_server(srv)
        srv2 = _server(registry, FakeClock())
        try:
            assert srv2.deployment.instance.id == base_id  # quarantined
        finally:
            srv2.server_close()
        assert load_snapshots(snapshots)[0]["source"] == "baseline-pin"


def test_the_query_server_exports_score_psi_for_both_variants(tmp_path):
    registry, (base_id, cand_id) = port_store(tmp_path, [_model(7), _model(9)])
    srv = _server(registry, FakeClock(), base_id, quality=QualityConfig(
        pin_min_samples=50, min_psi_samples=40))
    srv.start_background()
    try:
        port = srv.bound_port
        srv.rollout.start(candidate_instance_id=cand_id, gates={"min_samples": 1000})
        for i in range(20):
            assert request(port, "POST", "/queries.json", {"user": f"u{i}", "num": 8})[0] == 200
        srv.rollout.drain_shadow()
        text = request(port, "GET", "/metrics")[1]
        lines = {ln.split(" ")[0]: float(ln.split(" ")[1]) for ln in text.splitlines()
                 if ln.startswith("pio_quality_score_psi{")}
        assert set(lines) == {'pio_quality_score_psi{variant="baseline"}',
                              'pio_quality_score_psi{variant="candidate"}'}
        assert all(v >= 0 for v in lines.values())
        summary = request(port, "GET", "/status.json")[1]["quality"]
        assert summary["pinned"] and summary["samples"]["candidate"] == 160
        # the health plane's drift objective reads the live gauge
        srv.health.tick()
        drift = [o for o in request(port, "GET", "/health.json")[1]["objectives"]
                 if o["name"] == "drift"]
        assert drift and not drift[0]["abstaining"]
    finally:
        close_server(srv)


def test_the_event_servers_ingest_quality(tmp_path, monkeypatch):
    from predictionio_tpu_torch.api.event_server import EventServerConfig, create_event_server
    from predictionio_tpu_torch.storage import EventFilter, StorageRegistry
    from predictionio_tpu_torch.storage.metadata import AccessKey, App
    from predictionio_tpu_torch.tools import quality as quality_tool

    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "events")})
    md = registry.get_metadata()
    app = md.app_insert(App(id=0, name="q"))
    md.access_key_insert(AccessKey(key="k", appid=app))
    registry.get_events().init(app)
    qdir = tmp_path / "qdir"
    monkeypatch.setenv("PIO_QUALITY_DIR", str(qdir))
    srv = create_event_server(EventServerConfig(ip="127.0.0.1", port=0), registry=registry,
                              block=False)
    try:
        port = srv.bound_port
        path = "/events.json?accessKey=k"

        def ev(name, i, props=None):
            out = {"event": name, "entityType": "user", "entityId": f"u{i}"}
            if props is not None:
                out["properties"] = props
            return out

        assert request(port, "POST", path, ev("rate", 1, {"rating": 42}))[0] == 201
        assert request(port, "POST", path, ev("rate", 2, {}))[0] == 201
        assert request(port, "POST", path, {"event": "rate"})[0] == 400
        # a store failure: no accounting for an event that was never kept
        real_insert = srv.events.insert
        monkeypatch.setattr(srv.events, "insert",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("disk")))
        assert request(port, "POST", path, ev("view", 3))[0] == 500
        monkeypatch.setattr(srv.events, "insert", real_insert)
        # a baseline mix pins at 200 events, then a skewed batch drifts it
        batch = [ev("view", i) for i in range(150)] + [
            ev("rate", i, {"rating": 4}) for i in range(48)]
        assert all(r["status"] == 201 for r in request(
            port, "POST", "/batches/events.json?accessKey=k", batch)[1])
        assert srv.quality.summary()[str(app)]["baselinePinned"]
        assert (qdir / f"ingest_baseline_{app}.json").exists()
        assert srv.quality.mix_psi(app) < 0.1
        skewed = [ev("buy", i) for i in range(300)]
        request(port, "POST", "/batches/events.json?accessKey=k", skewed)
        report = quality_tool.node_report(f"127.0.0.1:{port}")
        ingest = report["ingest"][str(app)]
        assert ingest["events"] == 2 + 198 + 300
        assert ingest["violations"] == {"range": 1, "poison": 1, "schema": 1}
        assert ingest["mixPsi"] > 0.25
        stored = list(registry.get_events().find(app, EventFilter(limit=-1)))
        assert len(stored) == ingest["events"]
    finally:
        close_server(srv)
