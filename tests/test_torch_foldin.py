"""Fold-in of the port (``predictionio_tpu_torch/continuous/foldin.py``,
``ALSAlgorithm.fold_in`` and ``fold_in_partitioned``) against the JAX
package's, on the CPU.

Mirrors ``TestDecideMode``, ``TestFoldInMath`` and the ``ALSAlgorithm``
fold-in tests of ``tests/test_continuous.py`` and the fold half of its
``TestPartitionedFoldParallelism`` (without the controller, which waits
for the oplog). Parity: the same seeded COO, the same base tables and the
JAX package's ``seeded_rows`` for new entities (``jax.random`` rows cannot
be drawn here, so they pass in through ``new_rows``) go through both
packages; ``_row_systems`` gives the same arrays, and folded factors agree
within the JAX package's own spread between its solve paths (rtol 2e-3 /
atol 2e-4), untouched rows bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from predictionio_tpu.continuous import foldin as jfold
from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSAlgorithmParams as JaxParams,
    ALSModel as JaxALSModel,
    PreparedData as JaxPreparedData,
)
from predictionio_tpu.storage import BiMap as JaxBiMap
from predictionio_tpu_torch.continuous import foldin
from predictionio_tpu_torch.continuous import (
    FOLD_IN,
    FULL_RETRAIN,
    FoldInPolicy,
    decide_mode,
    fold_in_factors,
    seeded_rows,
)
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    PreparedData,
)
from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.storage import BiMap

CPU = "cpu"
RTOL, ATOL = 2e-3, 2e-4


# -- escalation policy (pure) ----------------------------------------------
class TestDecideMode:
    def test_within_policy_folds(self):
        mode, reason = decide_mode(FoldInPolicy(), total_events=1000, delta_events=50,
                                   known_entities=200, new_entities=10)
        assert mode == FOLD_IN
        assert "within fold-in policy" in reason

    def test_delta_fraction_escalates(self):
        mode, reason = decide_mode(FoldInPolicy(max_delta_fraction=0.1), total_events=100,
                                   delta_events=50, known_entities=200, new_entities=0)
        assert mode == FULL_RETRAIN
        assert "delta fraction" in reason

    def test_new_entity_fraction_escalates(self):
        mode, reason = decide_mode(FoldInPolicy(max_new_entity_fraction=0.1),
                                   total_events=1000, delta_events=10,
                                   known_entities=100, new_entities=50)
        assert mode == FULL_RETRAIN
        assert "new-entity fraction" in reason

    def test_unavailable_or_empty_baseline_escalates(self):
        assert decide_mode(FoldInPolicy(), total_events=10, delta_events=1,
                           known_entities=10, new_entities=0,
                           fold_in_available=False)[0] == FULL_RETRAIN
        assert decide_mode(FoldInPolicy(), total_events=0, delta_events=1,
                           known_entities=0, new_entities=1)[0] == FULL_RETRAIN

    @pytest.mark.parametrize("case", [
        dict(total_events=1000, delta_events=50, known_entities=200, new_entities=10),
        dict(total_events=100, delta_events=50, known_entities=200, new_entities=0),
        dict(total_events=1000, delta_events=10, known_entities=100, new_entities=50),
        dict(total_events=0, delta_events=1, known_entities=0, new_entities=1),
    ])
    def test_same_verdict_and_reason_as_the_jax_package(self, case):
        policy = dict(max_delta_fraction=0.15, max_new_entity_fraction=0.3)
        assert decide_mode(FoldInPolicy(**policy), **case) == \
            jfold.decide_mode(jfold.FoldInPolicy(**policy), **case)

    def test_policy_refuses_zero_iterations(self):
        with pytest.raises(ValueError, match="fold_iterations"):
            FoldInPolicy(fold_iterations=0)


# -- fold-in math ------------------------------------------------------------
def _synth_matrix(seed=0, n_u=60, n_i=40, rank=6, nnz=3000):
    rng = np.random.default_rng(seed)
    gu = rng.normal(size=(n_u, rank)).astype(np.float32)
    gi = rng.normal(size=(n_i, rank)).astype(np.float32)
    u = rng.integers(0, n_u, nnz).astype(np.int32)
    i = rng.integers(0, n_i, nnz).astype(np.int32)
    v = (gu[u] * gi[i]).sum(-1).astype(np.float32)
    return u, i, v, n_u, n_i, rank


def _jax_seeded(n_new, rank, seed, offset):
    return np.asarray(jfold.seeded_rows(n_new, rank, seed, offset))


class TestFoldInMath:
    #: documented tolerance: fold-in RMSE on the full matrix stays within
    #: 1.25x the full-retrain RMSE
    RMSE_RATIO = 1.25

    def test_heldout_users_converge_to_full_retrain(self):
        from predictionio_tpu_torch.ops.als import ALSConfig, ALSFactors, als_train_coo, rmse

        u, i, v, n_u, n_i, rank = _synth_matrix()
        held = u >= n_u - 10
        cfg = ALSConfig(rank=rank, iterations=8, lambda_=0.05, seed=0)
        base = als_train_coo(u[~held], i[~held], v[~held], n_u - 10, n_i, cfg, device=CPU)
        full = als_train_coo(u, i, v, n_u, n_i, cfg, device=CPU)
        uf = np.concatenate([base.user_factors.numpy(),
                             seeded_rows(10, rank, 0, offset=n_u - 10)])
        itf = base.item_factors.numpy()
        changed_u = list(range(n_u - 10, n_u))
        changed_i = sorted(set(i[held].tolist()))
        uf2, itf2, counts = fold_in_factors(uf, itf, u, i, v, changed_u, changed_i,
                                            lambda_=0.05, policy=FoldInPolicy(fold_iterations=2),
                                            device=CPU)
        assert counts["solved_users"] == 10
        r_full = rmse(full, u, i, v)
        r_fold = rmse(ALSFactors(torch.from_numpy(uf2), torch.from_numpy(itf2), rank), u, i, v)
        assert r_fold <= r_full * self.RMSE_RATIO + 0.05
        untouched = np.setdiff1d(np.arange(n_u - 10), changed_u)
        np.testing.assert_array_equal(uf2[untouched], uf[untouched])

    def test_zero_delta_is_identity(self):
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=3, nnz=800)
        uf = np.random.default_rng(1).normal(size=(n_u, rank)).astype(np.float32)
        itf = np.random.default_rng(2).normal(size=(n_i, rank)).astype(np.float32)
        uf2, itf2, counts = fold_in_factors(uf, itf, u, i, v, [], [], lambda_=0.05, device=CPU)
        np.testing.assert_array_equal(uf2, uf)
        np.testing.assert_array_equal(itf2, itf)
        assert counts == {"solved_users": 0, "solved_items": 0}
        assert uf2 is not uf and itf2 is not itf  # fresh arrays

    @pytest.mark.parametrize("iterations,width", [(1, 2048), (2, 2048), (2, 16)])
    def test_fold_in_factors_matches_the_jax_package(self, iterations, width):
        """Same inputs, same changed rows: the port's kernel-path fold
        (plain versions on the CPU) against the JAX einsum + cho_solve,
        held at rtol 2e-3 / atol 2e-4; every untouched row bit for bit. A
        width of 16 truncates the busy rows to their newest ratings in
        both."""
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=4)
        rng = np.random.default_rng(9)
        uf = rng.normal(size=(n_u, rank)).astype(np.float32)
        itf = rng.normal(size=(n_i, rank)).astype(np.float32)
        cu = sorted(rng.choice(n_u, 12, replace=False).tolist())
        ci = sorted(rng.choice(n_i, 9, replace=False).tolist())
        policy = dict(fold_iterations=iterations, max_row_width=width)
        uf2, itf2, counts = fold_in_factors(uf, itf, u, i, v, cu, ci, 0.05,
                                            FoldInPolicy(**policy), device=CPU)
        juf, jitf, jcounts = jfold.fold_in_factors(uf, itf, u, i, v, cu, ci, 0.05,
                                                   jfold.FoldInPolicy(**policy))
        assert counts == jcounts
        np.testing.assert_allclose(uf2, np.asarray(juf), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(itf2, np.asarray(jitf), rtol=RTOL, atol=ATOL)
        keep_u = np.setdiff1d(np.arange(n_u), cu)
        keep_i = np.setdiff1d(np.arange(n_i), ci)
        np.testing.assert_array_equal(uf2[keep_u], uf[keep_u])
        np.testing.assert_array_equal(itf2[keep_i], itf[keep_i])

    @pytest.mark.parametrize("width", [8, 2048])
    def test_row_systems_equal_the_jax_package(self, width):
        u, i, v, n_u, n_i, _ = _synth_matrix(seed=6, nnz=1500)
        rows = np.array([0, 3, 7, 7, 59, 61], dtype=np.int32)[[0, 1, 2, 4, 5]]
        rows = np.unique(np.append(rows, 200))  # a row with no rating is dropped
        mine = foldin._row_systems(u, i, v, rows, width)
        theirs = jfold._row_systems(u, i, v, rows, width)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        assert foldin._row_systems(u, i, v, np.array([500], dtype=np.int32), width) is None

    def test_solve_rows_matches_the_jax_package(self):
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=7)
        itf = np.random.default_rng(3).normal(size=(n_i, rank)).astype(np.float32)
        rows, idx, val, mask = foldin._row_systems(u, i, v, np.arange(20, dtype=np.int32), 64)
        got = foldin.solve_rows(torch.from_numpy(itf), torch.from_numpy(idx),
                                torch.from_numpy(val), torch.from_numpy(mask), 0.05, rank)
        import jax.numpy as jnp

        want = np.asarray(jfold.solve_rows(jnp.asarray(itf), jnp.asarray(idx), jnp.asarray(val),
                                           jnp.asarray(mask), jnp.float32(0.05), rank))
        n = len(rows)
        np.testing.assert_allclose(got[:n].numpy(), want[:n], rtol=RTOL, atol=ATOL)
        # the padding rows are zero systems: exact zeros here (the JAX
        # package slices them off)
        assert torch.count_nonzero(got[n:]) == 0
        with pytest.raises(ValueError, match="rank"):
            foldin.solve_rows(torch.from_numpy(itf), torch.from_numpy(idx),
                              torch.from_numpy(val), torch.from_numpy(mask), 0.05, rank + 1)

    def test_solve_rows_takes_the_kernel_wrappers(self, monkeypatch):
        """One build and one solve a bucket through the wrappers that
        launch kernels 3 and 2 on a CUDA device."""
        calls = []
        monkeypatch.setattr(foldin, "gramian_fused",
                            lambda *a, **k: calls.append("build")
                            or cuda_kernels.gramian_fused(*a, **k))
        monkeypatch.setattr(foldin, "spd_solve",
                            lambda *a, **k: calls.append("solve")
                            or cuda_kernels.spd_solve(*a, **k))
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=8)
        uf = np.random.default_rng(1).normal(size=(n_u, rank)).astype(np.float32)
        itf = np.random.default_rng(2).normal(size=(n_i, rank)).astype(np.float32)
        fold_in_factors(uf, itf, u, i, v, [1, 2], [3], 0.05,
                        FoldInPolicy(fold_iterations=3), device=CPU)
        assert calls == ["build", "solve"] * 6  # two sides, three iterations

    def test_seeded_rows_shape_and_distribution(self):
        rows = seeded_rows(500, 6, seed=3, offset=10)
        assert rows.shape == (500, 6) and rows.dtype == np.float32
        assert (rows >= 0).all()
        assert abs(rows.mean() - np.sqrt(2 / np.pi) / np.sqrt(6)) < 0.02
        np.testing.assert_array_equal(rows, seeded_rows(500, 6, seed=3, offset=10))
        assert not np.array_equal(rows, seeded_rows(500, 6, seed=3, offset=11))
        assert seeded_rows(0, 6, 3, 10).shape == (0, 6)

    def test_extend_bimap_indexing_equals_the_jax_package(self):
        known = {"a": 0, "b": 1}
        incoming = ["c", "a", "d", "c", "b"]
        assert foldin.extend_bimap_indexing(known, incoming) == \
            jfold.extend_bimap_indexing(known, incoming) == ({"a": 0, "b": 1, "c": 2, "d": 3}, 2)

    def test_stats_json_equals_the_jax_package(self):
        args = dict(folded_users=3, folded_items=4, new_users=1, new_items=0,
                    rmse_before=0.5, rmse_after=0.55)
        mine, theirs = foldin.FoldInStats(**args), jfold.FoldInStats(**args)
        assert mine.to_json() == theirs.to_json()
        assert mine.rmse_drift == pytest.approx(0.1)
        assert foldin.FoldInStats(**{**args, "rmse_before": 0.0}).rmse_drift == 0.0


# -- ALSAlgorithm.fold_in ------------------------------------------------------
def _models(n_u, n_i, rank, seed=0):
    user_map = {f"u{k}": k for k in range(n_u)}
    item_map = {f"i{k}": k for k in range(n_i)}
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(n_u, rank)).astype(np.float32)
    itf = rng.normal(size=(n_i, rank)).astype(np.float32)
    return (ALSModel(rank=rank, user_factors=uf, item_factors=itf,
                     user_map=BiMap(user_map), item_map=BiMap(item_map)),
            JaxALSModel(rank=rank, user_factors=uf, item_factors=itf,
                        user_map=JaxBiMap(user_map), item_map=JaxBiMap(item_map)))


def _pds(users, items, u, i, v):
    return (PreparedData(user_map=BiMap(users), item_map=BiMap(items), users=u, items=i,
                         ratings=v),
            JaxPreparedData(user_map=JaxBiMap(users), item_map=JaxBiMap(items), users=u,
                            items=i, ratings=v))


class TestAlgorithmFoldIn:
    def test_als_algorithm_fold_in_zero_events_identical_factors(self):
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=5, n_u=12, n_i=8, nnz=200)
        model, _ = _models(n_u, n_i, rank)
        pd, _ = _pds(model.user_map.to_dict(), model.item_map.to_dict(), u, i, v)
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank), device=CPU)
        folded, stats = algo.fold_in(None, model, pd, [], [])
        np.testing.assert_array_equal(folded.user_factors, model.user_factors)
        np.testing.assert_array_equal(folded.item_factors, model.item_factors)
        assert folded.user_map == model.user_map
        assert stats.new_users == 0 and stats.new_items == 0
        assert stats.rmse_before == stats.rmse_after

    def test_implicit_prefs_model_cannot_fold_in(self):
        implicit = ALSAlgorithm(ALSAlgorithmParams(implicit_prefs=True), device=CPU)
        assert implicit.fold_in_supported is False
        assert ALSAlgorithm(ALSAlgorithmParams(), device=CPU).fold_in_supported is True
        model, _ = _models(1, 1, 4)
        pd, _ = _pds({"u0": 0}, {"i0": 0}, np.array([0], np.int32), np.array([0], np.int32),
                     np.array([1.0], np.float32))
        with pytest.raises(ValueError, match="implicit"):
            implicit.fold_in(None, model, pd, [], [])
        with pytest.raises(ValueError, match="implicit"):
            implicit.fold_in_partitioned(None, model, pd, {0: ([], [])})

    def test_fold_in_new_entities_extend_maps_stably(self):
        rank = 4
        model, _ = _models(5, 4, rank)
        pd, _ = _pds({"u3": 0, "u0": 1, "u9": 2}, {"i1": 0, "i0": 1},
                     np.array([0, 1, 2, 2], dtype=np.int32),
                     np.array([0, 1, 0, 1], dtype=np.int32),
                     np.array([5, 4, 3, 2], dtype=np.float32))
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank), device=CPU)
        folded, stats = algo.fold_in(None, model, pd, ["u9"], [])
        assert folded.user_map["u0"] == 0 and folded.user_map["u3"] == 3
        assert folded.user_map["u9"] == 5
        assert stats.new_users == 1
        np.testing.assert_array_equal(folded.user_factors[:5][[0, 1, 2, 4]],
                                      model.user_factors[[0, 1, 2, 4]])
        assert not np.array_equal(folded.user_factors[5],
                                  seeded_rows(1, rank, algo.params.seed, 5)[0])

    def test_fold_in_matches_the_jax_package_with_its_seeded_rows(self):
        """A delta with changed users, new users and new items: given the
        JAX package's seeded rows, the port's fold equals the JAX package's
        (maps identical, factors at rtol 2e-3 / atol 2e-4, the stats' RMSE
        to 1e-4), untouched rows bit for bit."""
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=10, n_u=50, n_i=30, nnz=2000)
        model, jmodel = _models(n_u - 6, n_i - 4, rank, seed=2)
        users = {f"u{k}": k for k in range(n_u)}
        items = {f"i{k}": k for k in range(n_i)}
        pd, jpd = _pds(users, items, u, i, v)
        changed_u = [f"u{k}" for k in (1, 4, 9, 20)]
        changed_i = [f"i{k}" for k in (2, 3)]
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, lambda_=0.05), device=CPU)
        jalgo = JaxALSAlgorithm(JaxParams(rank=rank, lambda_=0.05))
        folded, stats = algo.fold_in(None, model, pd, changed_u, changed_i,
                                     new_rows=_jax_seeded)
        jfolded, jstats = jalgo.fold_in(None, jmodel, jpd, changed_u, changed_i)
        assert folded.user_map.to_dict() == jfolded.user_map.to_dict()
        assert folded.item_map.to_dict() == jfolded.item_map.to_dict()
        np.testing.assert_allclose(folded.user_factors, jfolded.user_factors, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(folded.item_factors, jfolded.item_factors, rtol=RTOL, atol=ATOL)
        assert (stats.folded_users, stats.folded_items, stats.new_users, stats.new_items) == \
            (jstats.folded_users, jstats.folded_items, jstats.new_users, jstats.new_items)
        assert stats.rmse_before == pytest.approx(jstats.rmse_before, abs=1e-4)
        assert stats.rmse_after == pytest.approx(jstats.rmse_after, abs=1e-4)
        keep = [k for k in range(n_u - 6) if f"u{k}" not in changed_u]
        np.testing.assert_array_equal(folded.user_factors[keep], model.user_factors[keep])

    def test_fold_in_regates_a_quantized_model(self):
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=11, n_u=30, n_i=20, nnz=600)
        model, _ = _models(n_u, n_i, rank)
        pd, _ = _pds(model.user_map.to_dict(), model.item_map.to_dict(), u, i, v)
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, quantized_serving=True,
                                               quant_gate_min_match=0.0), device=CPU)
        algo._attach_quant(model)
        first = algo._quant
        folded, _ = algo.fold_in(None, model, pd, ["u1"], ["i2"])
        assert algo._quant is not first and algo._quant_model_ref() is folded
        assert algo.quant_status["dtype"] == "int8"


# -- partitioned folds (the fold half of TestPartitionedFoldParallelism) ------
class TestPartitionedFold:
    def _setup(self, seed=12):
        u, i, v, n_u, n_i, rank = _synth_matrix(seed=seed, n_u=40, n_i=24, nnz=1600)
        model, jmodel = _models(n_u - 4, n_i - 2, rank, seed=3)
        pd, jpd = _pds({f"u{k}": k for k in range(n_u)}, {f"i{k}": k for k in range(n_i)},
                       u, i, v)
        parts = {0: (["u0", "u2", "u36"], ["i0", "i1"]),
                 1: (["u1", "u3", "u37"], ["i0", "i2", "i22"])}
        return model, jmodel, pd, jpd, parts, rank

    def test_partitions_fold_concurrently_and_both_commit(self):
        model, _, pd, _, parts, rank = self._setup()
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, lambda_=0.05), device=CPU)
        merged, stats, completed = algo.fold_in_partitioned(None, model, pd, parts)
        assert completed == [0, 1]
        # the merge equals each partition's own fold over the same base,
        # the items that both name from the last partition
        base = algo._fold_base(model, pd)
        uf, itf = base["uf"].copy(), base["itf"].copy()
        orphans_u = set(range(36, 40)) - {36, 37}
        orphans_i = set(range(22, 24)) - {22}
        for p in (0, 1):
            cu = sorted({base["comb_u"][x] for x in parts[p][0]} | orphans_u)
            ci = sorted({base["comb_i"][x] for x in parts[p][1]} | orphans_i)
            uf_p, itf_p, _ = fold_in_factors(base["uf"], base["itf"], base["users"],
                                             base["items"], pd.ratings, cu, ci, 0.05,
                                             device=CPU)
            uf[cu], itf[ci] = uf_p[cu], itf_p[ci]
        np.testing.assert_array_equal(merged.user_factors, uf)
        np.testing.assert_array_equal(merged.item_factors, itf)
        assert stats.new_users == 4 and stats.new_items == 2

    def test_partitioned_fold_matches_the_jax_package(self):
        model, jmodel, pd, jpd, parts, rank = self._setup(seed=13)
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, lambda_=0.05), device=CPU)
        jalgo = JaxALSAlgorithm(JaxParams(rank=rank, lambda_=0.05))
        merged, stats, completed = algo.fold_in_partitioned(None, model, pd, parts,
                                                            new_rows=_jax_seeded)
        jmerged, jstats, jcompleted = jalgo.fold_in_partitioned(None, jmodel, jpd, parts)
        assert completed == jcompleted == [0, 1]
        np.testing.assert_allclose(merged.user_factors, jmerged.user_factors, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(merged.item_factors, jmerged.item_factors, rtol=RTOL, atol=ATOL)
        assert (stats.folded_users, stats.folded_items) == \
            (jstats.folded_users, jstats.folded_items)

    def test_slow_partition_skipped_never_blocks_commit(self, monkeypatch):
        model, _, pd, _, parts, rank = self._setup()
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, lambda_=0.05), device=CPU)
        slow_row = model.user_map["u0"]
        orig = foldin.fold_in_factors

        def slow_p0(uf, itf, u, i, r, cu, ci, lam, policy=None, device=None):
            if slow_row in cu:  # partition 0 owns u0
                time.sleep(2.0)
            return orig(uf, itf, u, i, r, cu, ci, lam, policy=policy, device=device)

        monkeypatch.setattr(foldin, "fold_in_factors", slow_p0)
        merged, _, completed = algo.fold_in_partitioned(None, model, pd, parts,
                                                        timeout_s=0.5)
        assert completed == [1]
        # partition 0's rows were not merged: its users keep their base rows
        np.testing.assert_array_equal(merged.user_factors[[0, 2]], model.user_factors[[0, 2]])
        assert not np.array_equal(merged.user_factors[1], model.user_factors[1])

    def test_failing_partition_is_skipped_and_none_completing_raises(self, monkeypatch):
        model, _, pd, _, parts, rank = self._setup()
        algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, lambda_=0.05), device=CPU)
        orig = foldin.fold_in_factors
        failing = {"u1": model.user_map["u1"]}

        def fail_p1(uf, itf, u, i, r, cu, ci, lam, policy=None, device=None):
            if failing and failing["u1"] in cu:
                raise RuntimeError("partition 1 broke")
            return orig(uf, itf, u, i, r, cu, ci, lam, policy=policy, device=device)

        monkeypatch.setattr(foldin, "fold_in_factors", fail_p1)
        _, _, completed = algo.fold_in_partitioned(None, model, pd, parts)
        assert completed == [0]
        monkeypatch.setattr(foldin, "fold_in_factors",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("all broke")))
        with pytest.raises(RuntimeError, match="no partition fold completed"):
            algo.fold_in_partitioned(None, model, pd, parts)
