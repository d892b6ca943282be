"""ALS training of the port (``predictionio_tpu_torch/ops/als.py``) held
against the JAX package's (``predictionio_tpu/ops/als.py``) on the CPU.

Bucketing is bit-identical. Training starts both packages from the JAX
``init_factors`` table (``jax.random`` cannot be reproduced by a
``torch.Generator``) on ``tests/test_als.py``'s sweep data (rank 12, 3
iterations, λ 0.05, seed 2), and the port is held to the tolerance the
JAX package holds its own solve modes to: factors rtol 2e-3 / atol 2e-4,
training RMSE within 1e-3. The port runs the plain versions of its two
kernels here; ``chip_smoke.py`` holds the CUDA kernels against them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.cuda_kernels import (
    gramian_fused,
    gramian_fused_reference,
    spd_solve,
    spd_solve_reference,
)

RANK, ITERS, LAM, SEED = 12, 3, 0.05, 2
RTOL, ATOL, RMSE_TOL = 2e-3, 2e-4, 1e-3


def _sweep_data():
    """``tests/test_als.py::_sweep_data``: power-law users, uniform items,
    integer ratings 1..5."""
    rng = np.random.default_rng(7)
    nnz, n_u, n_i = 30_000, 900, 250
    w = 1.0 / np.arange(1, n_u + 1) ** 0.8
    u = rng.choice(n_u, size=nnz, p=w / w.sum()).astype(np.int32)
    i = rng.integers(0, n_i, nnz).astype(np.int32)
    v = rng.integers(1, 6, nnz).astype(np.float32)
    return u, i, v, n_u, n_i


def numpy_als_step(y, users, items, ratings, n_users, lam, rank):
    """``tests/test_als.py::numpy_als_step``: one user-side update with
    weighted-λ."""
    x = np.zeros((n_users, rank))
    for u in range(n_users):
        sel = users == u
        if not sel.any():
            continue
        yu = y[items[sel]]
        ru = ratings[sel]
        n_u = sel.sum()
        a = yu.T @ yu + lam * n_u * np.eye(rank)
        x[u] = np.linalg.solve(a, yu.T @ ru)
    return x


def _assert_buckets_identical(got, want):
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols, want.nnz)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        for field in ("rows", "idx", "val", "counts"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("pad_to_blocks", [False, True])
def test_bucketize_is_bit_identical_to_the_jax_numpy_path(pad_to_blocks):
    u, i, v, n_u, n_i = _sweep_data()
    # one row past the widest bucket: truncated to its first ratings in
    # input order
    u = np.concatenate([u, np.full(40, 3, np.int32)])
    i = np.concatenate([i, np.arange(40, dtype=np.int32) % n_i])
    v = np.concatenate([v, np.arange(40, dtype=np.float32)])
    widths = (8, 32, 64)
    for rows, cols, nr, nc in ((u, i, n_u, n_i), (i, u, n_i, n_u)):
        got = als.bucketize(rows, cols, v, nr, nc, widths, pad_to_blocks)
        want = jax_als._bucketize_numpy(
            rows.astype(np.int32), cols.astype(np.int32), v, nr, nc, widths,
            pad_to_blocks,
        )
        _assert_buckets_identical(got, want)
    top = max(got.buckets, key=lambda b: b.width)
    assert top.counts.max() == 64  # the truncated row


def test_bucketize_with_int32_columns_matches():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 50, 2000).astype(np.int32)
    cols = rng.integers(0, 70_000, 2000).astype(np.int32)
    vals = rng.standard_normal(2000).astype(np.float32)
    got = als.bucketize(rows, cols, vals, 50, 70_000, pad_to_blocks=True)
    want = jax_als._bucketize_numpy(rows, cols, vals, 50, 70_000,
                                    jax_als.DEFAULT_BUCKET_WIDTHS, True)
    _assert_buckets_identical(got, want)
    assert got.buckets[0].idx.dtype == np.int32


def test_sort_bucket_indices_is_bit_identical():
    u, i, v, n_u, n_i = _sweep_data()
    got = als.sort_bucket_indices(als.bucketize(u, i, v, n_u, n_i, (8, 32, 64)))
    want = jax_als.sort_bucket_indices(
        jax_als._bucketize_numpy(u, i, v, n_u, n_i, (8, 32, 64), False)
    )
    _assert_buckets_identical(got, want)


def test_one_user_side_solve_matches_numpy():
    u, i, v, n_u, n_i = _sweep_data()
    rng = np.random.default_rng(0)
    y = np.abs(rng.standard_normal((n_i, RANK))).astype(np.float32)
    side = als.stage(als.bucketize(u, i, v, n_u, n_i), "cpu")
    x = als._solve_side(
        torch.from_numpy(y), side, RANK, False, LAM, 1.0, None, "f32",
        gramian_fused, spd_solve,
    ).numpy()
    want = numpy_als_step(y.astype(np.float64), u, i, v, n_u, LAM, RANK)
    np.testing.assert_allclose(x, want, rtol=1e-3, atol=1e-4)


_JAX_CACHE = {}


def _jax_factors(mode, implicit, gather):
    key = (mode, implicit, gather)
    if key not in _JAX_CACHE:
        u, i, v, n_u, n_i = _sweep_data()
        cfg = jax_als.ALSConfig(
            rank=RANK, iterations=ITERS, lambda_=LAM, implicit_prefs=implicit,
            alpha=1.0, seed=SEED, solve_mode=mode, gather_dtype=gather,
        )
        f = jax_als.als_train_coo(u, i, v, n_users=n_u, n_items=n_i, cfg=cfg)
        _JAX_CACHE[key] = (np.asarray(f.user_factors), np.asarray(f.item_factors))
    return _JAX_CACHE[key]


def _port_factors(implicit, gather, iterations=ITERS):
    u, i, v, n_u, n_i = _sweep_data()
    cfg = als.ALSConfig(rank=RANK, iterations=iterations, lambda_=LAM,
                        implicit_prefs=implicit, alpha=1.0, seed=SEED,
                        gather_dtype=gather)
    f = als.als_train_coo(
        u, i, v, n_u, n_i, cfg, device="cpu",
        init_item_factors=np.asarray(jax_als.init_factors(n_i, RANK, SEED)),
    )
    return f.user_factors.numpy(), f.item_factors.numpy()


def _rmse(factors):
    u, i, v, _, _ = _sweep_data()
    return als.rmse(als.ALSFactors(*map(torch.tensor, factors), RANK), u, i, v)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("mode", ["chunked", "pallas"])
def test_als_train_matches_the_jax_package_f32(mode, implicit):
    port = _port_factors(implicit, "f32")
    ref = _jax_factors(mode, implicit, "f32")
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port[1], ref[1], rtol=RTOL, atol=ATOL)
    assert abs(_rmse(port) - _rmse(ref)) <= RMSE_TOL


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("mode", ["chunked", "pallas"])
def test_als_train_matches_the_jax_package_bf16(mode, implicit):
    """bf16 rounds each solved table before the next side's build, so a
    float reassociation anywhere flips a few entries by a whole bf16 ulp
    (2^-8 relative) and that grows over the iterations: the JAX package's
    own "chunked" and "pallas" bf16 runs differ by 8.8e-3 at most (9.7e-4
    in relative norm) here. The first user solve, before any solved table
    is rounded, holds to rtol 2e-3 / atol 2e-4 (against "chunked"; both
    JAX modes build it alike); after 3 iterations the port stays within
    the JAX modes' own spread (relative norm 2e-3) and training RMSE
    within 1e-3."""
    u, i, v, n_u, n_i = _sweep_data()
    port = _port_factors(implicit, "bf16")
    ref = _jax_factors(mode, implicit, "bf16")
    for got, want in zip(port, ref):
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-3
    assert abs(_rmse(port) - _rmse(ref)) <= RMSE_TOL
    if mode != "chunked":
        return
    first = als.als_train_coo(
        u, i, v, n_u, n_i,
        als.ALSConfig(rank=RANK, iterations=1, lambda_=LAM, implicit_prefs=implicit,
                      seed=SEED, gather_dtype="bf16"),
        device="cpu", init_item_factors=np.asarray(jax_als.init_factors(n_i, RANK, SEED)),
    )
    jax_first = jax_als.als_train_coo(
        u, i, v, n_users=n_u, n_items=n_i,
        cfg=jax_als.ALSConfig(rank=RANK, iterations=1, lambda_=LAM, implicit_prefs=implicit,
                              seed=SEED, solve_mode="chunked", gather_dtype="bf16"),
    )
    np.testing.assert_allclose(first.user_factors.numpy(),
                               np.asarray(jax_first.user_factors), rtol=RTOL, atol=ATOL)


def test_kernel_and_plain_paths_agree_through_the_train_loop():
    """The private loop chip_smoke.py drives with the plain versions gives
    what ``als_train`` gives through the wrappers (on the CPU both run the
    plain versions, so they agree exactly)."""
    u, i, v, n_u, n_i = _sweep_data()
    cfg = als.ALSConfig(rank=6, iterations=2, lambda_=LAM, seed=1)
    ub = als.stage(als.bucketize(u, i, v, n_u, n_i), "cpu")
    ib = als.stage(als.bucketize(i, u, v, n_i, n_u), "cpu")
    y0 = als.init_factors(n_i, 6, 1, "cpu")
    wrapped = als._train_loop(ub, ib, y0, cfg, gramian_fused, spd_solve)
    plain = als._train_loop(ub, ib, y0, cfg, gramian_fused_reference, spd_solve_reference)
    for a, b in zip(wrapped, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    profile = {}
    f = als.als_train(ub, ib, cfg, init_item_factors=y0, profile=profile)
    torch.testing.assert_close(f.user_factors, wrapped[0], rtol=0, atol=0)
    assert profile["levers"]["kernels"] == "plain"
    assert len(profile["iteration_s"]) == 2
    assert profile["launches"] == [{"gramian_fused": 0, "spd_solve": 0}] * 2


def test_rows_without_ratings_get_zero_factors_and_sentinels_drop():
    u = np.array([0, 0, 2, 2, 2], np.int32)
    i = np.array([0, 1, 1, 2, 3], np.int32)
    v = np.array([5, 3, 4, 1, 2], np.float32)
    cfg = als.ALSConfig(rank=3, iterations=2, lambda_=0.1)
    f = als.als_train(
        als.bucketize(u, i, v, 4, 5, pad_to_blocks=True),
        als.bucketize(i, u, v, 5, 4, pad_to_blocks=True), cfg, device="cpu",
    )
    np.testing.assert_array_equal(f.user_factors[[1, 3]].numpy(), 0.0)
    np.testing.assert_array_equal(f.item_factors[4].numpy(), 0.0)
    assert torch.isfinite(f.user_factors).all()


def test_init_factors_is_seeded_and_device_independent():
    a = als.init_factors(30, 5, seed=4, device="cpu")
    b = als.init_factors(30, 5, seed=4, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a >= 0).all() and a.shape == (30, 5)
    assert not torch.equal(a, als.init_factors(30, 5, seed=5, device="cpu"))


def test_estimates_count_the_rank_wide_model():
    side = als.stage(als.BucketedMatrix(
        n_rows=16, n_cols=20, nnz=64,
        buckets=[als.Bucket(rows=np.arange(16, dtype=np.int32),
                            idx=np.zeros((16, 8), np.uint16),
                            val=np.zeros((16, 8), np.float32),
                            counts=np.full(16, 4, np.int32))]), "cpu")
    empty = dataclasses.replace(side, buckets=[])
    r = 8
    assert als.estimate_iteration_hbm_bytes(side, empty, r) == 16 * (
        8 * r * 4 + 8 * 12 + 2 * (r * r + r) * 4 + r * 4)
    assert als.estimate_iteration_flops(side, empty, r, False) == 16 * (
        2 * 8 * r * r + 2 * 8 * r + r**3 / 3 + 2 * r * r)


class TestResolveLevers:
    """Pure logic: a CUDA device needs no card to resolve against."""

    CUDA = torch.device("cuda")
    CPU = torch.device("cpu")

    @pytest.mark.parametrize("mode", ["auto", "pallas"])
    def test_cuda_takes_the_kernels(self, mode):
        lev = als.ALSConfig(rank=50, solve_mode=mode).resolve_levers(self.CUDA)
        assert lev == {"solve_mode": "pallas", "gather_dtype": "f32",
                       "sort_gather": True, "fused_gather": True, "kernels": "cuda"}
        staged = als.ALSConfig(fused_gather=True, gather_dtype="bf16").resolve_levers(
            self.CUDA, staged_inputs=True)
        assert staged["sort_gather"] is False and staged["gather_dtype"] == "bf16"

    @pytest.mark.parametrize("cfg,match", [
        (als.ALSConfig(solve_mode="chunked"), "library-Cholesky"),
        (als.ALSConfig(solve_mode="two_phase"), "library-Cholesky"),
        (als.ALSConfig(fused_gather=False), "fused_gather"),
        (als.ALSConfig(rank=als.KERNEL_MAX_RANK + 1), "rank"),
        (als.ALSConfig(solve_mode="bogus"), "solve_mode"),
        (als.ALSConfig(gather_dtype="f16"), "gather_dtype"),
    ])
    def test_cuda_refuses_what_would_bypass_a_kernel(self, cfg, match):
        with pytest.raises(ValueError, match=match):
            cfg.resolve_levers(self.CUDA)

    @pytest.mark.parametrize("mode,fused,want_mode,want_fused", [
        ("auto", None, "chunked", False),
        ("chunked", None, "chunked", False),
        ("two_phase", False, "two_phase", False),
        ("pallas", None, "pallas", True),
        ("pallas", False, "pallas", False),
    ])
    def test_cpu_runs_the_plain_versions_in_every_mode(self, mode, fused,
                                                       want_mode, want_fused):
        lev = als.ALSConfig(rank=200, solve_mode=mode, fused_gather=fused
                            ).resolve_levers(self.CPU)
        assert lev["kernels"] == "plain"
        assert (lev["solve_mode"], lev["fused_gather"]) == (want_mode, want_fused)

    def test_cpu_explicit_fused_needs_pallas(self):
        with pytest.raises(ValueError, match="fused_gather"):
            als.ALSConfig(fused_gather=True).resolve_levers(self.CPU)

    def test_staged_inputs_cannot_be_sorted(self):
        u, i, v, n_u, n_i = _sweep_data()
        ub = als.stage(als.bucketize(u, i, v, n_u, n_i), "cpu")
        ib = als.stage(als.bucketize(i, u, v, n_i, n_u), "cpu")
        with pytest.raises(ValueError, match="sort_gather_indices"):
            als.als_train(ub, ib, als.ALSConfig(sort_gather_indices=True))
        with pytest.raises(ValueError, match="iterations"):
            als.als_train(ub, ib, als.ALSConfig(iterations=0))
