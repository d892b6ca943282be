"""The ALS kernels of the port, held against the JAX package's.

``gramian_fused`` (fused gather + Gramian) and ``spd_solve_t`` /
``spd_solve`` (batched SPD solve) run here on CPU tensors, so their
plain PyTorch versions run; the JAX kernels run in interpret mode, as
``tests/test_pallas_kernels.py`` runs them. The same numpy inputs go to
both. Tolerances are the JAX tests': the build to rtol/atol 1e-4, the
solve to relative error < 1e-4 against ``np.linalg.solve``. The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import gramian_fused as jax_gramian_fused
from predictionio_tpu.ops.pallas_kernels import spd_solve_t as jax_spd_solve_t
from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    GRAMIAN_MAX_RANK,
    SPD_MAX_N,
    gramian_fused,
    gramian_fused_reference,
    spd_solve,
    spd_solve_t,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _gram_data(b, k, n, r, seed=0, frac_valid=0.7):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, r), dtype=np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    w2 = (rng.random((b, k)) < frac_valid).astype(np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32) * w2
    ridge = rng.random(b).astype(np.float32)
    return y, idx, w2, rhs, ridge


def _einsum_ref(y, idx, w2, rhs, ridge, yty=None):
    g = np.asarray(y, np.float32)[idx]
    a = np.einsum("bkr,bk,bks->brs", g, w2, g)
    a += ridge[:, None, None] * np.eye(y.shape[1], dtype=np.float32)
    if yty is not None:
        a += yty[None]
    return a, np.einsum("bkr,bk->br", g, rhs)


def _port_gramian(y, idx, w2, rhs, ridge, yty=None, y_dtype=torch.float32):
    out = gramian_fused(
        torch.from_numpy(y).to(y_dtype), torch.from_numpy(idx),
        torch.from_numpy(w2), torch.from_numpy(rhs), torch.from_numpy(ridge),
        None if yty is None else torch.from_numpy(yty),
    )
    return tuple(t.numpy() for t in out)


def _jax_gramian(y, idx, w2, rhs, ridge, yty=None, y_dtype=jnp.float32):
    out = jax_gramian_fused(
        jnp.asarray(y, y_dtype), jnp.asarray(idx), jnp.asarray(w2),
        jnp.asarray(rhs), jnp.asarray(ridge),
        None if yty is None else jnp.asarray(yty),
    )
    return tuple(np.asarray(t) for t in out)


@pytest.mark.parametrize(
    "b,k,n,r",
    [
        (32, 16, 500, 56),
        (16, 512, 300, 56),
        (8, 1024, 200, 24),
        (25, 13, 77, 16),
        (3, 600, 50, 8),
    ],
)
def test_gramian_matches_the_jax_kernel(b, k, n, r):
    data = _gram_data(b, k, n, r)
    a, bv = _port_gramian(*data)
    a_j, b_j = _jax_gramian(*data)
    np.testing.assert_allclose(a, a_j, **TOL)
    np.testing.assert_allclose(bv, b_j, **TOL)


def test_gramian_yty_base_matches_the_jax_kernel():
    y, idx, w2, rhs, ridge = _gram_data(8, 32, 100, 16, seed=3)
    yty = (y.T @ y).astype(np.float32)
    a, bv = _port_gramian(y, idx, w2, rhs, ridge, yty)
    a_j, b_j = _jax_gramian(y, idx, w2, rhs, ridge, yty)
    np.testing.assert_allclose(a, a_j, **TOL)
    np.testing.assert_allclose(bv, b_j, **TOL)


def test_gramian_bf16_table_is_upcast_like_the_jax_kernel():
    data = _gram_data(16, 64, 200, 24, seed=4)
    a, bv = _port_gramian(*data, y_dtype=torch.bfloat16)
    a_j, b_j = _jax_gramian(*data, y_dtype=jnp.bfloat16)
    assert a.dtype == np.float32
    np.testing.assert_allclose(a, a_j, **TOL)
    np.testing.assert_allclose(bv, b_j, **TOL)
    # and the rounding is the table's alone: w2/rhs stay f32
    y_r = np.asarray(jnp.asarray(data[0], jnp.bfloat16), np.float32)
    a_ref, b_ref = _einsum_ref(y_r, *data[1:])
    np.testing.assert_allclose(a, a_ref, **TOL)
    np.testing.assert_allclose(bv, b_ref, **TOL)


def test_gramian_zero_weight_rows_give_an_exactly_zero_system():
    y, idx, w2, rhs, ridge = _gram_data(8, 16, 50, 8, seed=5)
    w2[4:] = 0.0
    rhs[4:] = 0.0
    ridge[4:] = 0.0
    y[idx[4:]] = np.inf  # padding slots never read their rows' values
    a, bv = _port_gramian(y, idx, w2, rhs, ridge)
    np.testing.assert_array_equal(a[4:], 0.0)
    np.testing.assert_array_equal(bv[4:], 0.0)
    y2, *_ = _gram_data(8, 16, 50, 8, seed=5)
    a_j, b_j = _jax_gramian(y2, idx, w2, rhs, ridge)
    np.testing.assert_array_equal(a_j[4:], 0.0)


def test_gramian_wide_k_with_yty_matches_the_jax_kernel():
    """K = 80 with the YtY base: the JAX kernel tiles it (and splits K
    past its SMEM bound); the port takes any K whole."""
    y, idx, w2, rhs, ridge = _gram_data(6, 80, 60, 16, seed=6)
    yty = (y.T @ y).astype(np.float32)
    a, bv = _port_gramian(y, idx, w2, rhs, ridge, yty)
    a_j, b_j = _jax_gramian(y, idx, w2, rhs, ridge, yty)
    np.testing.assert_allclose(a, a_j, **TOL)
    np.testing.assert_allclose(bv, b_j, **TOL)


@pytest.mark.parametrize("r", [7, 50])
def test_gramian_unpadded_rank_matches_einsum(r):
    """Ranks the JAX kernel refuses (R % 8 != 0) run unpadded here."""
    data = _gram_data(20, 40, 120, r, seed=r)
    y, idx, w2, rhs, ridge = data
    yty = (y.T @ y).astype(np.float32)
    a, bv = _port_gramian(*data, yty)
    a_ref, b_ref = _einsum_ref(*data, yty)
    np.testing.assert_allclose(a, a_ref, **TOL)
    np.testing.assert_allclose(bv, b_ref, **TOL)
    np.testing.assert_array_equal(a, np.transpose(a, (0, 2, 1)))


def test_gramian_reference_chunks_match_one_block(monkeypatch):
    data = _gram_data(9, 24, 40, 5, seed=8)
    whole = _port_gramian(*data)
    monkeypatch.setattr(cuda_kernels, "_PLAIN_GATHER_FLOATS", 24 * 5 * 2)
    chunked = _port_gramian(*data)
    for got, want in zip(chunked, whole):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r", [GRAMIAN_MAX_RANK + 8, 200])
def test_gramian_rank_above_the_tuned_path_is_answered_like_jax(r):
    """Above the tuned path's 128 the build answers (the general-rank path
    on the card; here its plain version) as the JAX kernel does."""
    data = _gram_data(6, 40, 60, r, seed=r)
    got = _port_gramian(*data)
    want = _jax_gramian(*data)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(got[0], np.transpose(got[0], (0, 2, 1)))
    with pytest.raises(ValueError, match="ceiling"):
        gramian_fused(torch.zeros(4, cuda_kernels.GRAMIAN_WIDE_MAX_RANK + 1, device="meta"),
                      *(torch.zeros(2, 3, dtype=t, device="meta")
                        for t in (torch.int32, torch.float32, torch.float32)),
                      torch.zeros(2, device="meta"))
    with pytest.raises(TypeError, match="idx"):
        gramian_fused(torch.zeros(4, 3), torch.zeros(2, 3), torch.zeros(2, 3),
                      torch.zeros(2, 3), torch.zeros(2))


def _spd_systems(bsz, r, k, seed=0, lam=0.05):
    """tests/test_pallas_kernels.py's SPD systems (ALS-like: Gramian plus
    a ridge λ·k)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((bsz, k, r)).astype(np.float32)
    a = np.einsum("bkr,bks->brs", g, g) + lam * k * np.eye(r, dtype=np.float32)
    b = rng.standard_normal((bsz, r)).astype(np.float32)
    return a, b


def _to_t(a, b, n):
    bsz, r = b.shape
    a_t = np.zeros((n, n, bsz), np.float32)
    a_t[:r, :r] = np.transpose(a, (1, 2, 0))
    b_t = np.zeros((n, bsz), np.float32)
    b_t[:r] = b.T
    return a_t, b_t


def _rel_err(x, ref):
    return np.max(np.linalg.norm(x - ref, axis=-1)
                  / (np.linalg.norm(ref, axis=-1) + 1e-9))


@pytest.mark.parametrize("r,n", [(4, 8), (50, 56), (13, 16)])
def test_spd_solve_t_matches_the_jax_kernel_and_numpy(r, n):
    a, b = _spd_systems(128, r, k=32)
    ref = np.linalg.solve(a, b[..., None])[..., 0]
    a_t, b_t = _to_t(a, b, n)
    x_t = spd_solve_t(torch.from_numpy(a_t), torch.from_numpy(b_t)).numpy()
    x_j = np.asarray(jax_spd_solve_t(jnp.asarray(a_t), jnp.asarray(b_t)))
    assert _rel_err(x_t[:r].T, ref) < 1e-4
    assert _rel_err(x_t[:r].T, x_j[:r].T) < 1e-4
    np.testing.assert_array_equal(x_t[r:], 0.0)  # zero padding solves to 0


def test_spd_zero_systems_solve_to_exact_zeros():
    a, b = _spd_systems(64, 8, k=16)
    a_t, b_t = _to_t(a, b, 8)
    a_t = np.pad(a_t, ((0, 0), (0, 0), (0, 64)))
    b_t = np.pad(b_t, ((0, 0), (0, 64)), constant_values=1.0)
    x = spd_solve_t(torch.from_numpy(a_t), torch.from_numpy(b_t)).numpy()
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[:, 64:], 0.0)
    x_j = np.asarray(jax_spd_solve_t(jnp.asarray(a_t), jnp.asarray(b_t)))
    np.testing.assert_array_equal(x_j[:, 64:], 0.0)
    ref = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x[:, :64].T, ref, rtol=1e-3, atol=1e-4)


def test_spd_solve_unpadded_batch_major():
    """n = 50, B = 100: neither the JAX n % 8 nor its B % 128 rule."""
    a, b = _spd_systems(100, 50, k=64, seed=3)
    x = spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(a, b[..., None])[..., 0]
    assert _rel_err(x, ref) < 1e-4


def test_spd_singular_psd_system_gives_finite_zeroed_components():
    """Zero rows/columns inside an SPD block: the zero pivots give zero
    components and the rest solves the remaining block."""
    a, b = _spd_systems(16, 12, k=24, seed=4)
    dead = [2, 7, 11]
    a[:, dead, :] = 0.0
    a[:, :, dead] = 0.0
    x = spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.all(np.isfinite(x))
    np.testing.assert_array_equal(x[:, dead], 0.0)
    live = [i for i in range(12) if i not in dead]
    sub = a[:, live][:, :, live]
    ref = np.linalg.solve(sub, b[:, live, None])[..., 0]
    assert _rel_err(x[:, live], ref) < 1e-4


@pytest.mark.parametrize("r,n", [(SPD_MAX_N + 1, SPD_MAX_N + 8), (200, 200)])
def test_spd_solve_above_the_tuned_paths_is_answered_like_jax_and_numpy(r, n):
    """Above the tuned paths' 128 the solve answers (the wide path on the
    card; here its plain version), padding columns solving to 0."""
    a, b = _spd_systems(128, r, k=2 * r, seed=r)
    ref = np.linalg.solve(a, b[..., None])[..., 0]
    a_t, b_t = _to_t(a, b, n)
    x_t = spd_solve_t(torch.from_numpy(a_t), torch.from_numpy(b_t)).numpy()
    x_j = np.asarray(jax_spd_solve_t(jnp.asarray(a_t), jnp.asarray(b_t)))
    assert _rel_err(x_t[:r].T, ref) < 1e-4
    assert _rel_err(x_t[:r].T, x_j[:r].T) < 1e-4
    np.testing.assert_array_equal(x_t[r:], 0.0)
    with pytest.raises(ValueError, match="ceiling"):
        n_big = cuda_kernels.SPD_WIDE_MAX_N + 1
        spd_solve(torch.zeros(2, n_big, n_big, device="meta"),
                  torch.zeros(2, n_big, device="meta"))
    with pytest.raises(ValueError):
        spd_solve(torch.zeros(2, 4, 5), torch.zeros(2, 4))


def test_cpu_tensors_never_count_a_launch():
    before = (gramian_fused.launches, spd_solve.launches)
    a, b = _spd_systems(4, 3, k=5)
    spd_solve(torch.from_numpy(a), torch.from_numpy(b))
    _port_gramian(*_gram_data(3, 4, 10, 3))
    assert (gramian_fused.launches, spd_solve.launches) == before
