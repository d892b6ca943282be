"""Streaming top-k: the port against the JAX kernel.

The port's ``top_k_streaming`` on CPU tensors runs its plain PyTorch
version (the CUDA kernel is held against that same version on the card by
``chip_smoke.py``); the JAX ``top_k_streaming`` runs its Pallas kernel in
interpret mode, as ``tests/test_pallas_kernels.py`` runs it. Both get the
same numpy inputs from a seed. Tolerance: scores rtol 1e-5 / atol 1e-5
(the two sum the dot products in different orders); ids equal, or the
scores at that slot tied.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import (
    top_k_for_users_streaming as jax_users_streaming,
    top_k_streaming as jax_streaming,
)
from predictionio_tpu_torch.ops.cuda_kernels import (
    TOPK_MAX_K,
    top_k_for_users_streaming,
    top_k_streaming,
)

RTOL = ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def assert_agree(port, ref):
    ps, pi = (x.numpy() for x in port)
    rs, ri = (np.asarray(x) for x in ref)
    assert ps.shape == rs.shape and pi.shape == ri.shape
    assert pi.dtype == np.int32 and ps.dtype == np.float32
    np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)
    tied = np.isclose(ps, rs, rtol=RTOL, atol=ATOL)
    assert ((pi == ri) | tied).all()
    # sentinel contract: -inf slots, and only those, carry index -1
    assert ((pi == -1) == np.isneginf(ps)).all()


@pytest.mark.parametrize(
    "b,n,r,k", [(4, 100, 16, 5), (8, 1030, 50, 10), (3, 7, 4, 3)]
)
def test_matches_jax_kernel(b, n, r, k):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, r)).astype(np.float32)
    items = rng.normal(size=(n, r)).astype(np.float32)
    assert_agree(
        top_k_streaming(_t(q), _t(items), k),
        jax_streaming(q, items, k, block_items=256),
    )


def test_exclusion_lists():
    rng = np.random.default_rng(1)
    b, n, r, k = 4, 64, 8, 6
    q = rng.normal(size=(b, r)).astype(np.float32)
    items = rng.normal(size=(n, r)).astype(np.float32)
    # exclude the unfiltered top-2 of each row, padded with -1
    _, i0 = jax_streaming(q, items, 2)
    excl = np.concatenate(
        [np.asarray(i0), np.full((b, 3), -1, np.int32)], axis=1
    ).astype(np.int32)
    got = top_k_streaming(_t(q), _t(items), k, _t(excl))
    assert_agree(got, jax_streaming(q, items, k, exclude_idx=excl))
    for row in range(b):
        assert not set(got[1][row].tolist()) & set(np.asarray(i0)[row].tolist())


def test_k_larger_than_catalog():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    items = rng.normal(size=(3, 4)).astype(np.float32)
    s, i = top_k_streaming(_t(q), _t(items), 8)
    assert s.shape == (2, 8) and i.shape == (2, 8)
    assert torch.isneginf(s[:, 3:]).all() and (i[:, 3:] == -1).all()
    assert_agree((s, i), jax_streaming(q, items, 8))


def test_user_gather_wrapper():
    rng = np.random.default_rng(3)
    uf = rng.normal(size=(20, 12)).astype(np.float32)
    itf = rng.normal(size=(200, 12)).astype(np.float32)
    uidx = np.array([3, 17, 5], dtype=np.int32)
    assert_agree(
        top_k_for_users_streaming(_t(uf), _t(itf), _t(uidx), 7),
        jax_users_streaming(uf, itf, uidx, 7, block_items=128),
    )


def test_exclusions_exhausting_the_catalog():
    """Every slot is (-inf, -1) — never a real, excluded id — when the
    exclusions leave fewer than k candidates."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    items = rng.normal(size=(5, 4)).astype(np.float32)
    excl = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    s, i = top_k_streaming(_t(q), _t(items), 3, _t(excl))
    assert torch.isneginf(s).all() and (i == -1).all()
    assert_agree((s, i), jax_streaming(q, items, 3, exclude_idx=excl))


def test_wide_exclusion_list():
    rng = np.random.default_rng(5)
    b, n, r = 2, 300, 8
    q = rng.normal(size=(b, r)).astype(np.float32)
    items = rng.normal(size=(n, r)).astype(np.float32)
    _, i0 = jax_streaming(q, items, 40, block_items=128)
    excl = np.asarray(i0, np.int32)
    got = top_k_streaming(_t(q), _t(items), 10, _t(excl))
    assert_agree(got, jax_streaming(q, items, 10, exclude_idx=excl, block_items=128))
    for row in range(b):
        assert not set(got[1][row].tolist()) & set(excl[row].tolist())


def test_ties_keep_the_lowest_index():
    """Duplicated item rows score exactly alike (small integers make every
    dot product exact in any summation order); both packages put the
    lower index first."""
    rng = np.random.default_rng(7)
    q = rng.integers(-3, 4, size=(5, 6)).astype(np.float32)
    base = rng.integers(-3, 4, size=(20, 6)).astype(np.float32)
    items = np.concatenate([base, base[::-1], base])  # each row 3 times
    s, i = top_k_streaming(_t(q), _t(items), 12)
    js, ji = jax_streaming(q, items, 12, block_items=128)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    sn, inn = s.numpy(), i.numpy()
    same = sn[:, 1:] == sn[:, :-1]
    assert same.any()  # the case really has ties
    assert (inn[:, 1:] > inn[:, :-1])[same].all()


@pytest.mark.parametrize(
    "bad",
    [
        lambda q, it: top_k_streaming(q.double(), it, 3),
        lambda q, it: top_k_streaming(q, it.T, 3),
        lambda q, it: top_k_streaming(q[:, :2], it, 3),
        lambda q, it: top_k_streaming(q, it, -1),
        lambda q, it: top_k_streaming(q, it, 3, torch.zeros((2, 1), dtype=torch.int64)),
        lambda q, it: top_k_streaming(q.numpy(), it, 3),
    ],
    ids=["float64", "non-contiguous", "rank-mismatch", "negative-k",
         "int64-exclusions", "numpy-input"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros((2, 4))
    items = torch.zeros((6, 4))
    with pytest.raises((TypeError, ValueError)):
        bad(q, items)


def test_k_above_the_kernel_ceiling_raises_on_every_device():
    q = torch.zeros((1, 2))
    items = torch.zeros((TOPK_MAX_K + 1, 2))
    with pytest.raises(ValueError, match="ceiling"):
        top_k_streaming(q, items, TOPK_MAX_K + 1)
    # clamping to the catalog happens first: k past a small N is fine
    s, _ = top_k_streaming(q, items[:5], TOPK_MAX_K + 1)
    assert s.shape == (1, TOPK_MAX_K + 1)
