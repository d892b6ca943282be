"""The unfused scoring entries of the port (``top_k_for_users``,
``top_k_similar_items``) against the JAX package's, on seeded inputs.

The JAX package scores the whole ``[B, I]`` product and takes
``lax.top_k``; the port turns a dense mask into exclusion lists and takes
the streaming kernel's path (its plain version on the CPU). Scores agree
to rtol 1e-5 (``tests/test_als.py::TestScoring``) and ids are equal
outside ties; where ``lax.top_k`` returns an excluded item's index beside
-inf, the port returns (-inf, -1).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import scoring as jax_scoring
from predictionio_tpu_torch import ops
from predictionio_tpu_torch.ops import scoring

RTOL = ATOL = 1e-5


def _check(got, want):
    """Port (scores, ids) against JAX's: -inf slots carry -1 in the port
    and -inf in both; elsewhere scores to RTOL/ATOL and ids equal unless
    the scores tie."""
    s_p, i_p = (np.asarray(t) for t in got)
    s_j, i_j = (np.asarray(t) for t in want)
    assert s_p.shape == s_j.shape and i_p.shape == i_j.shape
    inf_j = np.isneginf(s_j)
    np.testing.assert_array_equal(np.isneginf(s_p), inf_j)
    np.testing.assert_array_equal(i_p[inf_j], -1)
    np.testing.assert_allclose(s_p[~inf_j], s_j[~inf_j], rtol=RTOL, atol=ATOL)
    tied = np.isclose(s_p, s_j, rtol=RTOL, atol=ATOL) & ~inf_j
    # an id may differ only inside a tie (two equal scores swapped)
    for b, k in zip(*np.nonzero((i_p != i_j) & ~inf_j)):
        assert tied[b, k]
        row = s_j[b]
        assert np.sum(np.isclose(row, row[k], rtol=RTOL, atol=ATOL)) > 1


def _tables(seed, n_users=40, n_items=300, rank=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, rank)).astype(np.float32),
            rng.normal(size=(n_items, rank)).astype(np.float32), rng)


def test_exported_from_ops_as_the_jax_package_exports_them():
    import predictionio_tpu.ops as jax_ops

    for name in ("top_k_for_users", "top_k_similar_items", "top_k_for_vectors",
                 "top_k_for_users_fused", "top_k_fused_vectors",
                 "top_k_similar_items_fused", "standardize"):
        assert name in jax_ops.__all__ and name in ops.__all__
    assert ops.top_k_for_users is scoring.top_k_for_users
    assert ops.top_k_similar_items is scoring.top_k_similar_items


@pytest.mark.parametrize("k", [1, 10, 64])
def test_top_k_for_users_matches_jax(k):
    uf, itf, rng = _tables(0)
    idx = rng.integers(0, uf.shape[0], size=24).astype(np.int32)
    want = jax_scoring.top_k_for_users(uf, itf, idx, k)
    got = scoring.top_k_for_users(torch.from_numpy(uf), torch.from_numpy(itf),
                                  torch.from_numpy(idx), k)
    _check(got, want)


@pytest.mark.parametrize("k", [5, 300])
def test_top_k_for_users_under_an_exclusion_mask(k):
    """Random masks, one row excluding every item and one excluding none;
    at k = N every excluded slot is (-inf, -1) in the port."""
    uf, itf, rng = _tables(1)
    idx = np.arange(16, dtype=np.int32)
    mask = rng.random((16, itf.shape[0])) < 0.3
    mask[3] = True
    mask[4] = False
    want = jax_scoring.top_k_for_users(uf, itf, idx, k, exclude_mask=mask)
    got = scoring.top_k_for_users(torch.from_numpy(uf), torch.from_numpy(itf),
                                  torch.from_numpy(idx), k,
                                  exclude_mask=torch.from_numpy(mask))
    _check(got, want)
    s, i = (t.numpy() for t in got)
    assert np.all(i[3] == -1) and np.all(np.isneginf(s[3]))
    for b in range(16):  # no excluded item is ever returned
        assert not np.isin(i[b][i[b] >= 0], np.flatnonzero(mask[b])).any()


def test_k_equal_to_the_catalog_returns_every_item_once():
    uf, itf, rng = _tables(2, n_items=120)
    idx = rng.integers(0, uf.shape[0], size=8).astype(np.int32)
    want = jax_scoring.top_k_for_users(uf, itf, idx, itf.shape[0])
    got = scoring.top_k_for_users(torch.from_numpy(uf), torch.from_numpy(itf),
                                  torch.from_numpy(idx), itf.shape[0])
    _check(got, want)
    for row in got[1].numpy():
        assert sorted(row.tolist()) == list(range(itf.shape[0]))


def test_a_duplicate_heavy_batch_answers_each_duplicate_alike():
    """Serving batches name the same user many times: 64 queries over 3
    users, every duplicate's answer identical and equal to JAX's."""
    uf, itf, rng = _tables(3)
    idx = rng.choice(np.array([5, 5, 5, 17, 30], dtype=np.int32), size=64)
    want = jax_scoring.top_k_for_users(uf, itf, idx, 16)
    got = scoring.top_k_for_users(torch.from_numpy(uf), torch.from_numpy(itf),
                                  torch.from_numpy(idx), 16)
    _check(got, want)
    s, i = got
    for u in (5, 17, 30):
        rows = np.flatnonzero(idx == u)
        assert all(torch.equal(i[rows[0]], i[r]) and torch.equal(s[rows[0]], s[r])
                   for r in rows)


def test_ties_keep_the_lowest_index_first():
    """Duplicated item rows score exactly alike: the port puts the lower
    index first (the streaming kernel's contract), as ``lax.top_k``."""
    uf, itf, _ = _tables(4, n_items=50)
    itf[1::2] = itf[0::2]
    idx = np.arange(6, dtype=np.int32)
    want = jax_scoring.top_k_for_users(uf, itf, idx, 10)
    got = scoring.top_k_for_users(torch.from_numpy(uf), torch.from_numpy(itf),
                                  torch.from_numpy(idx), 10)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("k", [5, 40])
def test_top_k_similar_items_matches_jax(exclude_self, k):
    _, itf, rng = _tables(5, n_items=40)
    itf[7] = 0.0  # a zero row: its cosine is 0 everywhere (the 1e-12 floor)
    idx = rng.integers(0, itf.shape[0], size=12).astype(np.int32)
    idx[0] = 7
    want = jax_scoring.top_k_similar_items(itf, idx, k, exclude_self=exclude_self)
    got = scoring.top_k_similar_items(torch.from_numpy(itf), torch.from_numpy(idx), k,
                                      exclude_self=exclude_self)
    _check(got, want)
    s, i = (t.numpy() for t in got)
    if exclude_self:
        for b in range(len(idx)):
            assert idx[b] not in i[b]
        if k == itf.shape[0]:  # the self slot is the last one, (-inf, -1)
            assert np.all(i[:, -1] == -1) and np.all(np.isneginf(s[:, -1]))
    assert np.all(s[np.isfinite(s)] <= 1.0 + 1e-5)


def test_the_jax_test_scoring_cases_hold_in_the_port():
    """``tests/test_als.py::TestScoring`` on the port's entries."""
    rng = np.random.default_rng(0)
    uf = rng.normal(size=(10, 4)).astype(np.float32)
    itf = rng.normal(size=(25, 4)).astype(np.float32)
    scores, idx = scoring.top_k_for_users(torch.from_numpy(uf), torch.from_numpy(itf),
                                          torch.tensor([2, 5]), k=3)
    full = uf[[2, 5]] @ itf.T
    np.testing.assert_array_equal(idx.numpy(), np.argsort(-full, axis=1)[:, :3])
    np.testing.assert_allclose(scores.numpy(), np.sort(full, axis=1)[:, ::-1][:, :3],
                               rtol=1e-5)
    eye = torch.eye(3)
    mask = torch.zeros((1, 3), dtype=torch.bool)
    mask[0, 0] = True
    _, idx = scoring.top_k_for_users(eye, eye, torch.tensor([0]), k=1, exclude_mask=mask)
    assert int(idx[0, 0]) != 0
    itf = np.random.default_rng(1).normal(size=(12, 4)).astype(np.float32)
    scores, idx = scoring.top_k_similar_items(torch.from_numpy(itf), torch.tensor([3]), k=5)
    assert 3 not in idx[0].tolist()
    assert np.all(scores[0].numpy() <= 1.0 + 1e-5)
