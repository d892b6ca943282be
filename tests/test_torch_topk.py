"""Streaming top-k: the port against the JAX kernel.

The port's ``top_k_streaming`` on CPU tensors runs its plain PyTorch
version (the CUDA kernel is held against that same version on the card by
``chip_smoke.py``); the JAX ``top_k_streaming`` runs its Pallas kernel in
interpret mode, as ``tests/test_pallas_kernels.py`` runs it. Both get the
same numpy inputs from a seed. Tolerance: scores rtol 1e-5 / atol 1e-5
(the two sum the dot products in different orders); ids equal, or the
scores at that slot tied.

Two more parts need no JAX: the kernel's launch plan
(``topk_launch_plan``), and a step-by-step numpy emulation of the
selection the CUDA kernel performs (runs of tiles with a running list
and a threshold filter, in the tiled kernel slices of its 1,024-item
steps, then the pairwise tree merge), held exactly against the plain
version.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import (
    top_k_for_users_streaming as jax_users_streaming,
    top_k_streaming as jax_streaming,
)
from predictionio_tpu.ops import scoring as jax_scoring
from predictionio_tpu_torch.ops import scoring
from predictionio_tpu_torch.ops.cuda_kernels import (
    TOPK_MAX_BATCH,
    TOPK_MAX_ITEMS,
    TOPK_MAX_K,
    TOPK_MAX_SCRATCH_BYTES,
    TOPK_MAX_SMEM,
    TOPK_PEND_MAX,
    TOPK_RUN_MAX_KT,
    TOPK_RUN_NARROW_MAX_K,
    TOPK_SELECT_MAX_K,
    TOPK_STAGE1,
    TOPK_STEP_STRIDE,
    TOPK_STEP_TILES,
    TOPK_TILE_ITEMS,
    TOPK_TILE_QUERIES,
    TOPK_TILED_CHUNK,
    TOPK_TILED_SPARSE_MAX,
    top_k_for_users_streaming,
    top_k_streaming,
    top_k_streaming_reference,
    topk_batch_slices,
    topk_launch_plan,
    topk_scratch_bytes,
    topk_select_row,
    topk_select_score_smem,
    topk_select_smem,
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
    # the ceiling on k is the catalog's (TOPK_MAX_ITEMS), so k can pass it
    # only with a catalog past it, which is refused before any work (meta
    # tensors: nothing is allocated)
    assert TOPK_MAX_K == TOPK_MAX_ITEMS
    q = torch.zeros((1, 2), device="meta")
    items = torch.zeros((TOPK_MAX_ITEMS + 1, 2), device="meta")
    with pytest.raises(ValueError, match="exceeds"):
        top_k_streaming(q, items, TOPK_MAX_K + 1)
    # clamping to the catalog happens first: k past a small N is fine
    s, _ = top_k_streaming(torch.zeros((1, 2)), torch.zeros((5, 2)), 4097)
    assert s.shape == (1, 4097)


# -- the launch plan ----------------------------------------------------------

PLAN_RANK, PLAN_SMS = 50, 132


#: stage-1 shared memory at rank 50 as the .cu's run_smem_bytes and
#: run_tiled_smem_bytes give it, written out: q rows, the staged chunk, two
#: candidate buffers, two copies of the lists, counts, exclusion bits
def _run_smem(kt):
    return 4 * (8 * PLAN_RANK + 16 * 257 + 4 * 8 * 256 + 4 * 8 * kt + 8 + 8 * 8)


def _run_tiled_smem(kt):
    return 4 * (8 * PLAN_RANK + 8 * 1028 + 2 * 8 * 256 + 4 * 8 * kt + 24 + 8 * 32
                + 2 * 8 * 128)


@pytest.mark.parametrize("n", [10, 1000, 27000, 1000000])
@pytest.mark.parametrize("k", [8, 16, 128, 129, 200, 256, 1024, 2048])
@pytest.mark.parametrize("b", [1, 8, 64, 512, 1024, 4096])
def test_launch_plan(b, k, n):
    k_eff = min(k, n)
    plan = topk_launch_plan(b, n, k_eff, PLAN_SMS, PLAN_RANK)
    assert plan.kt == min(k_eff, TOPK_TILE_ITEMS)
    assert plan.n_tiles == -(-n // TOPK_TILE_ITEMS)
    assert 1 <= plan.tiles_per_block <= plan.n_tiles
    assert plan.n_runs == -(-plan.n_tiles // plan.tiles_per_block)
    assert plan.n_runs * plan.tiles_per_block >= plan.n_tiles
    # every run holds at least one tile
    assert (plan.n_runs - 1) * plan.tiles_per_block < plan.n_tiles
    assert plan.query_tile == TOPK_TILE_QUERIES
    assert plan.n_query_tiles == -(-b // TOPK_TILE_QUERIES)
    assert 0 <= plan.stage1_smem <= TOPK_MAX_SMEM
    assert 0 <= plan.merge_smem <= TOPK_MAX_SMEM
    if plan.stage1 == "select":  # a row of scores and counts a query, no lists
        assert plan.scratch_shape == (b, 1, topk_select_row(n))
        assert k_eff <= plan.survivors <= TOPK_SELECT_MAX_K
        assert plan.merge_smem == topk_select_smem(plan.survivors)
        assert plan.merge_threads == 1024
    else:
        assert plan.scratch_shape == (b, plan.n_runs, plan.kt)
        keys = plan.n_runs * plan.kt
        assert plan.merge_smem in (0, 16 * keys)
        # the merge leaves shared memory only when two copies do not fit
        assert (plan.merge_smem == 0) == (16 * keys > TOPK_MAX_SMEM)
        assert plan.merge_threads == (64 if keys <= 128 else 256 if keys <= 1024 else 1024)
    if k_eff > TOPK_RUN_MAX_KT:  # the threshold select up to its ceiling
        assert plan.stage1 == "select" and k_eff <= TOPK_SELECT_MAX_K
        assert plan.stage1_smem == topk_select_score_smem(PLAN_RANK)
    elif k_eff <= TOPK_RUN_NARROW_MAX_K:  # one item a thread
        assert plan.stage1 == "running_list"
        assert plan.stage1_smem == _run_smem(plan.kt)
    else:  # 128 < k <= 256: the tiled running list, whole steps of 4 tiles
        assert plan.stage1 == "running_list_tiled"
        assert plan.kt == k_eff
        assert plan.stage1_smem == _run_tiled_smem(plan.kt)
        assert (plan.tiles_per_block % TOPK_STEP_TILES == 0
                or plan.tiles_per_block == plan.n_tiles)
    blocks = plan.n_runs * plan.n_query_tiles
    # the blocks an SM holds at once: four (two for the tiled kernel and the
    # select path's scoring) by their registers, fewer by their shared memory
    per_sm = 2 if plan.stage1 in ("running_list_tiled", "select") else 4
    resident = min(per_sm, 233472 // (plan.stage1_smem + 1024))
    if plan.stage1 == "running_list_tiled":
        assert resident == 2  # at R = 50, by its shared memory as well
    if plan.n_tiles * plan.n_query_tiles <= resident * PLAN_SMS:
        # one block per (query tile, item tile) fits in one wave: one
        # tile a block, one step for the tiled kernel
        assert plan.tiles_per_block == (min(TOPK_STEP_TILES, plan.n_tiles)
                                        if plan.stage1 in ("running_list_tiled", "select")
                                        else 1)
    elif plan.stage1_smem:
        # runs grow with the batch: one wave of blocks, or one run a query
        assert plan.tiles_per_block > 1
        assert blocks <= resident * PLAN_SMS or plan.n_runs == 1
    if b == 1 and n <= 27000 and k_eff <= TOPK_RUN_NARROW_MAX_K:
        assert plan.tiles_per_block == 1
    if b == 1024 and n >= 27000 and k <= TOPK_RUN_NARROW_MAX_K:
        assert plan.n_runs < plan.n_tiles
        if n == 27000:
            assert plan.n_runs == (4 if k <= 16 else 3)
            assert plan.tiles_per_block == (27 if k <= 16 else 36)
    if b == 1024 and n == 27000 and TOPK_RUN_NARROW_MAX_K < k <= TOPK_RUN_MAX_KT:
        assert (plan.n_runs, plan.tiles_per_block) == (2, 56)  # 53 rounded up to steps


@pytest.mark.parametrize("k", [129, 200, 256])
def test_k_up_to_256_keeps_one_list_a_query_at_a_large_batch(k):
    """B = 32,768 over ML-20M's catalog at 128 < k <= 256: 4,096 query
    tiles fill two waves of two blocks an SM alone, so each walks all 106
    tiles and a query leaves one list (67 MB of scratch at k = 256, one
    launch); the running list forced at one item a thread plans the same
    runs (two blocks an SM at k = 256, three below), the per-tile sort 106
    lists."""
    b, n = 32768, 27000
    plan = topk_launch_plan(b, n, k, PLAN_SMS, PLAN_RANK)
    assert plan.stage1 == "running_list_tiled"
    assert (plan.n_runs, plan.tiles_per_block) == (1, 106)
    assert plan.merge_smem == 16 * k
    assert topk_scratch_bytes(plan) == b * k * 8
    narrow = topk_launch_plan(b, n, k, PLAN_SMS, PLAN_RANK, "running_list")
    assert narrow.stage1_smem == _run_smem(k) and narrow.n_runs == 1
    assert 233472 // (narrow.stage1_smem + 1024) == (2 if k == 256 else 3)
    per_tile = topk_launch_plan(b, n, k, PLAN_SMS, PLAN_RANK, "tile_sort")
    assert per_tile.stage1_smem == 0 and per_tile.n_runs == 106
    assert topk_batch_slices(b, n_items=n, k_eff=k, rank=PLAN_RANK,
                             sm_count=PLAN_SMS) == [(0, b)]


def test_a_forced_stage1_kernel_is_planned_or_refused():
    for stage1 in TOPK_STAGE1:
        plan = topk_launch_plan(64, 27000, 16, PLAN_SMS, PLAN_RANK, stage1)
        assert plan.stage1 == stage1
        if stage1 == "running_list_tiled":
            assert plan.tiles_per_block % TOPK_STEP_TILES == 0
    # the running lists keep k keys a run: none above 256
    for stage1 in ("running_list", "running_list_tiled"):
        with pytest.raises(ValueError):
            topk_launch_plan(64, 27000, 257, PLAN_SMS, PLAN_RANK, stage1)
    with pytest.raises(ValueError):
        topk_launch_plan(64, 27000, 16, PLAN_SMS, PLAN_RANK, "bitonic")
    with pytest.raises(ValueError):
        top_k_streaming(torch.zeros((2, 4)), torch.zeros((6, 4)), 3, stage1="bitonic")
    # the CPU answers every forced kernel with the plain version
    q, items = torch.ones((2, 4)), torch.arange(24.0).reshape(6, 4)
    for stage1 in TOPK_STAGE1:
        got = top_k_streaming(q, items, 3, stage1=stage1)
        assert torch.equal(got[1], torch.tensor([[5, 4, 3]] * 2, dtype=torch.int32))


def test_launch_plan_follows_the_card_and_the_rank():
    small = topk_launch_plan(1024, 27000, 16, 16, PLAN_RANK)
    large = topk_launch_plan(1024, 27000, 16, PLAN_SMS, PLAN_RANK)
    assert small.n_runs == 1 and small.tiles_per_block > large.tiles_per_block
    # q rows that do not fit in shared memory: back to one tile a block
    wide = topk_launch_plan(1024, 27000, 16, PLAN_SMS, 8000)
    assert wide.stage1_smem == 0 and wide.tiles_per_block == 1
    with pytest.raises(ValueError):
        topk_launch_plan(0, 10, 1, PLAN_SMS, PLAN_RANK)
    with pytest.raises(ValueError):
        topk_launch_plan(1, 10, 11, PLAN_SMS, PLAN_RANK)


# -- the kernel's selection, step by step in numpy -----------------------------
#
# What csrc/topk_streaming.cu does after the dot products, written out on
# the [B, N] scores of the plain version: runs of T tiles with a running
# list and a threshold filter (sparse tiles ranked by counting, dense tiles
# by a warp bitonic network and a tree merge of the heads), the per-tile
# sort for kt > 128, then the pairwise tree merge by rank. It must give the
# plain version's answer exactly.

SENTINEL_BASE = 2**31 - 1 - TOPK_MAX_K
SPARSE_MAX, WARP = 32, 32


def _before(sa, ia, sb, ib):
    return (sa > sb) | ((sa == sb) & (ia < ib))


def _assert_sorted(s, i):
    assert _before(s[:-1], i[:-1], s[1:], i[1:]).all(), "list not strictly sorted"


def _count_before(ls, li, s, i):
    """Keys of the sorted list (ls, li) that rank before each of (s, i):
    what the kernel's binary search returns on a strictly sorted list."""
    _assert_sorted(ls, li)
    return _before(ls[None, :], li[None, :], s[:, None], i[:, None]).sum(axis=1)


def _warp_bitonic(s, i):
    """The shuffle network of the dense path on [n_warps, 32] keys."""
    s, i = s.copy(), i.copy()
    lane = np.arange(WARP)
    size = 2
    while size <= WARP:
        stride = size >> 1
        while stride > 0:
            os_, oi = s[:, lane ^ stride], i[:, lane ^ stride]
            lower = (lane & stride) == 0
            best_first = (lane & size) == 0
            take = (lower == best_first)[None, :] == _before(os_, oi, s, i)
            s, i = np.where(take, os_, s), np.where(take, oi, i)
            stride >>= 1
        size <<= 1
    return s, i


def _place(ns, ni, rank, s, i, kt):
    keep = rank < kt
    assert (ns[rank[keep]] != ns[rank[keep]]).all(), "a slot written twice"
    ns[rank[keep]], ni[rank[keep]] = s[keep], i[keep]


def _run_slices(plan, run):
    """The item indices one stage-1 block selects from, in its order, one
    array of 256 (thread t's candidate at position t) a selection: a tile
    at a time for ``running_list``; for the tiled kernel four slices of
    each 1,024-item step, slice c holding items 4t + c."""
    t = plan.tiles_per_block
    tiles = range(run * t, min(plan.n_tiles, (run + 1) * t))
    assert len(tiles) >= 1
    lane = np.arange(TOPK_TILE_ITEMS, dtype=np.int64)
    if plan.stage1 == "running_list":
        return [tile * TOPK_TILE_ITEMS + lane for tile in tiles]
    step = TOPK_STEP_TILES * TOPK_TILE_ITEMS
    # a run is whole steps, or ends with the catalog
    assert len(tiles) % TOPK_STEP_TILES == 0 or tiles[-1] == plan.n_tiles - 1
    return [step0 + TOPK_STEP_TILES * lane + c
            for step0 in range(tiles[0] * TOPK_TILE_ITEMS, (tiles[-1] + 1) * TOPK_TILE_ITEMS,
                               step)
            for c in range(TOPK_STEP_TILES)]


def _warp_sort(s, i):
    """warp_sort: the bitonic network on 32 H keys held H a lane (key e =
    lane + 32 h), best first; strides of 32 and more compare keys of one
    lane."""
    s, i = s.copy(), i.copy()
    e = np.arange(len(s))
    size = 2
    while size <= len(s):
        stride = size >> 1
        while stride > 0:
            os_, oi = s[e ^ stride], i[e ^ stride]
            take = ((e & stride) == 0) == ((e & size) == 0)
            take = take == _before(os_, oi, s, i)
            s, i = np.where(take, os_, s), np.where(take, oi, i)
            stride >>= 1
        size <<= 1
    return s, i


def _merge_pending(ls, li, ps, pi, kt):
    """merge_pending: n <= TOPK_PEND_MAX unsorted pending keys into one
    sorted list."""
    n = len(ps)
    assert n <= TOPK_PEND_MAX
    s = np.full(TOPK_PEND_MAX, -np.inf, np.float32)
    i = np.full(TOPK_PEND_MAX, 2**31 - 1, np.int64)
    s[:n], i[:n] = ps, pi
    s, i = _warp_sort(s, i)
    s, i = s[:n], i[:n]
    _assert_sorted(s, i)
    ns = np.full(kt, np.nan, np.float32)
    ni = np.full(kt, -7, np.int64)
    _place(ns, ni, np.arange(n) + _count_before(ls, li, s, i), s, i, kt)
    _place(ns, ni, np.arange(kt) + _count_before(s, i, ls, li), ls, li, kt)
    assert not np.isnan(ns).any(), "a list slot was never written"
    return ns, ni


def _stage1_run(masked, q_rows, selections, kt, n_items, rng, lazy=False):
    """One stage-1 block of a running-list kernel: the query tile
    ``q_rows`` over the item index arrays ``selections``
    (:func:`_run_slices`). Returns [nq, kt] keys. ``lazy`` is the tiled
    kernel's selection: a sparse slice's survivors wait in a pending
    buffer, merged into the lists once some query holds more than 32 of
    them, and at the end of the run; a slice is dense only above 64
    survivors in some query."""
    nq = len(q_rows)
    ls = np.full((nq, kt), -np.inf, np.float32)
    li = np.tile(SENTINEL_BASE + np.arange(kt, dtype=np.int64), (nq, 1))
    pend = [(np.empty(0, np.float32), np.empty(0, np.int64)) for _ in range(nq)]

    def flush(ls, li):
        out = [_merge_pending(ls[qi], li[qi], *pend[qi], kt) for qi in range(nq)]
        return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])

    for j in selections:
        cs = np.full((nq, TOPK_TILE_ITEMS), -np.inf, np.float32)
        live = j < n_items
        cs[:, live] = masked[np.ix_(q_rows, j[live])]
        keep = _before(cs, j[None, :], ls[:, -1:], li[:, -1:])
        ns = np.full((nq, kt), np.nan, np.float32)
        ni = np.full((nq, kt), -7, np.int64)
        if keep.sum(axis=1).max() <= TOPK_TILED_SPARSE_MAX and lazy:
            for qi in range(nq):
                order = rng.permutation(np.flatnonzero(keep[qi]))  # arrival order
                pend[qi] = (np.concatenate([pend[qi][0], cs[qi, order]]),
                            np.concatenate([pend[qi][1], j[order]]))
            if max(len(p[0]) for p in pend) > TOPK_TILED_SPARSE_MAX:
                ls, li = flush(ls, li)
                pend = [(p[0][:0], p[1][:0]) for p in pend]
            continue
        if keep.sum(axis=1).max() <= SPARSE_MAX:
            for qi in range(nq):
                order = rng.permutation(np.flatnonzero(keep[qi]))  # arrival order
                ss, si = cs[qi, order], j[order]
                among = _before(ss[None, :], si[None, :], ss[:, None], si[:, None]).sum(1)
                _place(ns[qi], ni[qi], among + _count_before(ls[qi], li[qi], ss, si),
                       ss, si, kt)
                ahead = _before(ss[None, :], si[None, :],
                                ls[qi][:, None], li[qi][:, None]).sum(1)
                _place(ns[qi], ni[qi], np.arange(kt) + ahead, ls[qi], li[qi], kt)
        elif lazy:  # dense: warp w sorts query w's 256 candidates; pending keys wait
            fresh = ls[:, -1] == -np.inf
            for qi in range(nq):
                hs, hi = _warp_sort(cs[qi], j)
                _assert_sorted(hs, hi)
                hs, hi = hs[:kt], hi[:kt]
                if (li[qi] >= SENTINEL_BASE).all():  # the run's first slice
                    assert fresh[qi]
                    ns[qi], ni[qi] = hs, hi
                    continue
                _place(ns[qi], ni[qi], np.arange(kt) + _count_before(ls[qi], li[qi], hs, hi),
                       hs, hi, kt)
                _place(ns[qi], ni[qi], np.arange(kt) + _count_before(hs, hi, ls[qi], li[qi]),
                       ls[qi], li[qi], kt)
        else:  # dense: the slice's survivors are dropped
            hl = min(kt, WARP)
            n_warps = TOPK_TILE_ITEMS // WARP
            for qi in range(nq):
                ws, wi = _warp_bitonic(cs[qi].reshape(-1, WARP), j.reshape(-1, WARP))
                # the heads merge pairwise, each 32-slot segment a leaf
                hs, hi = _tree_merge(ws.ravel(), wi.ravel(), n_warps, hl, WARP, kt)
                assert len(hs) == kt
                _place(ns[qi], ni[qi], np.arange(kt) + _count_before(ls[qi], li[qi], hs, hi),
                       hs, hi, kt)
                _place(ns[qi], ni[qi], np.arange(kt) + _count_before(hs, hi, ls[qi], li[qi]),
                       ls[qi], li[qi], kt)
        assert not np.isnan(ns).any(), "a list slot was never written"
        ls, li = ns, ni
    if max(len(p[0]) for p in pend):  # the run's last pending keys
        ls, li = flush(ls, li)
    return ls, li


def _tree_merge(cs, ci, n_lists, leaf, stride, k):
    """The pairwise tree merge (merge_round_key, round by round) over
    ``n_lists`` sorted lists of ``leaf`` keys, list l at ``l * stride``:
    stage 2 on a query's flat scratch (leaf = stride = kt), and the dense
    path's merge of the eight warp heads (stride 32)."""
    src_s, src_i = cs.copy(), ci.copy()
    width, rounds = 1, 0
    while width < n_lists:
        dst_s = np.full_like(src_s, np.nan)
        dst_i = np.full_like(src_i, -7)
        n_nodes = -(-n_lists // width)
        for c in range(n_nodes):
            length = min(k, min(width, n_lists - c * width) * leaf)
            off = c * width * stride
            s, i = src_s[off:off + length], src_i[off:off + length]
            sib = c ^ 1
            if sib * width < n_lists:
                sib_len = min(k, min(width, n_lists - sib * width) * leaf)
                so = sib * width * stride
                rank = np.arange(length) + _count_before(
                    src_s[so:so + sib_len], src_i[so:so + sib_len], s, i)
                keep = rank < k
                o = (c >> 1) * 2 * width * stride + rank[keep]
                assert np.isnan(dst_s[o]).all()
                dst_s[o], dst_i[o] = s[keep], i[keep]
            else:
                dst_s[off:off + length], dst_i[off:off + length] = s, i
        src_s, src_i = dst_s, dst_i
        width <<= 1
        rounds += 1
    assert rounds == (0 if n_lists == 1 else int(np.ceil(np.log2(n_lists))))
    n_out = min(k, n_lists * leaf)
    assert not np.isnan(src_s[:n_out]).any()
    return src_s[:n_out], src_i[:n_out]


def emulate_kernel_selection(scores, k, excl, plan, seed=0):
    """(scores [B, k_eff] f32, ids [B, k_eff] i32) as the kernel selects
    them from the plain version's ``[B, N]`` scores under ``plan``."""
    rng = np.random.default_rng(seed)
    b, n_items = scores.shape
    masked = scores.copy()
    if excl is not None:
        for row in range(b):
            hit = excl[row][(excl[row] >= 0) & (excl[row] < n_items)]
            masked[row, hit] = -np.inf
    kt, n_runs, t = plan.kt, plan.n_runs, plan.tiles_per_block
    cand_s = np.full((b, n_runs, kt), np.nan, np.float32)
    cand_i = np.full((b, n_runs, kt), -7, np.int64)
    for q0 in range(0, b, TOPK_TILE_QUERIES):
        q_rows = np.arange(q0, min(b, q0 + TOPK_TILE_QUERIES))
        for run in range(n_runs):
            if plan.stage1 != "tile_sort":
                ls, li = _stage1_run(masked, q_rows, _run_slices(plan, run), kt,
                                     n_items, rng, lazy=plan.stage1 == "running_list_tiled")
            else:  # the per-tile kernel: a full sort of the tile, kt kept
                assert t == 1
                tile = run
                j = tile * TOPK_TILE_ITEMS + np.arange(TOPK_TILE_ITEMS, dtype=np.int64)
                cs = np.full((len(q_rows), TOPK_TILE_ITEMS), -np.inf, np.float32)
                cs[:, j < n_items] = masked[np.ix_(q_rows, j[j < n_items])]
                order = np.lexsort((np.broadcast_to(j, cs.shape), -cs), axis=1)[:, :kt]
                ls, li = np.take_along_axis(cs, order, 1), j[order]
            cand_s[q_rows, run], cand_i[q_rows, run] = ls, li
    out_s = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    for row in range(b):
        s, i = _tree_merge(cand_s[row].ravel(), cand_i[row].ravel(), n_runs, kt, kt, k)
        out_s[row] = s
        out_i[row] = np.where(np.isneginf(s), -1, i)  # only the last write
    return out_s, out_i


def _plan_with_runs(b, n, k_eff, tiles_per_block, stage1=None):
    plan = topk_launch_plan(b, n, k_eff, PLAN_SMS, 8, stage1)
    if tiles_per_block is None:
        return plan
    assert plan.stage1_smem, "only the running-list paths take runs"
    n_runs = -(-plan.n_tiles // tiles_per_block)
    return plan._replace(tiles_per_block=tiles_per_block, n_runs=n_runs,
                         scratch_shape=(b, n_runs, plan.kt))


def _selection_case(name):
    """(q, items, k, excl, tiles per block or None for the plan's own)."""
    rng = np.random.default_rng(11)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    if name.startswith("random_T"):
        return normal(5, 8), normal(3000, 8), 16, None, int(name[len("random_T"):])
    if name == "ties":
        base = rng.integers(-3, 4, size=(250, 6)).astype(np.float32)
        items = np.concatenate([base, base[::-1], base, base, base[::-1], base])
        return rng.integers(-3, 4, size=(9, 6)).astype(np.float32), items, 16, None, 2
    if name == "rising_scores":
        q = np.abs(normal(3, 4)) + 0.5
        items = np.arange(2000, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
        return q, items, 16, None, 8
    if name == "exclusions_empty_a_row":
        excl = np.full((3, 600), -1, np.int32)
        excl[0] = np.arange(600)
        excl[1, :590] = rng.permutation(600)[:590]
        return normal(3, 8), normal(600, 8), 16, excl, 3
    if name == "k_above_catalog":
        return normal(2, 4), normal(10, 4), 16, None, None
    if name == "odd_number_of_runs":
        return normal(10, 8), normal(2817, 8), 8, None, 5  # 12 tiles: 5 + 5 + 2
    if name == "single_item":
        return normal(3, 4), normal(1, 4), 1, None, None
    if name == "k128_sparse_and_dense":
        return normal(2, 8), normal(4000, 8), 128, None, 8
    if name == "k200_per_tile_sort":  # forced, as chip_smoke.py holds the kernels to it
        return normal(2, 8), normal(1500, 8), 200, None, None
    if name == "k200_running_list":  # the plan's own: the tiled kernel, one step
        return normal(2, 8), normal(1500, 8), 200, None, None
    if name == "k256_tiled_sparse_and_dense":  # 3 runs of 2 steps, 8 slices each
        return normal(9, 8), normal(6000, 8), 256, None, 8
    if name == "k256_tiled_rising_scores":  # every slice dense
        q = np.abs(normal(3, 4)) + 0.5
        items = np.arange(3000, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
        return q, items, 256, None, 4
    if name == "k256_tiled_ties":
        base = rng.integers(-3, 4, size=(300, 6)).astype(np.float32)
        items = np.concatenate([base, base[::-1], base, base, base[::-1], base])
        return rng.integers(-3, 4, size=(9, 6)).astype(np.float32), items, 256, None, 4
    if name == "k256_tiled_exclusions_empty_a_row":
        excl = np.full((3, 1300), -1, np.int32)
        excl[0] = np.arange(1300)
        excl[1, :1100] = rng.permutation(1300)[:1100]
        return normal(3, 8), normal(1300, 8), 256, excl, 4
    if name == "k129_tiled_odd_number_of_runs":  # 11 tiles: 4 + 4 + 3, the last step ragged
        return normal(10, 8), normal(2600, 8), 129, None, 4
    if name == "k256_tiled_one_run":  # B = 32,768's plan: one run of 106 tiles
        return normal(3, 8), normal(27000, 8), 256, None, 106
    if name == "k256_tiled_late_dense":  # dense slices while keys are pending
        items = normal(12000, 8)
        items[9216:10240] *= 6
        excl = rng.integers(-1, 12000, size=(4, 40)).astype(np.int32)
        return normal(4, 8), items, 256, excl, 47
    if name == "k256_running_list_forced":  # topk_run_kernel at kt = 256
        return normal(2, 8), normal(4000, 8), 256, None, 8
    if name == "k16_tiled_forced":  # the tiled kernel at a small kt
        return normal(5, 8), normal(3000, 8), 16, None, 8
    if name == "k300_lists_grow_in_the_merge":
        return normal(2, 8), normal(3000, 8), 300, None, None
    if name == "served_batch_plan":  # the plan of B = 1024, two of its rows
        return normal(2, 8), normal(27000, 8), 16, None, 27
    if name == "k4096_merge_in_shared_memory":  # 20 lists of 256, 80 KB
        return normal(2, 8), normal(5000, 8), 4096, None, None
    if name == "k_equals_catalog_merge_in_device_memory":  # 59 lists, 241 KB
        excl = rng.integers(-1, 15000, size=(2, 64)).astype(np.int32)
        return normal(2, 8), normal(15000, 8), 15000, excl, None
    raise KeyError(name)


#: cases whose stage-1 kernel is forced, not the plan's pick
_FORCED_STAGE1 = {"k200_per_tile_sort": "tile_sort",
                  "k256_running_list_forced": "running_list",
                  "k16_tiled_forced": "running_list_tiled",
                  # the per-tile sort and its tree merge, which the select
                  # path (the plan's pick for these k) is held to on the card
                  "k300_lists_grow_in_the_merge": "tile_sort",
                  "k4096_merge_in_shared_memory": "tile_sort",
                  "k_equals_catalog_merge_in_device_memory": "tile_sort"}


@pytest.mark.parametrize("name", [
    "random_T1", "random_T4", "random_T12", "ties", "rising_scores",
    "exclusions_empty_a_row", "k_above_catalog", "odd_number_of_runs",
    "single_item", "k128_sparse_and_dense", "k200_per_tile_sort",
    "k300_lists_grow_in_the_merge", "served_batch_plan",
    "k4096_merge_in_shared_memory", "k_equals_catalog_merge_in_device_memory",
    "k200_running_list", "k256_tiled_sparse_and_dense", "k256_tiled_rising_scores",
    "k256_tiled_ties", "k256_tiled_exclusions_empty_a_row",
    "k129_tiled_odd_number_of_runs", "k256_running_list_forced", "k16_tiled_forced",
    "k256_tiled_one_run", "k256_tiled_late_dense",
])
def test_kernel_selection_emulated_equals_plain(name):
    q, items, k, excl, tiles_per_block = _selection_case(name)
    n = items.shape[0]
    k_eff = min(k, n)
    plan = _plan_with_runs(q.shape[0], n, k_eff, tiles_per_block, _FORCED_STAGE1.get(name))
    if name in _FORCED_STAGE1:
        assert plan.stage1 == _FORCED_STAGE1[name]
    elif "tiled" in name or name == "k200_running_list":
        assert plan.stage1 == "running_list_tiled"
    if name in ("odd_number_of_runs", "k129_tiled_odd_number_of_runs"):
        assert plan.n_runs == 3
    if name.startswith("k4096"):
        assert plan.merge_smem == 16 * 20 * 256
    if name.startswith("k_equals_catalog"):
        assert plan.merge_smem == 0 and plan.n_runs == 59
    scores = (_t(q) @ _t(items).T).numpy()  # the plain version's product
    got_s, got_i = emulate_kernel_selection(scores, k_eff, excl, plan)
    want_s, want_i = top_k_streaming_reference(
        _t(q), _t(items), k, None if excl is None else _t(excl))
    np.testing.assert_array_equal(got_s, want_s.numpy()[:, :k_eff])
    np.testing.assert_array_equal(got_i, want_i.numpy()[:, :k_eff])  # ids equal
    assert torch.isneginf(want_s[:, k_eff:]).all() and (want_i[:, k_eff:] == -1).all()
    if name == "ties":
        assert (got_s[:, 1:] == got_s[:, :-1]).any()
    if name in ("exclusions_empty_a_row", "k256_tiled_exclusions_empty_a_row"):
        kept = 10 if name == "exclusions_empty_a_row" else 200
        assert (got_i[0] == -1).all() and (got_i[1, kept:] == -1).all()


# -- k above the old ceiling of 2048, up to the catalog --------------------------
def _fused_case(n, b=3, r=8, seed=21):
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(10, r)).astype(np.float32)
    itf = rng.normal(size=(n, r)).astype(np.float32)
    uidx = rng.integers(0, 10, b).astype(np.int32)
    return uf, itf, uidx


def test_k4096_on_5000_items_is_answered_like_jax():
    """A served ``num`` of 4096 pads to k = 4096: the port's streaming
    entry answers as the JAX package's fused top-k does (ids equal but
    for near-ties, scores rtol/atol 1e-5)."""
    uf, itf, uidx = _fused_case(5000)
    port = scoring.top_k_for_users_fused(_t(uf), _t(itf), _t(uidx), k=4096, mode="always")
    ref = jax_scoring.top_k_for_users_fused(uf, itf, uidx, k=4096, mode="auto")
    assert port[0].shape == (3, 4096)
    assert_agree(port, ref)


def test_k256_on_27000_items_is_answered_like_jax():
    """A served ``num`` from 129 to 256 pads to k = 256, the tiled running
    list's path on the card: the port answers as the JAX package's fused
    top-k does on ML-20M's catalog, with exclusions."""
    n = 27000
    uf, itf, uidx = _fused_case(n, b=4, seed=24)
    excl = np.random.default_rng(25).integers(-1, n, size=(4, 32)).astype(np.int32)
    assert topk_launch_plan(4, n, 256, PLAN_SMS, 8).stage1 == "running_list_tiled"
    port = scoring.top_k_for_users_fused(_t(uf), _t(itf), _t(uidx), k=256,
                                         exclude_idx=_t(excl), mode="always")
    ref = jax_scoring.top_k_for_users_fused(uf, itf, uidx, k=256, exclude_idx=excl,
                                            mode="auto")
    assert port[0].shape == (4, 256)
    assert_agree(port, ref)
    for row in range(4):
        assert not set(port[1][row].tolist()) & set(excl[row][excl[row] >= 0].tolist())


def test_k_equal_to_the_catalog_with_exclusions_is_answered_like_jax():
    """k = N with 64 exclusions a query (some -1, some repeated): every
    item is ranked, each excluded one last as (-inf, -1)."""
    n = 15000
    uf, itf, uidx = _fused_case(n, seed=22)
    rng = np.random.default_rng(23)
    excl = rng.integers(-1, n, size=(3, 64)).astype(np.int32)
    port = scoring.top_k_for_users_fused(_t(uf), _t(itf), _t(uidx), k=n,
                                         exclude_idx=_t(excl), mode="always")
    ref = jax_scoring.top_k_for_users_fused(uf, itf, uidx, k=n, exclude_idx=excl,
                                            mode="auto")
    assert_agree(port, ref)
    ids = port[1].numpy()
    for row in range(3):
        n_excl = len(set(excl[row][excl[row] >= 0].tolist()))
        assert (ids[row] == -1).sum() == n_excl
        assert sorted(ids[row][ids[row] >= 0].tolist()) == sorted(
            set(range(n)) - set(excl[row].tolist()))


# -- the batch slices under the scratch budget -------------------------------------
SLICE_SMS = 132


def _slices_cover(slices, b):
    starts = [s for s, _ in slices]
    assert starts == sorted(starts) and (not slices or starts[0] == 0)
    assert all(e == nxt for (_, e), nxt in zip(slices, starts[1:] + [b]))


@pytest.mark.parametrize("b,n,r,k", [
    (262144, 3706, 16, 16),   # eval's padded batch: one launch
    (600000, 3706, 16, 16),   # two launches, as before
    (1024, 27000, 50, 16),    # a served batch
    (524280, 27000, 50, 128),  # the most a launch takes, at the running list's top kt
    (3 * TOPK_MAX_BATCH + 7, 1000, 8, 1),
])
def test_plans_that_ran_before_keep_their_slices(b, n, r, k):
    """At kt <= 128 the scratch stays far below the budget, so the
    slices are the batch cap's alone, as before the budget."""
    got = topk_batch_slices(b, n_items=n, k_eff=min(k, n), rank=r, sm_count=SLICE_SMS)
    assert got == topk_batch_slices(b)
    for start, stop in got:
        plan = topk_launch_plan(stop - start, n, min(k, n), SLICE_SMS, r)
        assert topk_scratch_bytes(plan) <= TOPK_MAX_SCRATCH_BYTES
    if (b, k) == (262144, 16):
        assert got == [(0, b)]
        assert topk_scratch_bytes(topk_launch_plan(b, n, k, SLICE_SMS, r)) == b * 16 * 8
    if b == 600000:
        assert len(got) == 2


@pytest.mark.parametrize("b,n,k", [
    (262144, 27000, 512), (262144, 27000, 27000), (100000, 5000, 4096),
    (9, 27000, 27000), (17, 1 << 22, 300),
])
def test_per_tile_plans_are_cut_to_the_scratch_budget(b, n, k):
    # below the select path's ceiling the per-tile sort is forced, as the
    # card's checks force it
    stage1 = "tile_sort"
    got = topk_batch_slices(b, n_items=n, k_eff=k, rank=50, sm_count=SLICE_SMS,
                            stage1=stage1)
    _slices_cover(got, b)
    assert {stop - start for start, stop in got[:-1]} <= {got[0][1]}  # equal but the last
    for start, stop in got:
        plan = topk_launch_plan(stop - start, n, k, SLICE_SMS, 50, stage1)
        assert plan.stage1_smem == 0
        assert topk_scratch_bytes(plan) <= TOPK_MAX_SCRATCH_BYTES
    rows = got[0][1]
    assert rows % TOPK_TILE_QUERIES == 0 or rows == b
    per_query = topk_scratch_bytes(topk_launch_plan(8, n, k, SLICE_SMS, 50, stage1)) // 8
    if rows < b:  # the budget binds: as many query tiles as fit it, no fewer
        assert (rows + TOPK_TILE_QUERIES) * per_query > TOPK_MAX_SCRATCH_BYTES
    if (n, k) == (27000, 27000):
        assert per_query == 106 * 256 * 16  # the merge in device memory


def test_k256_at_the_largest_batch_stays_one_launch_on_the_running_list():
    """k = 256 keeps one list of 256 a query on the tiled running list:
    B = 262,144 over 27,000 items is one launch with 537 MB of scratch,
    where the per-tile sort (forced) is cut into launches of 2 GiB."""
    b, n, k = 262144, 27000, 256
    got = topk_batch_slices(b, n_items=n, k_eff=k, rank=50, sm_count=SLICE_SMS)
    assert got == [(0, b)]
    plan = topk_launch_plan(b, n, k, SLICE_SMS, 50)
    assert plan.stage1 == "running_list_tiled" and plan.n_runs == 1
    assert topk_scratch_bytes(plan) == b * 256 * 8 <= TOPK_MAX_SCRATCH_BYTES
    forced = topk_batch_slices(b, n_items=n, k_eff=k, rank=50, sm_count=SLICE_SMS,
                               stage1="tile_sort")
    _slices_cover(forced, b)
    assert len(forced) > 1
    for start, stop in forced:
        plan = topk_launch_plan(stop - start, n, k, SLICE_SMS, 50, "tile_sort")
        assert topk_scratch_bytes(plan) <= TOPK_MAX_SCRATCH_BYTES


def test_one_query_tile_is_the_least_slice():
    """Near the catalog's ceiling one query's lists pass the budget alone
    (2^21 tiles × 256 keys × 16 bytes): the slices stay one query tile."""
    n = TOPK_MAX_ITEMS
    got = topk_batch_slices(20, n_items=n, k_eff=n, rank=4, sm_count=SLICE_SMS)
    assert got == [(0, 8), (8, 16), (16, 20)]
    plan = topk_launch_plan(8, n, n, SLICE_SMS, 4)
    assert plan.n_runs * plan.kt == n  # the merge's int key offsets reach 2^29
    assert topk_scratch_bytes(plan) > TOPK_MAX_SCRATCH_BYTES
    with pytest.raises(ValueError):
        topk_batch_slices(-1, n_items=n, k_eff=n, rank=4, sm_count=SLICE_SMS)
    assert topk_batch_slices(0, n_items=n, k_eff=n, rank=4, sm_count=SLICE_SMS) == []


def test_the_c_entry_takes_k_up_to_the_catalog_and_clamps_the_store_grid():
    import pathlib

    src = (pathlib.Path(__file__).resolve().parents[1] / "predictionio_tpu_torch"
           / "kernels" / "csrc" / "topk_streaming.cu").read_text()
    assert f"constexpr int kMaxK = {TOPK_MAX_ITEMS};" in src
    assert "K > kMaxK" in src and "span > (1 << 29)" in src
    store = src[src.index("const int store_blocks"):src.index("topk_store_kernel<<<")]
    assert "store_blocks < 65535 ? store_blocks : 65535" in store
    # the sentinels stay above every real index
    assert 2**31 - 1 - TOPK_MAX_K > TOPK_MAX_ITEMS


def _cu_constants(src):
    """The ``constexpr int`` constants of a .cu, evaluated in order."""
    import re

    env = {"INT_MAX": 2**31 - 1}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_the_c_entry_and_the_plan_agree_on_the_running_lists():
    """The .cu's ceiling of the running lists, its tiled kernel's step and
    both kernels' shared memory (run_smem_bytes, run_tiled_smem_bytes,
    evaluated from the source) are the plan's."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / "predictionio_tpu_torch"
           / "kernels" / "csrc" / "topk_streaming.cu").read_text()
    env = _cu_constants(src)
    assert env["kRunMaxKt"] == TOPK_RUN_MAX_KT == 256
    assert env["kStepTiles"] == TOPK_STEP_TILES
    assert env["kTiledChunk"] == TOPK_TILED_CHUNK
    assert env["kStepStride"] == TOPK_STEP_STRIDE
    assert env["kTiledBlocksPerSm"] == 2
    assert env["kTiledSparseMax"] == TOPK_TILED_SPARSE_MAX == 2 * SPARSE_MAX
    assert env["kPendMax"] == TOPK_PEND_MAX == 2 * TOPK_TILED_SPARSE_MAX
    assert [env[f"kStage1{n}"] for n in ("TileSort", "Run", "RunTiled")] == [0, 1, 2]
    # the select path has its own C entry (pio_topk_select), no stage-1 code
    assert TOPK_STAGE1 == ("tile_sort", "running_list", "running_list_tiled", "select")
    for fn, plan_name in (("run_smem_bytes", "running_list"),
                          ("run_tiled_smem_bytes", "running_list_tiled")):
        body = re.search(fn + r"\(int R, int kt\) \{\s*return ([^;]+);", src).group(1)
        for rank, kt in ((50, 256), (50, 129), (8, 16), (4000, 200)):
            want = eval(body.replace("/", "//"), {}, {**env, "R": rank, "kt": kt})  # noqa: S307
            plan = topk_launch_plan(64, 27000, kt, PLAN_SMS, rank, plan_name)
            assert plan.stage1_smem == want
    # the running lists are refused above K = kRunMaxKt, not kt (= min(K, 256))
    assert src.count("if (K > kRunMaxKt ||") == 2
    assert "T % kStepTiles != 0 && T != n_tiles" in src
