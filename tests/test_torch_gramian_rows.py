"""The build's rows path (128 < R <= GRAMIAN_ROWS_MAX_RANK), on the CPU.

``gramian_rows_kernel`` in ``csrc/gramian_fused.cu`` runs only on the
card, so what can be checked here is checked in Python: the path is picked
by the rank alone; the ceiling is the widest rank whose block fits in the
shared memory one block may opt into; :func:`gramian_rows_launch_plan`
passes ``pio_gramian_rows``' own check (transcribed, with the source's
constants) at every rank of the path; a pure-Python model of the thread ->
register-tile map covers the upper triangle of ``[A | b]`` exactly once;
and the numpy emulation of the summation order at the rows plan's chunks,
with the live slots of each step compacted as the kernel keeps them, is
held to the plain version and the JAX kernel within the build's tolerance.
"""

import functools
import re

import numpy as np
import pytest

from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    GRAMIAN_K_TILE,
    GRAMIAN_MAX_RANK,
    GRAMIAN_MIN_CHUNK,
    GRAMIAN_ROWS_MAX_RANK,
    gramian_launch_plan,
    gramian_plan,
    gramian_rows_launch_plan,
    gramian_wide_launch_plan,
)
from test_torch_gramian import BUCKETS, TOL, _data, _jax, _plain, emulate_gramian

#: (threads, kc, S, blocks, blocks an SM) of the tuned path's plan at R =
#: 128 for each of BUCKETS, as the parent tree computes them
PLANS_R128 = [(576, 32, 1, 17475, 1), (576, 128, 1, 97972, 1), (576, 512, 1, 18571, 1),
              (576, 2048, 1, 3277, 1), (576, 8192, 1, 583, 1), (576, 6560, 5, 610, 1),
              (576, 128, 1, 5023, 1), (576, 512, 1, 17257, 1), (576, 2048, 1, 3707, 1),
              (576, 8192, 1, 797, 1), (576, 32768, 1, 216, 1)]


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _source() -> str:
    import pathlib

    return (pathlib.Path(cuda_kernels.__file__).parent.parent
            / "kernels" / "csrc" / "gramian_fused.cu").read_text()


@functools.lru_cache(maxsize=None)
def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source()).group(1))


# -- the .cu's arithmetic, transcribed ----------------------------------------
def _cu_t(r):
    return _cdiv(r, _const("kRTile"))


def _cu_smem(r, stages):
    """``rows_smem_bytes`` of the .cu."""
    tile, t, meta = _const("kRTile"), _cu_t(r), _const("kRMeta")
    partial = tile * tile * (t * (t + 1) // 2) + tile * t
    return 4 * (partial + stages * _const("kKTile") * tile * t + 3 * meta * _const("kKTile")
                + meta + 1)


def _cu_max_r():
    """``rows_max_r`` of the .cu: the widest R whose two-step block fits."""
    r = _const("kMaxR")
    while _cu_smem(r + 1, 2) <= _const("kMaxSmem"):
        r += 1
    return r


def _rows_entry_accepts(plan, b, k, r):
    """``pio_gramian_rows``' check of a plan, transcribed."""
    items = _cu_t(r) * (_cu_t(r) + 1) // 2 + _cu_t(r)
    max_threads, max_rounds = _const("kRMaxThreads"), _const("kRMaxRounds")
    threads_ok = any(plan.threads == _cdiv(_cdiv(items, rounds), 32) * 32
                     for rounds in range(_cdiv(items, max_threads), max_rounds + 1))
    stages = (2 if plan.chunk_smem == _cu_smem(r, 2) else
              1 if plan.chunk_smem == _cu_smem(r, 1) else 0)
    s, kc = plan.n_chunks, plan.chunk
    return (_const("kMaxR") < r <= _cu_max_r() and b >= 1 and k >= 0
            and kc >= _const("kKTile") and kc % _const("kKTile") == 0
            and s == (-(-k // kc) if k > 0 else 1)
            and (s == 1 or kc >= _const("kMinChunk")) and threads_ok and stages > 0
            and b * s <= 2**31 - 1)


def test_the_ceiling_is_the_widest_rank_whose_block_fits():
    assert GRAMIAN_ROWS_MAX_RANK == _cu_max_r() >= 256
    assert cuda_kernels.GRAMIAN_MAX_SMEM == _const("kMaxSmem") == 232448
    assert cuda_kernels.gramian_rows_smem(GRAMIAN_ROWS_MAX_RANK) <= 232448
    assert cuda_kernels.gramian_rows_smem(GRAMIAN_ROWS_MAX_RANK + 1) > 232448
    for r in range(GRAMIAN_MAX_RANK + 1, GRAMIAN_ROWS_MAX_RANK + 2):
        for stages in (1, 2):
            assert cuda_kernels.gramian_rows_smem(r, stages=stages) == _cu_smem(r, stages)
        assert cuda_kernels.gramian_rows_partial(r) * 4 < _cu_smem(r, 1)


@pytest.mark.parametrize("r", [1, 50, 127, 128, 129, 136, 200, 256, GRAMIAN_ROWS_MAX_RANK,
                               GRAMIAN_ROWS_MAX_RANK + 1, 320, 512])
def test_the_path_is_picked_by_the_rank_alone(r):
    for b, k in BUCKETS + [(1, 1), (3, 0), (16, 8193)]:
        plan = gramian_plan(b, k, r, 132)
        want = ("tuned" if r <= GRAMIAN_MAX_RANK else
                "rows" if r <= GRAMIAN_ROWS_MAX_RANK else "wide")
        assert plan.path == want
        if r <= GRAMIAN_MAX_RANK:
            assert plan == gramian_launch_plan(b, k, r, 132)  # unchanged
        elif r > GRAMIAN_ROWS_MAX_RANK:
            assert plan == gramian_wide_launch_plan(b, k, r, 132)


def test_rank_128_plans_are_unchanged():
    """The tuned path's plans at every bucket are the parent tree's."""
    for (b, k), want in zip(BUCKETS, PLANS_R128):
        plan = gramian_plan(b, k, 128, 132)
        assert plan.path == "tuned" and plan == gramian_launch_plan(b, k, 128, 132)
        assert (plan.threads, plan.chunk, plan.n_chunks, plan.blocks,
                plan.blocks_per_sm) == want


@pytest.mark.parametrize("b", [1, 3, 216, 97972])
def test_rows_plan_passes_the_c_entry_points_check(b):
    for k in (0, 1, 33, 128, 257, 8193, 32768):
        for r in range(GRAMIAN_MAX_RANK + 1, GRAMIAN_ROWS_MAX_RANK + 2):
            if r > GRAMIAN_ROWS_MAX_RANK:
                with pytest.raises(ValueError, match="no gramian rows launch plan"):
                    gramian_rows_launch_plan(b, k, r, 132)
                assert not _rows_entry_accepts(gramian_wide_launch_plan(b, k, r, 132), b, k, r)
                continue
            plan = gramian_rows_launch_plan(b, k, r, 132)
            assert plan.path == "rows"
            assert _rows_entry_accepts(plan, b, k, r), (b, k, r, plan)
            assert plan.blocks == b * plan.n_chunks
            assert plan.partial == cuda_kernels.gramian_rows_partial(r)
            if plan.n_chunks > 1:
                assert plan.scratch_shape == (b, plan.n_chunks, plan.partial)
                assert b < cuda_kernels.GRAMIAN_ROWS_WAVES * plan.blocks_per_sm * 132
            else:
                assert plan.scratch_shape == (0, 0, 0)


def test_rows_plan_shape_follows_the_blocks_an_sm_holds():
    """One step of rows and twice the rounds of register tiles a thread
    where that fits more blocks on an SM (on an H100: R <= 200 but 161-168),
    else two steps at the fewest rounds; the blocks an SM holds follow from
    the registers and the shared memory."""
    picks = {}
    for r in range(GRAMIAN_MAX_RANK + 1, GRAMIAN_ROWS_MAX_RANK + 1):
        stages, threads, per_sm = cuda_kernels.gramian_rows_shape(r)
        picks[r] = stages
        two = cuda_kernels.gramian_rows_threads(r)
        per_sm_two = cuda_kernels.gramian_rows_blocks_per_sm(
            two, cuda_kernels.gramian_rows_smem(r, stages=2))
        if stages == 1:
            assert per_sm > per_sm_two and threads == cuda_kernels.gramian_rows_threads(
                r, rounds=2 * _cdiv(cuda_kernels.gramian_rows_tiles(r)[1], 512))
        else:
            assert (threads, per_sm) == (two, per_sm_two)
        assert threads % 32 == 0 and threads <= _const("kRMaxThreads")
        _, items = cuda_kernels.gramian_rows_tiles(r)
        assert threads * _const("kRMaxRounds") >= items
        assert per_sm >= 1
        plan = gramian_rows_launch_plan(97972, 128, r, 132)
        assert (plan.threads, plan.blocks_per_sm) == (threads, per_sm)
        assert plan.chunk_smem == cuda_kernels.gramian_rows_smem(r, stages=stages)
    assert [picks[r] for r in (129, 160, 161, 168, 169, 200, 201, 256, 272)] == [
        1, 1, 2, 2, 1, 1, 2, 2, 2]


def test_rows_plan_splits_only_the_few_row_buckets_and_forces_chunks():
    for r in (129, 200, 256):
        users = gramian_rows_launch_plan(97972, 128, r, 132)
        assert users.n_chunks == 1 and users.chunk == 128
        items = gramian_rows_launch_plan(216, 32768, r, 132)
        assert items.n_chunks > 1 and items.chunk >= GRAMIAN_MIN_CHUNK
        # PR 12's tile kernel at the rows plan's chunks: the same kc and S
        tile = gramian_wide_launch_plan(216, 32768, r, 132, chunk=items.chunk)
        assert (tile.chunk, tile.n_chunks) == (items.chunk, items.n_chunks)
        assert tile.path == "wide" and tile.scratch_shape[:2] == (216, items.n_chunks)
        forced = gramian_wide_launch_plan(97972, 128, r, 132, chunk=users.chunk)
        assert (forced.chunk, forced.n_chunks) == (128, 1)
    for bad in (0, 31, 48):
        with pytest.raises(ValueError, match="multiple of"):
            gramian_wide_launch_plan(4, 100, 200, 132, chunk=bad)
    with pytest.raises(ValueError, match="at least"):
        gramian_wide_launch_plan(4, 1000, 200, 132, chunk=64)


@pytest.mark.parametrize("args", [(0, 8, 200, 132), (4, -1, 200, 132), (4, 8, 128, 132),
                                  (4, 8, 200, 0), (4, 8, GRAMIAN_ROWS_MAX_RANK + 1, 132)])
def test_rows_plan_refuses_bad_inputs(args):
    with pytest.raises(ValueError, match="no gramian rows launch plan"):
        gramian_rows_launch_plan(*args)


def test_the_new_constants_are_the_plans():
    assert _const("kRTile") == cuda_kernels.GRAMIAN_ROWS_TILE == 8
    assert _const("kRGroup") == cuda_kernels.GRAMIAN_ROWS_GROUP
    assert _const("kRMaxThreads") == cuda_kernels.GRAMIAN_ROWS_MAX_THREADS
    assert _const("kRMaxRounds") == cuda_kernels.GRAMIAN_ROWS_MAX_ROUNDS
    assert _const("kRMeta") == cuda_kernels.GRAMIAN_ROWS_META
    assert set(cuda_kernels.GRAMIAN_ROWS_REGS) == {
        k for k in cuda_kernels.GRAMIAN_KERNELS if k.startswith("rows")}
    # the launch bound: 65,536 registers over kRMaxThreads threads
    assert all(0 < regs <= 65536 // _const("kRMaxThreads")
               for regs in cuda_kernels.GRAMIAN_ROWS_REGS.values())


# -- the thread -> register-tile map -------------------------------------------
def rows_tile(it, t, group=None):
    """``rows_tile`` of the .cu: tile ``it`` of A's upper triangle as block
    (bi, bj), groups of kRGroup block rows walked column by column."""
    group = group or _const("kRGroup")
    r0, g = 0, min(group, t)
    while True:
        count = g * (g + 1) // 2 + g * (t - r0 - g)
        if it < count:
            break
        it -= count
        r0 += g
        g = min(group, t - r0)
    tri = g * (g + 1) // 2
    if it < tri:
        c = 0
        while it > c:
            it -= c + 1
            c += 1
        return r0 + it, r0 + c
    it -= tri
    c = it // g
    return r0 + it - c * g, r0 + g + c


def _cover(r):
    """How often each entry of [A | b] (rows < R, columns <= R) is owned,
    and the register tiles that own no entry the output needs."""
    tile = _const("kRTile")
    t = _cu_t(r)
    na = t * (t + 1) // 2
    seen = np.zeros((r, r + 1), int)
    idle = 0
    for it in range(na + t):
        if it < na:
            bi, bj = rows_tile(it, t)
            assert 0 <= bi <= bj < t
            i = np.arange(bi * tile, (bi + 1) * tile)[:, None]
            j = np.arange(bj * tile, (bj + 1) * tile)[None, :]
            own = (i <= j) & (i < r) & (j < r)  # A's upper triangle
        else:
            ib = it - na
            i = np.arange(ib * tile, (ib + 1) * tile)[:, None]
            j = np.full((1, 1), r)  # b, column R
            own = i < r
        ii, jj = np.broadcast_arrays(i, j)
        seen[ii[own], jj[own]] += 1
        idle += not own.any()
    return seen, idle


@pytest.mark.parametrize("r", range(GRAMIAN_MAX_RANK + 1, GRAMIAN_ROWS_MAX_RANK + 1))
def test_the_thread_map_covers_the_upper_triangle_of_a_and_b_once(r):
    seen, idle = _cover(r)
    upper = np.triu(np.ones((r, r + 1), bool))
    upper[:, r] = True
    assert (seen[upper] == 1).all() and (seen[~upper] == 0).all()
    assert idle == 0  # no register tile sits on the padding alone


def test_the_thread_map_keeps_a_warps_tiles_in_few_block_rows_and_columns():
    """A full warp's 32 tiles span about kRGroup block rows and 32 / kRGroup
    block columns (a group's last columns and the short last groups spread
    them further), so their shared loads of y_i and y_j are few: on average
    under 6 and 10, against 1 and 32 (or 32 and 1) in row- or column-major
    order."""
    for r in (129, 200, 256, GRAMIAN_ROWS_MAX_RANK):
        t = _cu_t(r)
        na = t * (t + 1) // 2
        tiles = [rows_tile(it, t) for it in range(na)]
        warps = [tiles[w0:w0 + 32] for w0 in range(0, na - 31, 32)]
        rows = [len({bi for bi, _ in w}) for w in warps]
        cols = [len({bj for _, bj in w}) for w in warps]
        assert np.mean(rows) < 6 and np.mean(cols) < 10, (r, np.mean(rows), np.mean(cols))
        assert max(rows) + max(cols) <= 20
        assert len(set(tiles)) == na


# -- the summation order at the rows plan's chunks -----------------------------
def emulate_rows(y, idx, w2, rhs, ridge, yty, kc):
    """:func:`emulate_gramian`'s order with each step's live slots compacted
    (the kernel keeps only slots with a weight, in slot order): a dead slot
    adds exactly zero, so the bits are the same."""
    y = np.asarray(y, np.float32)
    bsz, k = idx.shape
    n, r = y.shape
    live_all = (w2 != 0) | (rhs != 0)
    iu = np.triu_indices(r)
    a_out = np.empty((bsz, r, r), np.float32)
    b_out = np.empty((bsz, r), np.float32)
    for row in range(bsz):
        tri = np.zeros(len(iu[0]), np.float32)
        bv = np.zeros(r, np.float32)
        for c0 in range(0, max(k, 1), kc):
            live = live_all[row, c0:c0 + kc]
            acc_a = np.zeros((r, r), np.float32)
            acc_b = np.zeros(r, np.float32)
            for s0 in range(0, len(live), GRAMIAN_K_TILE):
                slots = c0 + s0 + np.flatnonzero(live[s0:s0 + GRAMIAN_K_TILE])
                if not slots.size:
                    continue
                t_a = np.zeros((r, r), np.float32)
                t_b = np.zeros(r, np.float32)
                for kk in slots:
                    j = idx[row, kk]
                    g = y[j] if 0 <= j < n else np.zeros(r, np.float32)
                    t_a += np.outer(g, np.float32(w2[row, kk]) * g)
                    t_b += g * np.float32(rhs[row, kk])
                acc_a += t_a
                acc_b += t_b
            tri += acc_a[iu]
            bv += acc_b
        a = np.zeros((r, r), np.float32)
        a[iu] = tri
        a = np.triu(a) + np.triu(a, 1).T
        if yty is not None:
            a += np.triu(yty) + np.triu(yty, 1).T
        a[np.diag_indices(r)] += np.float32(ridge[row])
        a_out[row], b_out[row] = a, bv
    return a_out, b_out


@pytest.mark.parametrize("b,k,n,r,with_yty", [
    (3, 300, 30, 136, False),
    (2, 700, 25, 200, True),
    (3, 130, 20, 129, True),
])
def test_the_emulation_at_the_rows_plans_chunks_matches_plain_and_jax(b, k, n, r, with_yty):
    y, idx, w2, rhs, ridge = _data(b, k, n, r, seed=r + k)
    yty = (y.T @ y).astype(np.float32) if with_yty else None
    a_p, b_p = _plain(y, idx, w2, rhs, ridge, yty)
    for kc in (gramian_rows_launch_plan(b, k, r, 132).chunk, 256):
        a, bv = emulate_rows(y, idx, w2, rhs, ridge, yty, kc)
        # compacting the live slots keeps the bits of the uncompacted order
        a_u, b_u, _ = emulate_gramian(y, idx, w2, rhs, ridge, yty, kc)
        np.testing.assert_array_equal(a, a_u)
        np.testing.assert_array_equal(bv, b_u)
        np.testing.assert_array_equal(a, np.transpose(a, (0, 2, 1)))
        np.testing.assert_allclose(a, a_p, **TOL)
        np.testing.assert_allclose(bv, b_p, **TOL)
    if r % 8 == 0:
        a_j, b_j = _jax(y, idx, w2, rhs, ridge, yty)
        np.testing.assert_allclose(a, a_j, **TOL)
        np.testing.assert_allclose(bv, b_j, **TOL)
