"""The streaming top-k's select path (256 < k <= TOPK_SELECT_MAX_K).

Three parts, none of which needs the card:

- the launch plan picks the path by k alone, and the plans at k <= 256 are
  the ones the tree had before the path (a frozen copy of that plan is held
  against ``topk_launch_plan`` at every earlier plan case);
- its scratch (a row of scores and a histogram a query) and the batch
  slices that keep it within ``TOPK_MAX_SCRATCH_BYTES``; the .cu's
  constants and shared-memory formulas evaluated against the plan;
- a numpy emulation of the select's exact arithmetic on the plain
  version's ``[B, N]`` scores (the canonical order keys, the 11 / 11 / 10
  bit histograms and their boundaries, the gather, ties at an exact key
  taken by index, the bitonic network on packed keys), held bit for bit
  against ``top_k_streaming_reference`` on tie-heavy inputs;

and the port's fused entry at k = 300 and 1,024 against the JAX package's
(on the CPU both run their plain paths: the JAX kernel in interpret mode).
Tolerance there: scores rtol/atol 1e-5, ids equal or tied.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import scoring as jax_scoring
from predictionio_tpu_torch.ops import scoring
from predictionio_tpu_torch.ops.cuda_kernels import (
    TOPK_BLOCK_SMEM_RESERVE,
    TOPK_BLOCKS_PER_SM,
    TOPK_MAX_SCRATCH_BYTES,
    TOPK_MAX_SMEM,
    TOPK_RUN_MAX_KT,
    TOPK_RUN_NARROW_MAX_K,
    TOPK_SELECT_BINS,
    TOPK_SELECT_BLOCKS_PER_SM,
    TOPK_SELECT_MAX_K,
    TOPK_SELECT_MIN_SURVIVORS,
    TOPK_SELECT_THREADS,
    TOPK_SM_SMEM,
    TOPK_STAGE1,
    TOPK_STEP_TILES,
    TOPK_TILE_ITEMS,
    TOPK_TILE_QUERIES,
    TOPK_TILED_BLOCKS_PER_SM,
    top_k_streaming,
    top_k_streaming_reference,
    topk_batch_slices,
    topk_launch_plan,
    topk_run_smem,
    topk_run_tiled_smem,
    topk_scratch_bytes,
    topk_select_row,
    topk_select_score_smem,
    topk_select_smem,
    topk_select_survivors,
)

from test_torch_topk import _cu_constants, _fused_case, _t, assert_agree

SMS, RANK = 132, 50
CU = (pathlib.Path(__file__).resolve().parents[1] / "predictionio_tpu_torch" / "kernels"
      / "csrc" / "topk_streaming.cu")


# -- the launch plan -----------------------------------------------------------------
def _plan_before_select(b, n_items, k_eff, sm_count, rank):
    """The launch plan as the tree computed it before the select path, for
    k <= 256 (the running lists; the per-tile sort where their shared
    memory does not fit), written out."""
    cdiv = lambda a, d: -(-a // d)  # noqa: E731
    kt = min(k_eff, TOPK_TILE_ITEMS)
    n_tiles = cdiv(n_items, TOPK_TILE_ITEMS)
    n_query_tiles = cdiv(b, TOPK_TILE_QUERIES)
    stage1 = "running_list" if k_eff <= TOPK_RUN_NARROW_MAX_K else "running_list_tiled"
    smem = (topk_run_smem(rank, kt) if stage1 == "running_list"
            else topk_run_tiled_smem(rank, kt))
    if smem > TOPK_MAX_SMEM:
        stage1, smem, tiles, n_runs = "tile_sort", 0, 1, n_tiles
    else:
        per_sm = TOPK_BLOCKS_PER_SM if stage1 == "running_list" else TOPK_TILED_BLOCKS_PER_SM
        resident = min(per_sm, TOPK_SM_SMEM // (smem + TOPK_BLOCK_SMEM_RESERVE))
        n_runs = (resident * sm_count) // n_query_tiles
        tiles = cdiv(n_tiles, min(max(1, n_runs), n_tiles))
        if stage1 == "running_list_tiled":
            tiles = min(n_tiles, cdiv(tiles, TOPK_STEP_TILES) * TOPK_STEP_TILES)
        n_runs = cdiv(n_tiles, tiles)
    keys = n_runs * kt
    return dict(kt=kt, n_tiles=n_tiles, tiles_per_block=tiles, n_runs=n_runs,
                query_tile=TOPK_TILE_QUERIES, n_query_tiles=n_query_tiles,
                scratch_shape=(b, n_runs, kt), stage1=stage1, stage1_smem=smem,
                merge_smem=16 * keys if 16 * keys <= TOPK_MAX_SMEM else 0,
                merge_threads=64 if keys <= 128 else 256 if keys <= 1024 else 1024,
                survivors=0)


@pytest.mark.parametrize("n", [10, 1000, 27000, 1000000])
@pytest.mark.parametrize("k", [8, 16, 128, 129, 200, 256])
@pytest.mark.parametrize("b", [1, 8, 64, 512, 1024, 4096])
def test_plans_at_k_up_to_256_are_unchanged(b, k, n):
    k_eff = min(k, n)
    assert topk_launch_plan(b, n, k_eff, SMS, RANK)._asdict() == _plan_before_select(
        b, n, k_eff, SMS, RANK)


@pytest.mark.parametrize("k", [257, 300, 512, 1024, 2048, 4096, 8192, 13000,
                               TOPK_SELECT_MAX_K, TOPK_SELECT_MAX_K + 1, 27000])
@pytest.mark.parametrize("b,n", [(1, 27000), (64, 5000), (64, 27000), (1024, 27000),
                                 (4, 1 << 20)])
def test_the_plan_picks_select_by_k_alone(b, n, k):
    k_eff = min(k, n)
    plan = topk_launch_plan(b, n, k_eff, SMS, RANK)
    if k_eff <= TOPK_RUN_MAX_KT:
        assert plan.stage1 in ("running_list", "running_list_tiled")
        return
    if k_eff > TOPK_SELECT_MAX_K:  # above the ceiling the per-tile sort stays
        assert plan.stage1 == "tile_sort" and plan.survivors == 0
        assert plan.tiles_per_block == 1 and plan.n_runs == plan.n_tiles
        return
    assert plan.stage1 == "select"
    assert plan.kt == TOPK_TILE_ITEMS
    assert plan.stage1_smem == topk_select_score_smem(RANK)
    assert plan.survivors == topk_select_survivors(k_eff)
    assert k_eff <= plan.survivors <= TOPK_SELECT_MAX_K
    assert plan.merge_smem == topk_select_smem(plan.survivors) <= TOPK_MAX_SMEM
    assert plan.merge_threads == TOPK_SELECT_THREADS
    assert plan.scratch_shape == (b, 1, topk_select_row(n))
    # the scoring blocks walk runs of whole steps as the tiled running list
    # does: one wave of blocks at two an SM (launch bound and shared memory)
    resident = min(TOPK_SELECT_BLOCKS_PER_SM, TOPK_SM_SMEM // (plan.stage1_smem + 1024))
    assert resident == 2
    assert (plan.tiles_per_block % TOPK_STEP_TILES == 0
            or plan.tiles_per_block == plan.n_tiles)
    assert plan.n_runs == -(-plan.n_tiles // plan.tiles_per_block)
    assert (plan.n_runs - 1) * plan.tiles_per_block < plan.n_tiles
    if plan.n_tiles * plan.n_query_tiles <= resident * SMS:
        assert plan.tiles_per_block == min(TOPK_STEP_TILES, plan.n_tiles)
    else:
        assert plan.n_runs * plan.n_query_tiles <= resident * SMS or plan.n_runs == 1
    if (b, n) == (1024, 27000):
        assert (plan.tiles_per_block, plan.n_runs) == (56, 2)


def test_survivors_and_the_ceiling():
    """The survivor buffer is the sort's length for k keys, a power of two
    (2,048 at least), and the ceiling is the longest power of two whose
    packed keys (8 bytes) and histogram fit one block's shared memory."""
    assert [topk_select_survivors(k) for k in (1, 257, 300, 1024, 1025, 2049, 4096, 8192,
                                               8193, TOPK_SELECT_MAX_K)] == [
        2048, 2048, 2048, 2048, 2048, 4096, 4096, 8192, 16384, 16384]
    longest = 1
    while topk_select_smem(2 * longest) <= TOPK_MAX_SMEM:
        longest *= 2
    assert TOPK_SELECT_MAX_K == longest == 16384
    assert topk_select_smem(TOPK_SELECT_MAX_K) == 8 * 16384 + 4 * (2048 + 64)


def test_a_forced_select_is_planned_or_refused():
    # any k up to the ceiling may be forced, k <= 256 too
    for k in (1, 16, 256, 257, TOPK_SELECT_MAX_K):
        plan = topk_launch_plan(64, 27000, k, SMS, RANK, "select")
        assert plan.stage1 == "select" and plan.survivors >= k
    with pytest.raises(ValueError):
        topk_launch_plan(64, 27000, TOPK_SELECT_MAX_K + 1, SMS, RANK, "select")
    # q rows that do not fit in the scoring block's shared memory: the plan
    # sorts every tile, a forced select is refused
    assert topk_launch_plan(64, 27000, 1024, SMS, 8000).stage1 == "tile_sort"
    with pytest.raises(ValueError):
        topk_launch_plan(64, 27000, 1024, SMS, 8000, "select")
    # the per-tile sort stays forceable below the ceiling, for the card's checks
    assert topk_launch_plan(64, 27000, 1024, SMS, RANK, "tile_sort").stage1 == "tile_sort"
    assert TOPK_STAGE1[-1] == "select"
    # the CPU answers a forced select with the plain version
    q, items = torch.ones((2, 4)), torch.arange(2400.0).reshape(600, 4)
    got = top_k_streaming(q, items, 300, stage1="select")
    assert torch.equal(got[1][:, :3], torch.tensor([[599, 598, 597]] * 2, dtype=torch.int32))


# -- scratch and slices ----------------------------------------------------------------
def test_candidate_generation_batch_is_one_launch():
    """B = 1,024 over 27,000 items at k = 1,024: a row of 27,000 scores and
    2,048 counts a query, 119 MB, one launch (the per-tile sort keeps 222 MB
    of lists and 444 MB with the merge in device memory)."""
    b, n, k = 1024, 27000, 1024
    plan = topk_launch_plan(b, n, k, SMS, RANK)
    assert plan.stage1 == "select"
    assert topk_scratch_bytes(plan) == 4 * b * (27000 + 2048)
    assert topk_batch_slices(b, n_items=n, k_eff=k, rank=RANK, sm_count=SMS) == [(0, b)]
    per_tile = topk_launch_plan(b, n, k, SMS, RANK, "tile_sort")
    assert topk_scratch_bytes(per_tile) == b * 106 * 256 * 16
    assert topk_select_row(27001) == 27004 + TOPK_SELECT_BINS


@pytest.mark.parametrize("b,n,k", [(262144, 27000, 512), (100000, 5000, 4096),
                                   (40000, 1 << 20, 300), (20, 1 << 29, 16384)])
def test_select_plans_are_cut_to_the_scratch_budget(b, n, k):
    got = topk_batch_slices(b, n_items=n, k_eff=k, rank=RANK, sm_count=SMS)
    assert got[0][0] == 0 and got[-1][1] == b
    assert all(stop == nxt for (_, stop), (nxt, _) in zip(got, got[1:]))
    rows = got[0][1]
    assert rows % TOPK_TILE_QUERIES == 0 or rows == b
    for start, stop in got:
        plan = topk_launch_plan(stop - start, n, k, SMS, RANK)
        assert plan.stage1 == "select"
        assert (topk_scratch_bytes(plan) <= TOPK_MAX_SCRATCH_BYTES
                or stop - start <= TOPK_TILE_QUERIES)
    per_query = 4 * topk_select_row(n)
    if rows < b and rows > TOPK_TILE_QUERIES:  # as many query tiles as fit, no fewer
        assert (rows + TOPK_TILE_QUERIES) * per_query > TOPK_MAX_SCRATCH_BYTES
    if (b, n) == (262144, 27000):
        assert rows == 18480 and len(got) == 15


def _src():
    return CU.read_text()


def test_the_c_entry_and_the_plan_agree_on_the_select_path():
    src = _src()
    env = _cu_constants(src)
    assert env["kSelectBins"] == TOPK_SELECT_BINS == 2048
    assert env["kSelectLastBins"] == 1024
    assert env["kSelectThreads"] == TOPK_SELECT_THREADS
    assert env["kSelectMaxKeys"] == TOPK_SELECT_MAX_K
    # the shortest sort, two 256-key segments, fits the smallest buffer
    assert env["kSortMin"] == 512 <= TOPK_SELECT_MIN_SURVIVORS == topk_select_survivors(1)
    body = re.search(r"select_score_smem_bytes\(int R\) \{\s*return ([^;]+);", src).group(1)
    for rank in (1, 8, 50, 4000):
        assert eval(body.replace("/", "//"), {}, {**env, "R": rank}) == (  # noqa: S307
            topk_select_score_smem(rank))
    body = re.search(r"select_smem_bytes\(int survivors\) \{\s*return ([^;]+);", src).group(1)
    for survivors in (2048, 8192, TOPK_SELECT_MAX_K):
        assert eval(body, {}, {**env, "survivors": survivors}) == (  # noqa: S307
            topk_select_smem(survivors))
    entry = src[src.index('extern "C" int pio_topk_select('):]
    entry = entry[:entry.index("\n}\n")]
    for rule in ("K > kSelectMaxKeys", "survivors < K", "ld != ((N + 3) & ~3)",
                 "select_smem != select_smem_bytes(survivors)",
                 "score_smem != select_score_smem_bytes(R)"):
        assert rule in entry
    # no fallback: a refused plan launches nothing, and nothing else is called
    assert "topk_tile_kernel" not in entry and "pio_topk_streaming(" not in entry
    # the refinements count the boundary bin's keys on bits 10..20, then the
    # k-th key's 22-bit prefix on bits 0..9, as the emulation does
    assert "refine_counts(row, N, prefix, 21, 10, s_hist);" in src
    assert "refine_counts(row, N, prefix, 10, 0, s_hist);" in src
    assert env["kSelectScoreBlocksPerSm"] == TOPK_SELECT_BLOCKS_PER_SM
    # the rules the contract names: canonical zeros, integer-only counts
    assert "s == 0.f ? 0.f : s" in src
    select = src[src.index("topk_select_score_kernel("):src.index('extern "C"')]
    assert "atomicAdd(&s_hist[" in select and "atomicAdd(&hist[" in select
    assert "float* s_hist" not in select and "atomicAdd(&s_keys" not in select


# -- the select's arithmetic, step by step in numpy -------------------------------------
LAST_BINS, THREADS = 1024, TOPK_SELECT_THREADS


def order_key(s):
    """order_key: the canonical score (-0.0 as +0.0) as a uint32 whose
    unsigned order is the scores' order."""
    s = np.where(s == 0, np.float32(0), s).astype(np.float32)
    u = s.view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def key_score(key):
    u = np.where(key & np.uint32(0x80000000), key & np.uint32(0x7fffffff), ~key)
    return u.astype(np.uint32).view(np.float32)


def find_boundary(h, need):
    """find_boundary as the block runs it: thread t sums nb / THREADS bins
    from the top, the sums are scanned, the thread whose bins reach
    ``need`` walks them. Returns (bin, keys in the bins above it)."""
    nb = len(h)
    per = nb // THREADS
    desc = h[::-1].astype(np.int64)
    sums = desc.reshape(THREADS, per).sum(axis=1)
    above = np.concatenate([[0], np.cumsum(sums)[:-1]])
    (t,) = np.flatnonzero((above < need) & (above + sums >= need))
    acc = above[t]
    for i in range(per):
        c = desc[t * per + i]
        if acc + c >= need:
            return nb - 1 - (t * per + i), int(acc)
        acc += c
    raise AssertionError("no boundary")


def bitonic_sort(s):
    """block_sort's network on packed keys: every merge size, every stride,
    a pair ascending when its lower index has the size bit clear (the
    segment passes in registers and the block-wide passes run these same
    stages in this order)."""
    s = s.copy()
    n = len(s)
    assert n >= 512 and n & (n - 1) == 0
    idx = np.arange(n)
    size = 2
    while size <= n:
        stride = size >> 1
        while stride > 0:
            a = idx[(idx & stride) == 0]
            x, y = s[a], s[a + stride]
            up = (a & size) == 0
            lo, hi = np.minimum(x, y), np.maximum(x, y)
            s[a], s[a + stride] = np.where(up, lo, hi), np.where(up, hi, lo)
            stride >>= 1
        size <<= 1
    return s


def emulate_select(scores, k, excl=None, survivors=None):
    """(scores [B, k] f32, ids [B, k] i32, the refinement level each row
    reached) as the select path computes them from the ``[B, N]`` scores."""
    b, n = scores.shape
    cap = survivors or topk_select_survivors(k)
    masked = scores.astype(np.float32).copy()
    if excl is not None:
        for row in range(b):
            hit = excl[row][(excl[row] >= 0) & (excl[row] < n)]
            masked[row, hit] = -np.inf
    out_s = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.int32)
    levels = []
    j = np.arange(n, dtype=np.uint64)
    for row in range(b):
        keys = order_key(masked[row])
        h = np.bincount(keys >> 21, minlength=TOPK_SELECT_BINS)
        prefix, above = find_boundary(h, k)
        count, shift, level = above + h[prefix], 21, 0
        if count > cap:
            sub = keys[(keys >> 21) == prefix]
            h = np.bincount((sub >> 10) & 2047, minlength=TOPK_SELECT_BINS)
            bin1, more = find_boundary(h, k - above)
            prefix, above = (prefix << 11) | bin1, above + more
            count, shift, level = above + h[bin1], 10, 1
            if count > cap:
                sub = keys[(keys >> 10) == prefix]
                h = np.bincount(sub & 1023, minlength=LAST_BINS)
                bin2, more = find_boundary(h, k - above)
                prefix, above = (prefix << 10) | bin2, above + more
                count, shift, level = k, 0, 2
        if shift:
            take = np.flatnonzero((keys >> shift) >= prefix)
            assert len(take) == count
        else:  # an exact key: those above it, then its ties lowest index first
            above_it = np.flatnonzero(keys > prefix)
            assert len(above_it) == above
            take = np.concatenate([above_it,
                                   np.flatnonzero(keys == prefix)[:k - above]])
        assert k <= len(take) <= cap
        packed = ((~keys[take]).astype(np.uint64) << np.uint64(32)) | j[take]
        p = 512
        while p < len(take):
            p <<= 1
        padded = np.full(p, np.iinfo(np.uint64).max, np.uint64)
        padded[:len(take)] = np.random.default_rng(row).permutation(packed)  # gather order
        best = bitonic_sort(padded)[:k]
        s = key_score((~(best >> np.uint64(32))).astype(np.uint32))
        out_s[row] = s
        out_i[row] = np.where(np.isneginf(s), -1, (best & np.uint64(0xffffffff)).astype(np.int64))
        levels.append(level)
    return out_s, out_i, levels


def _select_case(name):
    """(q, items, k, excl, survivors or None, the scores the emulation is
    given or None for the plain product, the levels every row must reach)."""
    rng = np.random.default_rng(31)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    if name == "random":
        return normal(5, 8), normal(3000, 8), 500, None, None, None, {0}
    if name == "random_exclusions":
        excl = rng.integers(-1, 4000, size=(4, 64)).astype(np.int32)
        return normal(4, 8), normal(4000, 8), 1024, excl, None, None, {0}
    if name == "duplicated_rows":
        items = normal(1500, 6)
        items[1::2] = items[0::2]
        return normal(6, 6), items, 700, None, None, None, None
    if name == "rising_scores":
        q = np.abs(normal(3, 4)) + 0.5
        items = np.arange(3000, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
        return q, items, 400, None, None, None, None
    if name == "identical_rows_k300":  # all N scores tie: every level, then index order
        return normal(4, 8), np.tile(normal(1, 8), (2500, 1)), 300, None, None, None, {2}
    if name == "signed_zeros_at_the_boundary":  # 10,000 keys from the zero bin up
        items = np.concatenate([np.abs(normal(2000, 1)) + 0.25, np.zeros((8000, 1), np.float32),
                                -np.abs(normal(2000, 1)) - 0.25])[rng.permutation(12000)]
        return np.ones((2, 1), np.float32), items, 2500, None, None, "signed_zeros", {2}
    if name == "fewer_finite_than_k":
        excl = np.full((3, 590), -1, np.int32)
        excl[0] = np.arange(590)
        excl[1, :500] = rng.permutation(600)[:500]
        return normal(3, 8), normal(600, 8), 300, excl, None, None, None
    if name == "k_is_n_minus_1":
        return normal(3, 8), normal(601, 8), 600, None, None, None, {0}
    if name == "three_levels_distinct_low_bits":  # one top-22-bit prefix, keys differ below
        m = rng.integers(0, 1024, size=3000).astype(np.float32)
        items = (np.float32(1) + m * np.float32(2.0 ** -23))[:, None]
        return np.array([[1.0], [2.0]], np.float32), items, 300, None, None, None, {2}
    if name == "level_one_suffices":  # one top-11-bit bin, spread over the next 11
        items = (np.float32(1) + rng.random(5000).astype(np.float32) * np.float32(0.2))[:, None]
        return np.ones((2, 1), np.float32), items, 300, None, None, None, {1}
    if name == "k4096_buffer_of_k":  # the buffer is k itself: one or two more passes
        return normal(3, 8), normal(5000, 8), 4096, None, None, None, {1}
    raise KeyError(name)


SELECT_CASES = ["random", "random_exclusions", "duplicated_rows", "rising_scores",
                "identical_rows_k300", "signed_zeros_at_the_boundary",
                "fewer_finite_than_k", "k_is_n_minus_1", "three_levels_distinct_low_bits",
                "level_one_suffices", "k4096_buffer_of_k"]


@pytest.mark.parametrize("name", SELECT_CASES)
def test_select_emulated_equals_plain(name):
    q, items, k, excl, survivors, scores_of, levels = _select_case(name)
    n = items.shape[0]
    scores = (_t(q) @ _t(items).T).numpy()  # the plain version's product
    if scores_of == "signed_zeros":  # the kernel may see either sign of a zero
        zeros = np.argwhere(scores == 0)
        flip = zeros[np.random.default_rng(5).random(len(zeros)) < 0.5]
        scores[flip[:, 0], flip[:, 1]] = np.float32(-0.0)
        assert np.signbit(scores[scores == 0]).any() and not np.signbit(
            scores[scores == 0]).all()
    got_s, got_i, got_levels = emulate_select(scores, min(k, n), excl, survivors)
    want_s, want_i = top_k_streaming_reference(
        _t(q), _t(items), k, None if excl is None else _t(excl))
    np.testing.assert_array_equal(got_s, want_s.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    if levels is not None:
        assert set(got_levels) == levels, got_levels
    if name in ("identical_rows_k300", "signed_zeros_at_the_boundary"):
        # ties at the k-th key: the lowest indices, in index order
        tied = got_s[0] == got_s[0, -1]
        assert (np.diff(got_i[0][tied]) > 0).all()
    if name == "identical_rows_k300":
        assert (got_i == np.arange(300)).all()
    if name == "fewer_finite_than_k":
        assert (got_i[0, 10:] == -1).all() and (got_i[1, 100:] == -1).all()


@pytest.mark.parametrize("n", [512, 1024, 4096, 16384])
def test_the_bitonic_network_sorts_packed_keys(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    keys[: n // 4] = keys[n // 4: n // 2]  # repeats sort too
    np.testing.assert_array_equal(bitonic_sort(keys), np.sort(keys))


def test_order_keys_follow_the_scores():
    s = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    keys = order_key(s)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4]  # -0.0 is +0.0
    np.testing.assert_array_equal(key_score(keys), np.where(s == 0, np.float32(0), s))


# -- the port against the JAX package at 256 < k ------------------------------------------
@pytest.mark.parametrize("n,k,excluded", [(3000, 300, True), (5000, 1024, False)])
def test_select_k_is_answered_like_jax(n, k, excluded):
    """A served ``num`` of 300 or 1,024 (the select path's k on the card):
    the port's fused entry answers as the JAX package's fused top-k does
    (ids equal but for near-ties, scores rtol/atol 1e-5)."""
    uf, itf, uidx = _fused_case(n, b=3, seed=26 + k)
    assert topk_launch_plan(3, n, k, SMS, 8).stage1 == "select"
    excl = (np.random.default_rng(27).integers(-1, n, size=(3, 40)).astype(np.int32)
            if excluded else None)
    port = scoring.top_k_for_users_fused(_t(uf), _t(itf), _t(uidx), k=k,
                                         exclude_idx=None if excl is None else _t(excl),
                                         mode="always")
    ref = jax_scoring.top_k_for_users_fused(uf, itf, uidx, k=k, exclude_idx=excl, mode="auto")
    assert port[0].shape == (3, k)
    assert_agree(port, ref)


def test_the_knockout_markers_are_in_the_source():
    """``chip_smoke.py``'s knock-outs and trials of the select path cut or
    swap statements of the .cu by their text: each must be found."""
    import chip_smoke

    src = _src()
    for name, (anchor, marker, _) in chip_smoke.TOPK_SELECT_PHASES.items():
        assert marker in src[src.index(anchor):], name
    for name, swaps in chip_smoke.TOPK_SELECT_TRIALS.items():
        for old, _ in swaps:
            assert old in src, name
