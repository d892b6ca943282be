"""The gather + Gramian kernel's launch plan and arithmetic order, on the CPU.

``csrc/gramian_fused.cu`` runs only on the card, so what can be checked
here is checked in Python: :func:`gramian_launch_plan` (pure arithmetic,
checked again by the C entry point) at every bucket shape of the ALS
training slice, and a numpy emulation of the order in which the kernel
adds: each 32-rating tile summed from zero, trimmed at its last slot with
a weight and skipped when it has none; tiles added into a chunk partial
from zero; a row's chunk partials added in chunk order; then ``yty`` and
``ridge·I`` once. The emulation is held against the plain version and
the JAX kernel (interpret mode, as ``tests/test_torch_als_kernels.py``
runs it) at the build's tolerance, rtol/atol 1e-4.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas_kernels import gramian_fused as jax_gramian_fused
from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    GRAMIAN_K_TILE,
    GRAMIAN_MAX_RANK,
    GRAMIAN_MIN_CHUNK,
    gramian_fused_reference,
    gramian_launch_plan,
    gramian_plan,
    gramian_row_slices,
    gramian_wide_launch_plan,
)

TOL = dict(rtol=1e-4, atol=1e-4)

#: (rows, width) of every bucket of both sides of the ALS training slice
#: (ML-20M shape, seed 0, 5 % held out, the default bucket widths)
BUCKETS = [
    (17475, 32), (97972, 128), (18571, 512), (3277, 2048), (583, 8192),
    (122, 32768), (5023, 128), (17257, 512), (3707, 2048), (797, 8192),
    (216, 32768),
]


# -- the launch plan -----------------------------------------------------------
def _check_plan(plan, b, k, r):
    kt = GRAMIAN_K_TILE
    t = -(-r // 4)
    assert plan.chunk % kt == 0 and plan.chunk >= kt
    assert plan.n_chunks == max(1, -(-k // plan.chunk))
    assert plan.n_chunks * plan.chunk >= k > (plan.n_chunks - 1) * plan.chunk or k == 0
    assert plan.blocks == b * plan.n_chunks
    assert plan.threads % 32 == 0 and plan.threads <= 576
    assert plan.threads >= t * (t + 1) // 2
    assert plan.partial == r * (r + 1) // 2 + r
    assert plan.blocks_per_sm >= 1
    if plan.n_chunks > 1:
        assert plan.chunk >= GRAMIAN_MIN_CHUNK
        assert plan.scratch_shape == (b, plan.n_chunks, plan.partial)
        assert plan.reduce_smem == 4 * plan.partial
    else:
        assert plan.scratch_shape == (0, 0, 0) and plan.reduce_smem == 0


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("b,k", BUCKETS)
def test_plan_is_valid_at_every_bucket_of_the_slice(b, k, sm_count):
    plan = gramian_launch_plan(b, k, 50, sm_count)
    _check_plan(plan, b, k, 50)
    resident = plan.blocks_per_sm * sm_count
    if b >= resident:
        assert plan.n_chunks == 1  # the rows alone fill the card: one pass
    else:
        assert plan.n_chunks > 1 and plan.blocks >= resident
    # the scratch of a split bucket stays a few tens of MB
    assert np.prod(plan.scratch_shape) * 4 < 64e6
    assert gramian_launch_plan.__wrapped__(b, k, 50, sm_count) == plan  # pure


def test_plan_splits_only_the_wide_buckets():
    """The K <= 2,048 buckets hold thousands of rows and take one pass;
    the K = 32,768 buckets (122 and 216 rows) are split. Whether the
    K = 8,192 buckets (583 and 797 rows) are depends on the blocks an SM
    holds, so on the kernel's registers."""
    for b, k in BUCKETS:
        plan = gramian_launch_plan(b, k, 50, 132)
        if k <= 2048:
            assert plan.n_chunks == 1
        if k == 32768:
            assert plan.n_chunks > 1


@pytest.mark.parametrize("r", [1, 4, 7, 8, 13, 24, 50, 64, 127, 128])
@pytest.mark.parametrize("b,k", [(1, 0), (1, 1), (3, 33), (1, 300), (7, 8193), (2, 32768),
                                 (5000, 300)])
def test_plan_is_valid_at_other_ranks_and_widths(b, k, r):
    _check_plan(gramian_launch_plan(b, k, r, 132), b, k, r)


def _c_entry_accepts(plan, b, k, r):
    """``pio_gramian_fused``'s check of a plan (csrc/gramian_fused.cu),
    transcribed, with the source's own constants."""
    src = (pathlib.Path(cuda_kernels.__file__).parent.parent
           / "kernels" / "csrc" / "gramian_fused.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kTile", "kKTile", "kMinChunk", "kMaxThreads")}
    tile, kt = const["kTile"], const["kKTile"]
    t, tc = (r + tile - 1) // tile, (r + tile) // tile
    blocks = t * (t + 1) // 2 + (t if tc > t else 0)
    part = r * (r + 1) // 2 + r
    s, kc = plan.n_chunks, plan.chunk
    tiles = kt * (t + tc) * tile + 6 * kt + 4
    smem = 4 * max(tiles, part if s > 1 else r * r + r)
    return (kc >= kt and kc % kt == 0 and s == (-(-k // kc) if k > 0 else 1)
            and (s == 1 or kc >= const["kMinChunk"])
            and plan.threads == -(-blocks // 32) * 32
            and plan.threads <= const["kMaxThreads"] and plan.chunk_smem == smem
            and plan.reduce_smem == (4 * part if s > 1 else 0))


@pytest.mark.parametrize("b", [1, 3, 64, 216, 5000, 97972])
def test_plan_passes_the_c_entry_points_check(b):
    for k in (0, 1, 31, 32, 33, 128, 257, 300, 513, 8193, 32768):
        for r in range(1, GRAMIAN_MAX_RANK + 1):
            plan = gramian_launch_plan(b, k, r, 132)
            assert _c_entry_accepts(plan, b, k, r), (b, k, r, plan)


@pytest.mark.parametrize("args", [
    (0, 8, 50, 132), (4, -1, 50, 132), (4, 8, 0, 132),
    (4, 8, GRAMIAN_MAX_RANK + 1, 132), (4, 8, 50, 0),
])
def test_plan_refuses_bad_inputs(args):
    with pytest.raises(ValueError, match="no gramian launch plan"):
        gramian_launch_plan(*args)


def test_plan_follows_the_card_and_the_blocks_an_sm_holds(monkeypatch):
    """The SM count comes from the card, and the blocks an SM holds from
    the kernel's registers: fewer SMs or more registers, narrower split."""
    wide = gramian_launch_plan(216, 32768, 50, 132)
    assert gramian_launch_plan(216, 32768, 50, 66).n_chunks < wide.n_chunks
    monkeypatch.setattr(cuda_kernels, "GRAMIAN_REGS", 2 * cuda_kernels.GRAMIAN_REGS)
    heavy = gramian_launch_plan.__wrapped__(216, 32768, 50, 132)
    assert heavy.blocks_per_sm < wide.blocks_per_sm
    assert heavy.n_chunks < wide.n_chunks


# -- the kernel's arithmetic order, emulated ----------------------------------
def emulate_gramian(y, idx, w2, rhs, ridge, yty, kc):
    """The kernel's sums in its order, in float32, one row at a time:
    per chunk of ``kc`` slots, the chunk ends after its last slot with a
    weight; per 32-slot tile, the tile ends after its last slot with a
    weight (none: skipped); a tile's A (upper triangle) and b are summed
    from zero slot by slot and added to the chunk's partial; the row's
    partials are added in chunk order, then ``yty`` and ``ridge·I``.
    Returns (A, b, tiles walked)."""
    y = np.asarray(y, np.float32)
    bsz, k = idx.shape
    n, r = y.shape
    n_chunks = max(1, -(-k // kc))
    iu = np.triu_indices(r)
    a_out = np.empty((bsz, r, r), np.float32)
    b_out = np.empty((bsz, r), np.float32)
    walked = 0
    for row in range(bsz):
        live = (w2[row] != 0) | (rhs[row] != 0)
        partials = []
        for c in range(n_chunks):
            c0, c1 = c * kc, min(k, (c + 1) * kc)
            hits = np.flatnonzero(live[c0:c1])
            kend = c0 + hits[-1] + 1 if hits.size else c0
            acc_a = np.zeros((r, r), np.float32)
            acc_b = np.zeros(r, np.float32)
            for k0 in range(c0, kend, GRAMIAN_K_TILE):
                tile = live[k0:min(kend, k0 + GRAMIAN_K_TILE)]
                if not tile.any():
                    continue
                walked += 1
                t_a = np.zeros((r, r), np.float32)
                t_b = np.zeros(r, np.float32)
                for kk in range(k0, k0 + np.flatnonzero(tile)[-1] + 1):
                    j = idx[row, kk]
                    g = (y[j] if live[kk] and 0 <= j < n else np.zeros(r, np.float32))
                    # rows of y times [w2 * y | rhs]: b is column R
                    t_a += np.outer(g, np.float32(w2[row, kk]) * g)
                    t_b += g * np.float32(rhs[row, kk])
                acc_a += t_a
                acc_b += t_b
            partials.append((acc_a[iu], acc_b))
        tri = np.zeros(len(iu[0]), np.float32)
        bv = np.zeros(r, np.float32)
        for p_a, p_b in partials:  # chunk order, from zero
            tri += p_a
            bv += p_b
        a = np.zeros((r, r), np.float32)
        a[iu] = tri
        a = np.triu(a) + np.triu(a, 1).T  # both triangles from one sum
        if yty is not None:
            up = np.triu(yty) + np.triu(yty, 1).T
            a += up
        a[np.diag_indices(r)] += np.float32(ridge[row])
        a_out[row], b_out[row] = a, bv
    return a_out, b_out, walked


def _data(b, k, n, r, seed=0):
    """Rows padded at their tails, as the ALS buckets are: row i keeps a
    random prefix of valid slots (some rows empty, one full); inside the
    prefix a few slots carry w2 = 0 or rhs = 0 alone (implicit style)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, r), dtype=np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    counts = rng.integers(0, k + 1, b)
    counts[0], counts[-1] = 0, k
    mask = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
    w2 = mask.copy()
    rhs = (rng.standard_normal((b, k)).astype(np.float32) + 3.0) * mask
    holes = rng.random((b, k)) < 0.1
    w2[holes & (rng.random((b, k)) < 0.5)] = 0.0
    rhs[holes & (w2 != 0)] = 0.0
    idx[mask == 0] = rng.integers(n, 2 * n, int((mask == 0).sum()))  # never read
    ridge = (0.05 * counts).astype(np.float32)
    return y, idx, w2, rhs, ridge


def _kc_for(k, n_chunks):
    return -(-k // (n_chunks * GRAMIAN_K_TILE)) * GRAMIAN_K_TILE


def _plain(y, idx, w2, rhs, ridge, yty=None):
    n = y.shape[0]
    safe = np.where((idx >= 0) & (idx < n), idx, 0).astype(np.int32)
    out = gramian_fused_reference(
        torch.from_numpy(y), torch.from_numpy(safe), torch.from_numpy(w2),
        torch.from_numpy(rhs), torch.from_numpy(ridge),
        None if yty is None else torch.from_numpy(yty))
    return tuple(t.numpy() for t in out)


def _jax(y, idx, w2, rhs, ridge, yty=None):
    n = y.shape[0]
    safe = np.where((idx >= 0) & (idx < n), idx, 0).astype(np.int32)
    out = jax_gramian_fused(
        jnp.asarray(y), jnp.asarray(safe), jnp.asarray(w2), jnp.asarray(rhs),
        jnp.asarray(ridge), None if yty is None else jnp.asarray(yty))
    return tuple(np.asarray(t) for t in out)


@pytest.mark.parametrize("n_chunks", [1, 2, 5])
@pytest.mark.parametrize("b,k,n,r,with_yty", [
    (6, 300, 40, 8, False),
    (5, 290, 30, 16, True),
    (4, 260, 25, 13, False),
])
def test_emulation_matches_plain_and_the_jax_kernel(n_chunks, b, k, n, r, with_yty):
    y, idx, w2, rhs, ridge = _data(b, k, n, r, seed=n_chunks + r)
    yty = (y.T @ y).astype(np.float32) if with_yty else None
    kc = _kc_for(k, n_chunks)
    assert max(1, -(-k // kc)) == n_chunks
    a, bv, _ = emulate_gramian(y, idx, w2, rhs, ridge, yty, kc)
    np.testing.assert_array_equal(a, np.transpose(a, (0, 2, 1)))
    a_p, b_p = _plain(y, idx, w2, rhs, ridge, yty)
    np.testing.assert_allclose(a, a_p, **TOL)
    np.testing.assert_allclose(bv, b_p, **TOL)
    if r % 8 == 0:  # the JAX kernel takes ranks in multiples of 8
        a_j, b_j = _jax(y, idx, w2, rhs, ridge, yty)
        np.testing.assert_allclose(a, a_j, **TOL)
        np.testing.assert_allclose(bv, b_j, **TOL)


def test_emulation_walks_only_tiles_with_weights():
    """Rows end inside a chunk and inside a tile; a row's only weights
    sit in its last chunk; one tile inside the prefix has none."""
    y, idx, w2, rhs, ridge = _data(4, 200, 20, 8, seed=9)
    w2[:], rhs[:] = 0.0, 0.0
    w2[0, :70], rhs[0, :70] = 1.0, 2.0    # ends in tile 2 of chunk 0 (kc = 128)
    w2[1, 190:], rhs[1, 190:] = 1.0, 1.0  # only in the last chunk: 2 of its 3 tiles
    w2[2, :100], rhs[2, :100] = 1.0, 1.0
    w2[2, 32:64], rhs[2, 32:64] = 0.0, 0.0  # a dead tile inside the prefix
    idx = np.where(w2 == 0, -5, np.arange(200) % 20).astype(np.int32)  # -5: never read
    _, _, walked = emulate_gramian(y, idx, w2, rhs, ridge, None, 128)
    assert walked == 3 + 2 + 3
    a, bv, _ = emulate_gramian(y, idx, w2, rhs, ridge, None, 128)
    a_p, b_p = _plain(y, idx, w2, rhs, ridge)
    np.testing.assert_allclose(a, a_p, **TOL)
    np.testing.assert_allclose(bv, b_p, **TOL)
    np.testing.assert_array_equal(a[3], np.diag(np.full(8, ridge[3])))


def test_emulation_keeps_zero_rows_exact_and_nan_in_its_row():
    y, idx, w2, rhs, ridge = _data(5, 130, 30, 8, seed=4)
    w2[1], rhs[1], ridge[1] = 0.0, 0.0, 0.0
    y[7] = np.nan
    only = np.zeros_like(w2, dtype=bool)
    only[3, 5] = True
    idx[~only & (idx == 7)] = 8
    idx[3, 5], w2[3, 5], rhs[3, 5] = 7, 1.0, 1.0
    runs = [emulate_gramian(y, idx, w2, rhs, ridge, None, 64) for _ in range(2)]
    a, bv, _ = runs[0]
    np.testing.assert_array_equal(a[1], 0.0)
    np.testing.assert_array_equal(bv[1], 0.0)
    assert np.isnan(a[3]).any() and np.isnan(bv[3]).any()
    others = [0, 1, 2, 4]
    assert np.isfinite(a[others]).all() and np.isfinite(bv[others]).all()
    a_p, b_p = _plain(y, idx, w2, rhs, ridge)
    np.testing.assert_allclose(a[others], a_p[others], **TOL)
    np.testing.assert_allclose(bv[others], b_p[others], **TOL)
    # no atomics, one order: two runs give the same bits
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


# -- the general-rank path (R > 128) -------------------------------------------------
def _wide_c_entry_accepts(plan, b, k, r):
    """``launch_wide``'s check of a plan (csrc/gramian_fused.cu),
    transcribed, with the source's own constants."""
    src = (pathlib.Path(cuda_kernels.__file__).parent.parent
           / "kernels" / "csrc" / "gramian_fused.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kKTile", "kMinChunk", "kWTile", "kWThreads", "kWMaxR", "kMaxR")}
    wt = const["kWTile"]
    tr, tcw = -(-r // wt), (r + wt) // wt
    n_tiles = tr * tcw - tr * (tr - 1) // 2
    s, kc = plan.n_chunks, plan.chunk
    return (const["kMaxR"] < r <= const["kWMaxR"] and kc >= const["kKTile"]
            and kc % const["kKTile"] == 0 and s == (-(-k // kc) if k > 0 else 1)
            and (s == 1 or kc >= const["kMinChunk"]) and plan.threads == const["kWThreads"]
            and plan.chunk_smem == 0 and plan.reduce_smem == 0
            and b * n_tiles * s <= 2**31 - 1 and plan.blocks == b * n_tiles * s
            and plan.tiles == n_tiles)


@pytest.mark.parametrize("b", [1, 3, 64, 216, 5000, 97972])
def test_wide_plan_passes_the_c_entry_points_check(b):
    for k in (0, 1, 33, 128, 257, 8193, 32768):
        for r in (129, 136, 150, 191, 192, 200, 255, 256, 257, 300, 384, 511, 512):
            plan = gramian_wide_launch_plan(b, k, r, 132)
            assert plan.path == "wide"
            assert _wide_c_entry_accepts(plan, b, k, r), (b, k, r, plan)
            if plan.n_chunks > 1:
                assert plan.scratch_shape == (b, plan.n_chunks, r * (r + 1) // 2 + r)
                assert b * plan.tiles < 4 * 132  # only when the tiles do not fill the card


def test_wide_tiles_cover_the_upper_triangle_of_a_and_b_once():
    for r in (129, 200, 256, 257, 320):
        wt = cuda_kernels.GRAMIAN_WIDE_TILE
        tcw = -(-(r + 1) // wt)
        seen = np.zeros((r, r + 1), int)
        t = 0
        for ti in range(-(-r // wt)):
            for tj in range(ti, tcw):
                t += 1
                block = seen[ti * wt:(ti + 1) * wt, tj * wt:(tj + 1) * wt]
                i = np.arange(ti * wt, ti * wt + block.shape[0])[:, None]
                j = np.arange(tj * wt, tj * wt + block.shape[1])[None, :]
                block += (i <= j) | (j == r)
        assert t == cuda_kernels.gramian_wide_tiles(r)
        upper = np.triu(np.ones((r, r + 1), bool))
        upper[:, r] = True
        assert (seen[upper] == 1).all() and (seen[~upper] == 0).all()


@pytest.mark.parametrize("r", [1, 50, 128, 129, 200, 256, 512])
def test_the_path_is_picked_by_the_rank_alone(r):
    for b, k in BUCKETS + [(1, 1), (3, 0)]:
        plan = gramian_plan(b, k, r, 132)
        assert plan.path == ("wide" if r > cuda_kernels.GRAMIAN_ROWS_MAX_RANK else
                             "rows" if r > GRAMIAN_MAX_RANK else "tuned")
        if r <= GRAMIAN_MAX_RANK:
            assert plan == gramian_launch_plan(b, k, r, 132)  # today's plan, unchanged


@pytest.mark.parametrize("args", [(4, 8, 128, 132), (4, 8, 50, 132), (0, 8, 200, 132),
                                  (4, -1, 200, 132), (4, 8, 200, 0), (4, 8, 46341, 132)])
def test_wide_plan_refuses_bad_inputs(args):
    with pytest.raises(ValueError, match="no gramian wide launch plan"):
        gramian_wide_launch_plan(*args)


@pytest.mark.parametrize("sm_count", [132, None])
def test_rank_50_and_128_buckets_stay_one_slice(sm_count):
    """Every bucket of ML-20M (both sides) keeps its one launch up to rank
    128, so today's shapes keep their launch counts (90 + 90 a run)."""
    for r in (50, 128):
        for b, k in BUCKETS:
            assert gramian_row_slices(b, k, r, sm_count) == [(0, b)], (b, k, r)


@pytest.mark.parametrize("sm_count", [132, None])
def test_rank_256_users_bucket_is_cut_to_the_budget(sm_count, monkeypatch):
    budget = cuda_kernels.ALS_SYSTEMS_MAX_BYTES
    for r, want in ((200, 2), (256, 4)):
        slices = gramian_row_slices(97972, 128, r, sm_count)
        assert len(slices) == want
        assert slices[0][0] == 0 and slices[-1][1] == 97972
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        sizes = [s1 - s0 for s0, s1 in slices]
        assert max(sizes) - min(sizes) <= 1  # evened out
        assert max(sizes) * 4 * (r * r + r) <= budget
    # a split bucket counts its scratch: tiny budgets cut to one row, never below
    assert gramian_row_slices(0, 8, 200) == []
    monkeypatch.setattr(cuda_kernels, "ALS_SYSTEMS_MAX_BYTES", 1)
    assert gramian_row_slices(3, 32768, 200, 132) == [(0, 1), (1, 2), (2, 3)]


@pytest.mark.parametrize("b,k,n,r,with_yty", [
    (3, 300, 30, 136, False),
    (2, 70, 25, 200, True),
])
def test_wide_emulation_matches_plain_and_the_jax_kernel(b, k, n, r, with_yty):
    """The general-rank path sums each entry as the tuned path does (the
    same per-rating fmaf, 32-rating tiles from zero, chunks in order), so
    the same emulation holds it, at its own plan's chunks."""
    y, idx, w2, rhs, ridge = _data(b, k, n, r, seed=r)
    yty = (y.T @ y).astype(np.float32) if with_yty else None
    for plan in (gramian_wide_launch_plan(b, k, r, 132),
                 gramian_wide_launch_plan(b, k, r, 132)._replace(chunk=128)):
        a, bv, _ = emulate_gramian(y, idx, w2, rhs, ridge, yty, plan.chunk)
        np.testing.assert_array_equal(a, np.transpose(a, (0, 2, 1)))
        a_p, b_p = _plain(y, idx, w2, rhs, ridge, yty)
        np.testing.assert_allclose(a, a_p, **TOL)
        np.testing.assert_allclose(bv, b_p, **TOL)
    if r % 8 == 0:
        a_j, b_j = _jax(y, idx, w2, rhs, ridge, yty)
        np.testing.assert_allclose(a, a_j, **TOL)
        np.testing.assert_allclose(bv, b_j, **TOL)
