"""The wide streamed attention path (320 < D <= 512), on the CPU.

``csrc/flash_attention.cu``'s ``flash_attention_wide_streamed_kernel`` runs
only on the card, so what can be checked here is checked in Python: its
constants against the source, :func:`flash_wide_streamed_launch_plan` (pure
arithmetic) against the C entry's check transcribed with the source's own
constants, the widest head against its register plan and a block's shared
memory, the choice of path by the head width alone, the thread maps at 512
threads (S in 2 rows x 4 keys a thread, O in 2 rows x G float4 column
groups) and the shared-memory banks their loads touch, and a numpy float32
emulation of the kernel's order: q pre-scaled by 1/sqrt(D), each score one
FMA chain over D in ascending order continued from one K chunk to the next,
every 64-key tile masked, the row max, ``exp``, the streamed path's sum of a
row, ``l = fma(l, corr, sum)``, O scaled by ``corr`` and then P·V key by key,
one V chunk at a time. The emulation is held against the JAX
``flash_attention_pallas`` (interpret mode) and
``flash_attention_fwd_reference`` at rtol 2e-4 / atol 2e-5, the JAX
``TestFlashPallas`` tolerance, and at D <= 320 bit for bit against the
streamed path's emulation.
"""

import functools
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import flash_attention_pallas as jax_flash_attention_pallas
from predictionio_tpu_torch.ops import cuda_kernels as ck
from test_torch_flash_streamed import emulate_flash_streamed
from test_torch_flash_wide import SRC, _const, _fma, _qkv, _wavefronts

RTOL, ATOL = 2e-4, 2e-5
D_MAX = ck.FLASH_WIDE_STREAMED_MAX_D
D_STR = ck.FLASH_STREAMED_MAX_D
THREADS = ck.FLASH_WIDE_STREAMED_THREADS
K_STRIDE = ck.FLASH_WIDE_STREAMED_K_CHUNK + ck.FLASH_PAD
V_STRIDE = ck.FLASH_WIDE_STREAMED_V_CHUNK + ck.FLASH_PAD

BODY = SRC[SRC.index("flash_attention_wide_streamed_kernel(const"):]
BODY = BODY[:BODY.index("\nstatic_assert")]


def test_constants_are_the_kernels():
    assert _const("kWSRows") == ck.FLASH_WIDE_STREAMED_ROWS == 64
    assert _const("kWSKeys") == ck.FLASH_WIDE_STREAMED_KEYS == 64
    assert _const("kWSThreads") == THREADS == 512
    assert _const("kWSKChunk") == ck.FLASH_WIDE_STREAMED_K_CHUNK
    assert _const("kWSVChunk") == ck.FLASH_WIDE_STREAMED_V_CHUNK
    assert _const("kWSStages") == ck.FLASH_WIDE_STREAMED_STAGES
    assert _const("kWSGroups") == ck.FLASH_WIDE_STREAMED_GROUPS
    assert _const("kWSMaxD") == D_MAX >= 512
    assert "constexpr int kWSKStride = kWSKChunk + 4;" in SRC
    assert "constexpr int kWSVStride = kWSVChunk + 4;" in SRC
    assert "return kWSKeys * (kWSKStride > kWSVStride ? kWSKStride : kWSVStride);" in SRC
    assert ("return kWSRows * (res_width(d) + kPad) + kWSStages * ws_buffer_floats() +\n"
            "         kWSRows * kRPStride + 2 * kWSRows;") in SRC
    params = re.search(r'extern "C" int pio_flash_attention_wide_streamed\(([^)]*)\)',
                       SRC).group(1)
    assert len(params.split(",")) == len(
        ck._EXTRA_ENTRIES["flash_attention"]["pio_flash_attention_wide_streamed"])
    # the launch bound of one block an SM allows the registers the plan assumes
    assert "__launch_bounds__(kWSThreads, 1)" in SRC
    assert 65536 // _const("kWSThreads") >= ck.FLASH_WIDE_STREAMED_REGS


def _c_entry_accepts(plan, bh, lq, d):
    """``pio_flash_attention_wide_streamed``'s check of a plan, transcribed,
    with the source's own constants."""
    rows, keys, pad = _const("kWSRows"), _const("kWSKeys"), _const("kPad")
    if not _const("kMaxD") < d <= _const("kWSMaxD"):
        return False
    w = -(-d // 8) * 8
    buffer = keys * (max(_const("kWSKChunk"), _const("kWSVChunk")) + 4)
    smem = 4 * (rows * (w + pad) + _const("kWSStages") * buffer
                + rows * _const("kRPStride") + 2 * rows)
    blocks = -(-lq // rows) * bh
    return (plan.blocks == blocks <= 2**31 - 1 and plan.threads == _const("kWSThreads")
            and plan.smem == smem <= _const("kMaxSmem"))


#: (b, h, lq, lk): the training shape, the long shape, one row, a ragged pair
PLAN_SHAPES = [(64, 4, 64, 64), (8, 4, 2048, 2048), (1, 1, 1, 1), (3, 2, 70, 300)]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("d", [321, 330, 384, 448, 502, 512])
def test_plan_is_accepted_by_the_c_entry(d, sm_count):
    for b, h, lq, lk in PLAN_SHAPES:
        plan = ck.flash_wide_streamed_launch_plan(b, h, lq, lk, d, sm_count,
                                                  ck.FLASH_WIDE_STREAMED_REGS)
        assert plan.path == "wide_streamed" and plan.passes == 1
        assert plan.q_tiles == -(-lq // 64) and plan.kv_tiles == -(-lk // 64)
        assert plan.blocks == b * h * plan.q_tiles and plan.blocks_per_sm == 1
        assert plan.waves == -(-plan.blocks // sm_count)
        assert plan.s_tile == (2, 4) and plan.o_tile == (2, 4 * ck.FLASH_WIDE_STREAMED_GROUPS)
        assert _c_entry_accepts(plan, b * h, lq, d), (b, h, lq, d, plan)


@pytest.mark.parametrize("regs,sm_count,per_sm", [(128, 132, 1), (64, 132, 1), (96, 114, 1)])
def test_plan_follows_the_card_and_the_registers(regs, sm_count, per_sm):
    """Blocks an SM from the registers read off the card and the shared
    memory, waves from the card's SMs: at D = 384 one block an SM even at
    64 registers, since two blocks' shared memory does not fit."""
    plan = ck.flash_wide_streamed_launch_plan(8, 4, 2048, 2048, 384, sm_count, regs)
    assert plan.regs == regs and plan.blocks_per_sm == per_sm
    assert plan.waves == -(-1024 // (sm_count * per_sm))
    assert 2 * (plan.smem + 1024) > 233472


def test_the_widest_head_fits_a_block_and_its_register_plan():
    """Every width up to kWSMaxD fits a block's shared memory with O in
    kWSGroups float4 column groups a thread; the next width would need one
    more group, so the register plan, not shared memory, bounds the path."""
    for d in range(D_STR + 1, D_MAX + 1):
        assert ck.flash_wide_streamed_smem_bytes(d) <= ck.FLASH_MAX_SMEM, d
        assert -(-d // 64) <= ck.FLASH_WIDE_STREAMED_GROUPS, d
    assert 64 * ck.FLASH_WIDE_STREAMED_GROUPS == D_MAX
    assert ck.flash_wide_streamed_smem_bytes(D_MAX + 8) <= ck.FLASH_MAX_SMEM
    assert "kWSGroups * 64 == kWSMaxD" in SRC
    assert "ws_smem_floats(kWSMaxD) * 4 <= kMaxSmem" in SRC


@pytest.mark.parametrize("d", [1, 64, 128, D_MAX + 1, 1024])
def test_plan_refuses_widths_outside_the_path(d):
    with pytest.raises(ValueError, match="no flash wide streamed launch plan"):
        ck.flash_wide_streamed_launch_plan(1, 1, 8, 8, d, 132, ck.FLASH_WIDE_STREAMED_REGS)


@pytest.mark.parametrize("d,path", [(D_STR, "streamed"), (D_STR + 1, "wide_streamed"),
                                    (384, "wide_streamed"), (502, "wide_streamed"),
                                    (D_MAX, "wide_streamed"), (D_MAX + 1, "cluster"),
                                    (1024, "cluster"), (ck.FLASH_CLUSTER_MAX_D + 1, "passes"),
                                    (1536, "passes")])
def test_flash_plan_for_picks_the_path_by_the_head_width_alone(d, path, monkeypatch):
    monkeypatch.setattr(ck, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(ck, "_flash_streamed_regs", lambda index: 216)
    monkeypatch.setattr(ck, "_flash_wide_streamed_regs", lambda index: 120)
    monkeypatch.setattr(ck, "_flash_cluster_regs", lambda index: 128)
    for b, h, lq, lk in ((64, 4, 64, 64), (1, 1, 1, 1), (8, 4, 2048, 2048)):
        q = torch.zeros((b, h, lq, d), device="meta")
        k = torch.zeros((b, h, lk, d), device="meta")
        plan = ck.flash_plan_for(q, k, False)
        assert plan.path == path
        if path == "wide_streamed":
            assert plan.regs == 120 and plan.smem == ck.flash_wide_streamed_smem_bytes(d)


# -- the thread maps and the banks they touch ----------------------------------
def s_map(tid):
    """Rows and keys of the thread's S micro-tile: rows 2 (tid / 16) + i,
    keys kx + 16 t with kx = lane % 16, so a row sits in one half-warp."""
    row0 = 2 * (tid // 16)
    return [row0 + i for i in range(2)], [tid % 16 + 16 * t for t in range(4)]


def o_map(tid):
    """Rows and columns of the thread's O micro-tile: rows pr + 32 i, and
    in column group g the float4 at 4 cx + 64 g, with 8 rows × 4 column
    groups to a warp."""
    warp, lane = divmod(tid, 32)
    pr, cx = (warp // 4) * 8 + lane // 4, (warp % 4) * 4 + lane % 4
    cols = [64 * g + 4 * cx + x for g in range(ck.FLASH_WIDE_STREAMED_GROUPS) for x in range(4)]
    return [pr + 32 * i for i in range(2)], cols


def test_the_kernel_uses_these_maps():
    assert "const int kx = lane & 15;" in BODY
    assert "const int s_row0 = 2 * (tid >> 4);" in BODY
    assert "const int pr = (warp >> 2) * 8 + (lane >> 2);" in BODY
    assert "const int cx = (warp & 3) * 4 + (lane & 3);" in BODY
    assert "q_c + (s_row0 + i) * ds + x" in BODY
    assert "s_k + (kx + 16 * t) * kWSKStride + x" in BODY
    assert "s_p + (pr + 32 * i) * kRPStride + kk" in BODY
    assert "next_chunk(n0 + nk + g0 / kGroupsPerV) + 4 * cx;" in BODY
    assert "s_v + (kk + u) * kWSVStride + 64 * gg" in BODY
    assert "const int c = 4 * (cx + 16 * g);" in BODY


def test_thread_maps_cover_every_score_and_output_column_once():
    scores, outs = {}, {}
    for tid in range(THREADS):
        rows, keys = s_map(tid)
        for r in rows:
            for t in keys:
                scores[(r, t)] = scores.get((r, t), 0) + 1
        rows, cols = o_map(tid)
        for r in rows:
            for c in cols:
                outs[(r, c)] = outs.get((r, c), 0) + 1
    assert set(scores) == {(r, t) for r in range(64) for t in range(64)}
    assert set(scores.values()) == {1}
    assert set(outs) == {(r, c) for r in range(64) for c in range(D_MAX)}
    assert set(outs.values()) == {1}
    # a row of S sits in one half-warp: its max and sum take four shuffles
    # in the streamed path's order (the same keys kx + 16 t a thread)
    for half in range(THREADS // 16):
        lanes = range(16 * half, 16 * half + 16)
        assert len({tuple(s_map(t)[0]) for t in lanes}) == 1
        assert sorted(s_map(t)[1][0] for t in lanes) == list(range(16))


@pytest.mark.parametrize("d", [330, 384, 448, 502, D_MAX])
def test_every_load_instruction_takes_the_fewest_passes(d):
    """Q, K, P and V loads of a warp: one pass for Q (2 rows), P (8 rows)
    and V (4 column groups), two for K (16 keys, 256 bytes)."""
    ds = -(-d // 8) * 8 + ck.FLASH_PAD
    ps = ck.FLASH_WIDE_RES_P_STRIDE
    for warp in range(THREADS // 32):
        lanes = range(32 * warp, 32 * warp + 32)
        for i in range(2):
            assert _wavefronts([s_map(t)[0][i] * ds + 8 for t in lanes]) == 1
            assert _wavefronts([o_map(t)[0][i] * ps + 4 for t in lanes]) == 1
        for j in range(4):
            assert _wavefronts([s_map(t)[1][j] * K_STRIDE + 8 for t in lanes]) == 2
        for g in range(ck.FLASH_WIDE_STREAMED_GROUPS):
            col = [o_map(t)[1][4 * g] for t in lanes]
            in_chunk = [c % ck.FLASH_WIDE_STREAMED_V_CHUNK for c in col]
            assert _wavefronts([5 * V_STRIDE + c for c in in_chunk]) == 1


# -- the kernel's arithmetic, emulated -----------------------------------------
def emulate_flash_wide_streamed(q, k, v, causal):
    """The wide streamed kernel's forward in its order (every head and row
    of a 64-row query tile at once): per key tile K's chunks of kWSKChunk
    columns in ascending order, each score's FMA chain running on from
    chunk to chunk over D rounded up to 8 (zeros past D), then the masks and
    a row's sum as the streamed path takes it (a thread's 4 keys in t
    order, then four xor shuffles across the 16 threads of the row), then
    V's chunks of kWSVChunk columns, each column key by key. The card's
    expf is within 2 ulp; here it is numpy's."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bh, rows, bk = b * h, 64, 64
    k_chunk, v_chunk = _const("kWSKChunk"), _const("kWSVChunk")
    w = -(-d // 8) * 8
    qscale = np.float32(1.0 / np.sqrt(np.float64(d)))
    pad = ((0, 0), (0, 0), (0, w - d))
    q = np.pad((np.asarray(q, np.float32).reshape(bh, lq, d) * qscale).astype(np.float32), pad)
    k = np.pad(np.asarray(k, np.float32).reshape(bh, lk, d), pad)
    v = np.pad(np.asarray(v, np.float32).reshape(bh, lk, d), pad)
    n_kv = -(-lk // bk)
    neg = np.float32(-1e30)
    lane = np.arange(16)
    out = np.zeros((bh, lq, d), np.float32)
    for qt in range(-(-lq // rows)):
        q0 = qt * rows
        n_rows = min(rows, lq - q0)
        q_tile = np.zeros((bh, rows, w), np.float32)
        q_tile[:, :n_rows] = q[:, q0:q0 + n_rows]
        m = np.full((bh, rows), neg, np.float32)
        l = np.zeros((bh, rows), np.float32)
        acc = np.zeros((bh, rows, w), np.float32)
        hi = min((q0 + rows + bk - 1) // bk, n_kv) if causal else n_kv
        for kt in range(hi):
            k0 = kt * bk
            valid = min(bk, lk - k0)
            s = np.zeros((bh, rows, bk), np.float32)
            for c0 in range(0, w, k_chunk):
                k_part = np.zeros((bh, bk, min(k_chunk, w - c0)), np.float32)
                k_part[:, :valid] = k[:, k0:k0 + valid, c0:c0 + k_chunk]
                for c in range(k_part.shape[2]):
                    s = _fma(q_tile[:, :, c0 + c, None], k_part[:, None, :, c], s)
            q_pos = q0 + np.arange(rows)[:, None]
            k_pos = k0 + np.arange(bk)[None, :]
            keep = (k_pos < lk) & ((q_pos >= k_pos) if causal else True)
            s = np.where(keep, s, neg)
            m_new = np.maximum(m, s.max(axis=-1))
            corr = np.exp(m - m_new).astype(np.float32)
            p = np.exp(s - m_new[..., None]).astype(np.float32)
            by_thread = p.reshape(bh, rows, 4, 16)  # [t, kx]: key kx + 16 t
            part = np.zeros((bh, rows, 16), np.float32)
            for t in range(4):
                part = (part + by_thread[:, :, t, :]).astype(np.float32)
            for shift in (1, 2, 4, 8):  # __shfl_xor_sync across kx
                part = (part + part[..., lane ^ shift]).astype(np.float32)
            l = _fma(l, corr, part[..., 0])
            m = m_new
            acc = (acc * corr[..., None]).astype(np.float32)
            for c0 in range(0, w, v_chunk):
                v_part = np.zeros((bh, bk, min(v_chunk, w - c0)), np.float32)
                v_part[:, :valid] = v[:, k0:k0 + valid, c0:c0 + v_chunk]
                part_o = acc[..., c0:c0 + v_chunk]
                for key in range(bk):
                    part_o = _fma(p[:, :, key, None], v_part[:, None, key, :], part_o)
                acc[..., c0:c0 + v_chunk] = part_o
        o = (acc / np.maximum(l, np.float32(1e-30))[..., None]).astype(np.float32)
        out[:, q0:q0 + n_rows] = o[:, :n_rows, :d]
    return out.reshape(b, h, lq, d)


@functools.lru_cache(maxsize=None)
def _jax_out(shape, causal):
    q, k, v = _qkv(*shape, seed=shape[4])
    return np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=16,
                                                 block_k=16))


#: (b, h, lq, lk, d): Lq != Lk, Lk not a multiple of 64, two query tiles,
#: D = 384 (six whole chunks), 502 (the last chunk 56 columns; copied 4 bytes
#: at a time on the card) and the widest head
EMULATED = [(1, 2, 70, 100, 384), (1, 1, 100, 70, 502), (2, 1, 33, 130, D_MAX)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_jax_and_the_plain_version(shape, causal):
    q, k, v = _qkv(*shape, seed=shape[4])
    got = emulate_flash_wide_streamed(q, k, v, causal)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_out(shape, causal), rtol=RTOL, atol=ATOL)
    plain = ck.flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [280, 302, D_STR])
def test_at_streamed_widths_the_order_is_the_streamed_paths_bit_for_bit(d, causal):
    """A plan forcing the wide streamed path at D <= 320 gives the streamed
    kernel's bits: the same FMA chains in the same order, whatever the
    chunk widths."""
    q, k, v = _qkv(1, 1, 70, 100, d, seed=5)
    assert np.array_equal(emulate_flash_wide_streamed(q, k, v, causal),
                          emulate_flash_streamed(q, k, v, causal))


def test_the_kernel_sums_a_row_in_the_emulated_order():
    """Four xor shuffles across the 16 threads of a row, for the max and
    the sum; l = fma(l, corr, sum); O scaled once a tile, at its first V
    chunk; o / max(l, 1e-30); expf; no atomics."""
    for shift in (1, 2, 4, 8):
        assert f"sum += __shfl_xor_sync(0xffffffffu, sum, {shift});" in BODY
        assert f"mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, {shift}));" in BODY
    assert "l[i] = fmaf(l[i], corr, sum);" in BODY
    assert "if (g0 == 0) {" in BODY and "const float corr = s_corr[pr + 32 * i];" in BODY
    assert "fmaxf(s_l[pr + 32 * i], 1e-30f)" in BODY
    assert "expf(" in BODY and "exp2f" not in BODY
    assert "atomic" not in BODY


def test_the_c_entry_scales_by_the_true_width_and_copies_by_alignment():
    entry = SRC[SRC.index('extern "C" int pio_flash_attention_wide_streamed('):]
    entry = entry[:entry.index("\n}\n")]
    assert "static_cast<float>(1.0 / std::sqrt(width))" in entry
    assert "const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);" \
        in entry
    assert "D <= kMaxD || D > kWSMaxD" in entry
    assert "smem != ws_smem_floats(D) * static_cast<int>(sizeof(float))" in entry


@pytest.mark.parametrize("d", [321, 384, D_MAX])
def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing(d):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 20, 30, d, seed=d))
    before = ck.flash_attention_fwd.launches
    by_path = dict(ck.flash_attention_fwd.launches_by_path)
    got = ck.flash_attention_fwd(q, k, v, True)
    assert ck.flash_attention_fwd.launches == before
    assert ck.flash_attention_fwd.launches_by_path == by_path
    assert torch.equal(got, ck.flash_attention_fwd_reference(q, k, v, True))
