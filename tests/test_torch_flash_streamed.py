"""The streamed wide-head attention path (272 < D <= 320), on the CPU.

``csrc/flash_attention.cu``'s ``flash_attention_streamed_kernel`` runs only
on the card, so what can be checked here is checked in Python: its
constants against the source, :func:`flash_streamed_launch_plan` (pure
arithmetic) against the C entry's check transcribed with the source's own
constants at every width it takes, the widest head against its register
plan and a block's shared memory, the choice of path by the head width
alone, the thread maps (the resident path's S map, and O's column group g
fed by V's column chunk g), and a numpy float32 emulation of the kernel's
order: q pre-scaled by 1/sqrt(D), each score one FMA chain over D in
ascending order continued from one 64-column chunk of K to the next, every
64-key tile masked, the row max, ``exp``, the resident path's sum of a
row, ``l = fma(l, corr, sum)``, O scaled by ``corr`` and then P·V key by
key, one 64-column chunk of V a column group. The emulation is held
against the JAX ``flash_attention_pallas`` (interpret mode) and
``flash_attention_fwd_reference`` at rtol 2e-4 / atol 2e-5, the JAX
``TestFlashPallas`` tolerance, and at D = 256 bit for bit against the
resident path's emulation.
"""

import functools
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import flash_attention_pallas as jax_flash_attention_pallas
from predictionio_tpu_torch.ops import cuda_kernels as ck
from test_torch_flash_wide import SRC, _const, _fma, _qkv, emulate_flash_resident, s_map

RTOL, ATOL = 2e-4, 2e-5
D_MAX = ck.FLASH_STREAMED_MAX_D
D_RES = ck.FLASH_WIDE_RES_MAX_D


def test_constants_are_the_kernels():
    assert _const("kSRows") == ck.FLASH_STREAMED_ROWS == 64
    assert _const("kSKeys") == ck.FLASH_STREAMED_KEYS == 64
    assert _const("kSThreads") == ck.FLASH_STREAMED_THREADS == 256
    assert _const("kSChunk") == ck.FLASH_STREAMED_CHUNK == 64
    assert _const("kSCStride") == ck.FLASH_STREAMED_C_STRIDE == 68
    assert _const("kSStages") == ck.FLASH_STREAMED_STAGES
    assert _const("kSGroups") == ck.FLASH_STREAMED_GROUPS == 5
    assert _const("kSMaxD") == D_MAX == 320
    assert ("return kSRows * (res_width(d) + kPad) + kSStages * kSKeys * kSCStride +\n"
            "         kSRows * kRPStride + 2 * kSRows;") in SRC
    params = re.search(r'extern "C" int pio_flash_attention_streamed\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(
        ck._EXTRA_ENTRIES["flash_attention"]["pio_flash_attention_streamed"])
    # the launch bound of one block an SM allows the registers the plan assumes
    assert "__launch_bounds__(kSThreads, 1)" in SRC
    assert 65536 // _const("kSThreads") >= ck.FLASH_STREAMED_REGS


def _c_entry_accepts(plan, bh, lq, d):
    """``pio_flash_attention_streamed``'s check of a plan, transcribed, with
    the source's own constants."""
    rows, keys, pad = _const("kSRows"), _const("kSKeys"), _const("kPad")
    if not _const("kMaxD") < d <= _const("kSMaxD"):
        return False
    w = -(-d // 8) * 8
    smem = 4 * (rows * (w + pad) + _const("kSStages") * keys * _const("kSCStride")
                + rows * _const("kRPStride") + 2 * rows)
    blocks = -(-lq // rows) * bh
    return (plan.blocks == blocks <= 2**31 - 1 and plan.threads == _const("kSThreads")
            and plan.smem == smem <= _const("kMaxSmem"))


#: (b, h, lq, lk): the training shape, the long shape, one row, a ragged pair
PLAN_SHAPES = [(64, 4, 64, 64), (8, 4, 2048, 2048), (1, 1, 1, 1), (3, 2, 70, 300)]


@pytest.mark.parametrize("sm_count", [132, 78])
def test_plan_is_accepted_by_the_c_entry_at_every_width(sm_count):
    for d in range(D_RES + 1, D_MAX + 1):
        for b, h, lq, lk in PLAN_SHAPES:
            plan = ck.flash_streamed_launch_plan(b, h, lq, lk, d, sm_count,
                                                 ck.FLASH_STREAMED_REGS)
            assert plan.path == "streamed" and plan.passes == 1
            assert plan.q_tiles == -(-lq // 64) and plan.kv_tiles == -(-lk // 64)
            assert plan.blocks == b * h * plan.q_tiles and plan.blocks_per_sm == 1
            assert plan.waves == -(-plan.blocks // sm_count)
            assert plan.o_tile == (4, 20) and plan.s_tile == (4, 4)
            assert _c_entry_accepts(plan, b * h, lq, d), (b, h, lq, d, plan)


@pytest.mark.parametrize("regs,sm_count,per_sm", [(216, 132, 1), (128, 132, 1), (64, 78, 1)])
def test_plan_follows_the_card_and_the_registers(regs, sm_count, per_sm):
    """Blocks an SM from the registers read off the card and the shared
    memory, waves from the card's SMs: at D = 320 one block an SM even at
    64 registers, since two blocks' shared memory does not fit."""
    plan = ck.flash_streamed_launch_plan(8, 4, 2048, 2048, 320, sm_count, regs)
    assert plan.regs == regs and plan.blocks_per_sm == per_sm
    assert plan.waves == -(-1024 // (sm_count * per_sm))
    assert 2 * (plan.smem + 1024) > 233472


def test_the_widest_head_fits_a_block_and_its_register_plan():
    """Every width up to kSMaxD fits a block's shared memory with O in
    kSGroups float4 column groups a thread; the next width (kSMaxD + 8, a
    whole 8-float row more) would need a sixth group, so the register plan,
    not shared memory, is what bounds the path."""
    for d in range(ck.FLASH_MAX_D + 1, D_MAX + 1):
        assert ck.flash_streamed_smem_bytes(d) <= ck.FLASH_MAX_SMEM, d
        assert ck.flash_resident_groups(d) <= ck.FLASH_STREAMED_GROUPS, d
        assert 64 * ck.FLASH_STREAMED_GROUPS >= -(-d // 8) * 8, d
    assert ck.flash_resident_groups(D_MAX + 8) > ck.FLASH_STREAMED_GROUPS
    assert ck.flash_streamed_smem_bytes(D_MAX + 8) <= ck.FLASH_MAX_SMEM
    assert "res_groups(kSMaxD + 8) > kSGroups" in SRC
    assert "str_smem_floats(kSMaxD) * 4 <= kMaxSmem" in SRC


@pytest.mark.parametrize("d", [1, 64, 128, D_MAX + 1, 512])
def test_plan_refuses_widths_outside_the_path(d):
    with pytest.raises(ValueError, match="no flash streamed launch plan"):
        ck.flash_streamed_launch_plan(1, 1, 8, 8, d, 132, ck.FLASH_STREAMED_REGS)


@pytest.mark.parametrize("d,path", [(128, "tuned"), (129, "resident"), (272, "resident"),
                                    (273, "streamed"), (302, "streamed"), (320, "streamed"),
                                    (321, "wide_streamed")])
def test_flash_plan_for_picks_the_path_by_the_head_width_alone(d, path, monkeypatch):
    monkeypatch.setattr(ck, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(ck, "_flash_regs", lambda index: {key: 96 for key in ck.FLASH_KERNELS})
    monkeypatch.setattr(ck, "_flash_resident_regs",
                        lambda index: {g: 160 + g for g in ck.FLASH_WIDE_RES_REGS})
    monkeypatch.setattr(ck, "_flash_streamed_regs", lambda index: 250)
    monkeypatch.setattr(ck, "_flash_wide_streamed_regs", lambda index: 128)
    for b, h, lq, lk in ((64, 4, 64, 64), (1, 1, 1, 1), (8, 4, 2048, 2048)):
        q = torch.zeros((b, h, lq, d), device="meta")
        k = torch.zeros((b, h, lk, d), device="meta")
        plan = ck.flash_plan_for(q, k, False)
        assert plan.path == path
        if path == "streamed":
            assert plan.regs == 250 and plan.smem == ck.flash_streamed_smem_bytes(d)


# -- the thread maps -----------------------------------------------------------
def o_map(tid):
    """Rows and columns of the thread's O micro-tile: rows pr + 16 i, and
    in column group g the float4 at 4 cx of V's column chunk g."""
    warp, lane = divmod(tid, 32)
    pr, cx = (warp // 4) * 8 + lane // 4, (warp % 4) * 4 + lane % 4
    cols = [64 * g + 4 * cx + x for g in range(ck.FLASH_STREAMED_GROUPS) for x in range(4)]
    return [pr + 16 * i for i in range(4)], cols


def test_the_kernel_uses_these_maps():
    body = SRC[SRC.index("flash_attention_streamed_kernel(const"):]
    body = body[:body.index("\nstatic_assert")]
    assert "const int s_row0 = warp * 8 + (lane >> 4) * 4;" in body
    assert "const int pr = (warp >> 2) * 8 + (lane >> 2);" in body
    assert "const int cx = (warp & 3) * 4 + (lane & 3);" in body
    assert "s_v + (kk + u) * kSCStride + 4 * cx" in body
    assert "s_k + (kx + 16 * t) * kSCStride + x" in body


def test_thread_maps_cover_every_score_and_output_column_once():
    scores, outs = {}, {}
    for tid in range(ck.FLASH_STREAMED_THREADS):
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


# -- the kernel's arithmetic, emulated -----------------------------------------
def emulate_flash_streamed(q, k, v, causal):
    """The streamed kernel's forward in its order (every head and row of a
    64-row query tile at once): per key tile K's 64-column chunks in
    ascending order, each score's FMA chain running on from chunk to chunk
    over D rounded up to 8 (zeros past D), then the masks and the
    resident path's row sums, then V's chunks, chunk g feeding O's columns
    64 g .. 64 g + 63 key by key. The card's expf is within 2 ulp; here it
    is numpy's."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bh, rows, bk, chunk = b * h, 64, 64, ck.FLASH_STREAMED_CHUNK
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
            for c0 in range(0, w, chunk):
                k_chunk = np.zeros((bh, bk, min(chunk, w - c0)), np.float32)
                k_chunk[:, :valid] = k[:, k0:k0 + valid, c0:c0 + chunk]
                for c in range(k_chunk.shape[2]):
                    s = _fma(q_tile[:, :, c0 + c, None], k_chunk[:, None, :, c], s)
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
            for c0 in range(0, w, chunk):
                v_chunk = np.zeros((bh, bk, min(chunk, w - c0)), np.float32)
                v_chunk[:, :valid] = v[:, k0:k0 + valid, c0:c0 + chunk]
                part_o = acc[..., c0:c0 + chunk]
                for key in range(bk):
                    part_o = _fma(p[:, :, key, None], v_chunk[:, None, key, :], part_o)
                acc[..., c0:c0 + chunk] = part_o
        o = (acc / np.maximum(l, np.float32(1e-30))[..., None]).astype(np.float32)
        out[:, q0:q0 + n_rows] = o[:, :n_rows, :d]
    return out.reshape(b, h, lq, d)


@functools.lru_cache(maxsize=None)
def _jax_out(shape, causal):
    q, k, v = _qkv(*shape, seed=shape[4])
    return np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=16,
                                                 block_k=16))


#: (b, h, lq, lk, d): Lq != Lk, Lk not a multiple of 64, two query tiles,
#: the 24- and 48-column last chunks of D = 280 and 302 (302 is copied 4
#: bytes at a time on the card), and the widest head
EMULATED = [(1, 2, 70, 100, 280), (1, 1, 100, 70, 302), (2, 1, 33, 130, 320)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_jax_and_the_plain_version(shape, causal):
    q, k, v = _qkv(*shape, seed=shape[4])
    got = emulate_flash_streamed(q, k, v, causal)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_out(shape, causal), rtol=RTOL, atol=ATOL)
    plain = ck.flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_at_d256_the_order_is_the_resident_paths_bit_for_bit(causal):
    """A plan forcing the streamed path at D <= 272 gives the resident
    kernel's bits: the same FMA chains in the same order."""
    q, k, v = _qkv(1, 1, 70, 100, 256, seed=3)
    assert np.array_equal(emulate_flash_streamed(q, k, v, causal),
                          emulate_flash_resident(q, k, v, causal))


def test_the_kernel_sums_a_row_in_the_emulated_order():
    """Four xor shuffles across the 16 threads of a row, for the max and
    the sum; l = fma(l, corr, sum); o / max(l, 1e-30); no atomics."""
    body = SRC[SRC.index("flash_attention_streamed_kernel(const"):]
    body = body[:body.index("\nstatic_assert")]
    for shift in (1, 2, 4, 8):
        assert f"sum += __shfl_xor_sync(0xffffffffu, sum, {shift});" in body
        assert f"mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, {shift}));" in body
    assert "l[i] = fmaf(l[i], corr, sum);" in body
    assert "fmaxf(s_l[pr + 16 * i], 1e-30f)" in body
    assert "atomic" not in body


def test_the_c_entry_scales_by_the_true_width_and_copies_by_alignment():
    entry = SRC[SRC.index('extern "C" int pio_flash_attention_streamed('):]
    entry = entry[:entry.index("\n}\n")]
    assert "static_cast<float>(1.0 / std::sqrt(width))" in entry
    assert "const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);" \
        in entry
    assert "D <= kMaxD || D > kSMaxD" in entry


@pytest.mark.parametrize("d", [273, 302, 320])
def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing(d):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 20, 30, d, seed=d))
    before = ck.flash_attention_fwd.launches
    by_path = dict(ck.flash_attention_fwd.launches_by_path)
    got = ck.flash_attention_fwd(q, k, v, True)
    assert ck.flash_attention_fwd.launches == before
    assert ck.flash_attention_fwd.launches_by_path == by_path
    assert torch.equal(got, ck.flash_attention_fwd_reference(q, k, v, True))
