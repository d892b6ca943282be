"""The resident wide-head attention path (128 < D <= 272), on the CPU.

``csrc/flash_attention.cu``'s ``flash_attention_resident_kernel`` runs
only on the card, so what can be checked here is checked in Python: its
constants against the source, :func:`flash_resident_launch_plan` (pure
arithmetic) against the C entry's check transcribed with the source's own
constants, its shared memory at every width it takes, the choice of path
by the head width alone, the thread → (rows, keys) map of S and thread →
(rows, float4 columns) map of O, the shared-memory banks their loads
touch, and a numpy float32 emulation of the kernel's order: q pre-scaled
by 1/sqrt(D), each score one FMA chain over D in ascending order, every
64-key tile masked, the row max, ``exp``, the sum of a thread's keys kx +
16 t in t order and then across the row's 16 threads by four xor
shuffles, ``l = fma(l, corr, sum)``, O scaled by ``corr`` and then P·V
key by key, key tiles ascending with the causal ones above the diagonal
skipped. The emulation is held against the JAX ``flash_attention_pallas``
(interpret mode) and ``flash_attention_fwd_reference`` at rtol 2e-4 /
atol 2e-5, the JAX ``TestFlashPallas`` tolerance.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import flash_attention_pallas as jax_flash_attention_pallas
from predictionio_tpu_torch.ops import cuda_kernels as ck

RTOL, ATOL = 2e-4, 2e-5
D_RES = ck.FLASH_WIDE_RES_MAX_D

SRC = (pathlib.Path(ck.__file__).parent.parent / "kernels" / "csrc"
       / "flash_attention.cu").read_text()


def _const(name):
    """An integer constant of the source, or kRKeys plus one."""
    value = re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)
    if value.startswith("kRKeys +"):
        return _const("kRKeys") + int(value.split("+")[1])
    return int(value)


def test_constants_are_the_kernels():
    assert _const("kRRows") == ck.FLASH_WIDE_RES_ROWS == 64
    assert _const("kRKeys") == ck.FLASH_WIDE_RES_KEYS == 64
    assert _const("kRThreads") == ck.FLASH_WIDE_RES_THREADS == 256
    assert _const("kRPStride") == ck.FLASH_WIDE_RES_P_STRIDE == 68
    assert _const("kRMaxD") == D_RES
    assert _const("kPad") == ck.FLASH_PAD
    assert "constexpr int kRGroupsMin = 3, kRGroupsMax = 5;" in SRC
    assert tuple(ck.FLASH_WIDE_RES_REGS) == (3, 4, 5)
    assert "return (d + 7) / 8 * 8;" in SRC
    assert ("return (kRRows + kRKeys) * (res_width(d) + kPad) + kRKeys * res_width(d) +\n"
            "         kRRows * kRPStride + 2 * kRRows;") in SRC
    assert "return ((d + 3) / 4 + 15) / 16;" in SRC
    params = re.search(r'extern "C" int pio_flash_attention_resident\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(ck._EXTRA_ENTRIES["flash_attention"]["pio_flash_attention_resident"])


@pytest.mark.parametrize("lib,entry", [(lib, entry) for lib, entries in ck._EXTRA_ENTRIES.items()
                                       for entry in entries])
def test_every_extra_entry_is_declared_with_its_sources_arity(lib, entry):
    """``_configured`` declares each entry once for the library: its
    argument count is the C signature's."""
    src = (pathlib.Path(ck.__file__).parent.parent / "kernels" / "csrc"
           / f"{lib}.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(ck._EXTRA_ENTRIES[lib][entry])


def _c_entry_accepts(plan, bh, lq, d):
    """``pio_flash_attention_resident``'s check of a plan, transcribed, with
    the source's own constants."""
    rows, keys, pad = _const("kRRows"), _const("kRKeys"), _const("kPad")
    if not _const("kMaxD") < d <= _const("kRMaxD"):
        return False
    w = -(-d // 8) * 8
    smem = 4 * ((rows + keys) * (w + pad) + keys * w + rows * _const("kRPStride") + 2 * rows)
    blocks = -(-lq // rows) * bh
    return (plan.blocks == blocks <= 2**31 - 1 and plan.threads == _const("kRThreads")
            and plan.smem == smem <= _const("kMaxSmem"))


#: (b, h, lq, lk): the training shape, the long shape, one row, a ragged pair
PLAN_SHAPES = [(64, 4, 64, 64), (8, 4, 2048, 2048), (1, 1, 1, 1), (3, 2, 70, 300)]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("d", [129, 133, 136, 192, 193, 200, 256, 257, 270, D_RES])
def test_plan_is_accepted_by_the_c_entry(d, sm_count):
    for b, h, lq, lk in PLAN_SHAPES:
        plan = ck.flash_resident_launch_plan(b, h, lq, lk, d, sm_count, 168)
        assert plan.path == "resident" and plan.passes == 1
        assert plan.q_tiles == -(-lq // 64) and plan.kv_tiles == -(-lk // 64)
        assert plan.blocks == b * h * plan.q_tiles and plan.blocks_per_sm == 1
        assert plan.waves == -(-plan.blocks // sm_count)
        assert plan.o_tile == (4, 4 * ck.flash_resident_groups(d))
        assert _c_entry_accepts(plan, b * h, lq, d), (b, h, lq, d, plan)


def test_every_width_up_to_d_res_fits_a_block_and_the_next_does_not():
    for d in range(ck.FLASH_MAX_D + 1, D_RES + 1):
        assert ck.flash_resident_smem_bytes(d) <= ck.FLASH_MAX_SMEM, d
        assert ck.flash_resident_groups(d) in ck.FLASH_WIDE_RES_REGS, d
    assert ck.flash_resident_smem_bytes(D_RES + 1) > ck.FLASH_MAX_SMEM
    assert ck.flash_resident_smem_bytes(256) == 216576  # 211.5 KB: one block an SM
    assert "res_smem_floats(kRMaxD + 8) * 4 > kMaxSmem" in SRC


@pytest.mark.parametrize("regs,sm_count,per_sm", [(168, 132, 1), (255, 132, 1), (96, 114, 1)])
def test_plan_follows_the_card_and_the_registers(regs, sm_count, per_sm):
    """Blocks an SM from the registers read off the card and the shared
    memory (one 211.5 KB block at D = 256), waves from the card's SMs."""
    plan = ck.flash_resident_launch_plan(8, 4, 2048, 2048, 256, sm_count, regs)
    assert plan.regs == regs and plan.blocks_per_sm == per_sm
    assert plan.waves == -(-1024 // (sm_count * per_sm))


@pytest.mark.parametrize("d", [1, 64, 128, D_RES + 1, 320, 512])
def test_plan_refuses_widths_outside_the_path(d):
    with pytest.raises(ValueError, match="no flash resident launch plan"):
        ck.flash_resident_launch_plan(1, 1, 8, 8, d, 132, 168)


@pytest.mark.parametrize("d,path", [(128, "tuned"), (129, "resident"), (136, "resident"),
                                    (256, "resident"), (D_RES, "resident"),
                                    (D_RES + 8, "streamed"), (512, "wide_streamed")])
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
        plan = ck.flash_plan_for(q, k, True)
        assert plan.path == path
        if path == "resident":
            assert plan.regs == 160 + ck.flash_resident_groups(d)


# -- the thread maps and the banks they touch ----------------------------------
def s_map(tid):
    """Rows and keys of the thread's S micro-tile: warp w holds rows 8w..8w
    + 7, half h = lane / 16 rows 8w + 4h + i, kx = lane % 16 keys kx + 16 t."""
    warp, lane = divmod(tid, 32)
    row0 = warp * 8 + (lane // 16) * 4
    return [row0 + i for i in range(4)], [lane % 16 + 16 * t for t in range(4)]


def o_map(tid, groups):
    """Rows and float4 column groups of the thread's O micro-tile: rows pr +
    16 i, groups cx + 16 g, with 8 rows × 4 column groups to a warp."""
    warp, lane = divmod(tid, 32)
    pr, cx = (warp // 4) * 8 + lane // 4, (warp % 4) * 4 + lane % 4
    return [pr + 16 * i for i in range(4)], [cx + 16 * g for g in range(groups)]


def test_the_kernel_uses_these_maps():
    assert "const int s_row0 = warp * 8 + (lane >> 4) * 4;" in SRC
    assert "const int pr = (warp >> 2) * 8 + (lane >> 2);" in SRC
    assert "const int cx = (warp & 3) * 4 + (lane & 3);" in SRC


@pytest.mark.parametrize("groups", [3, 4, 5])
def test_thread_maps_cover_every_score_and_output_once(groups):
    scores, outs = {}, {}
    for tid in range(256):
        rows, keys = s_map(tid)
        for r in rows:
            for t in keys:
                scores[(r, t)] = scores.get((r, t), 0) + 1
        rows, cols = o_map(tid, groups)
        for r in rows:
            for c in cols:
                outs[(r, c)] = outs.get((r, c), 0) + 1
    assert set(scores) == {(r, t) for r in range(64) for t in range(64)}
    assert set(scores.values()) == {1}
    assert set(outs) == {(r, c) for r in range(64) for c in range(16 * groups)}
    assert set(outs.values()) == {1}
    # a row of S sits in one half-warp: its max and sum take four shuffles
    for warp in range(8):
        for half in range(2):
            lanes = [32 * warp + 16 * half + x for x in range(16)]
            assert len({tuple(s_map(t)[0]) for t in lanes}) == 1


def _wavefronts(float_addrs):
    """Shared-memory passes one 16-byte load instruction takes: its distinct
    16-byte groups, at most 8 a pass, none two in the same 4 banks."""
    groups = {a // 4 for a in float_addrs}
    per_bank = {}
    for g in groups:
        per_bank[g % 8] = per_bank.get(g % 8, 0) + 1
    return max(per_bank.values())


@pytest.mark.parametrize("d", [136, 192, 200, 256, D_RES])
def test_every_load_instruction_takes_the_fewest_passes(d):
    """Q, K, P and V loads of a warp: one pass for Q (2 rows), P (8 rows)
    and V (4 column groups), two for K (16 keys, 256 bytes)."""
    w = -(-d // 8) * 8
    ds, ps = w + ck.FLASH_PAD, ck.FLASH_WIDE_RES_P_STRIDE
    for warp in range(8):
        lanes = range(32 * warp, 32 * warp + 32)
        for i in range(4):
            assert _wavefronts([s_map(t)[0][i] * ds + 8 for t in lanes]) == 1
            assert _wavefronts([o_map(t, 4)[0][i] * ps + 4 for t in lanes]) == 1
        for j in range(4):
            assert _wavefronts([s_map(t)[1][j] * ds + 8 for t in lanes]) == 2
            assert _wavefronts([5 * w + 4 * o_map(t, 4)[1][j] for t in lanes]) == 1


# -- the kernel's arithmetic, emulated -----------------------------------------
def _fma(a, b, c):
    """float32 fma(a, b, c) through float64 (the product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_flash_resident(q, k, v, causal):
    """The resident kernel's forward in its order (every head and row of a
    64-row query tile at once). The card's expf is within 2 ulp; here it
    is numpy's."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bh, rows, bk = b * h, 64, 64
    qscale = np.float32(1.0 / np.sqrt(np.float64(d)))
    q = (np.asarray(q, np.float32).reshape(bh, lq, d) * qscale).astype(np.float32)
    k = np.asarray(k, np.float32).reshape(bh, lk, d)
    v = np.asarray(v, np.float32).reshape(bh, lk, d)
    n_kv = -(-lk // bk)
    neg = np.float32(-1e30)
    lane = np.arange(16)
    out = np.zeros((bh, lq, d), np.float32)
    for qt in range(-(-lq // rows)):
        q0 = qt * rows
        n_rows = min(rows, lq - q0)
        q_tile = np.zeros((bh, rows, d), np.float32)
        q_tile[:, :n_rows] = q[:, q0:q0 + n_rows]
        m = np.full((bh, rows), neg, np.float32)
        l = np.zeros((bh, rows), np.float32)
        acc = np.zeros((bh, rows, d), np.float32)
        hi = min((q0 + rows + bk - 1) // bk, n_kv) if causal else n_kv
        for kt in range(hi):
            k0 = kt * bk
            valid = min(bk, lk - k0)
            k_tile = np.zeros((bh, bk, d), np.float32)
            v_tile = np.zeros((bh, bk, d), np.float32)
            k_tile[:, :valid] = k[:, k0:k0 + valid]
            v_tile[:, :valid] = v[:, k0:k0 + valid]
            s = np.zeros((bh, rows, bk), np.float32)
            for c in range(d):
                s = _fma(q_tile[:, :, c, None], k_tile[:, None, :, c], s)
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
            for key in range(bk):
                acc = _fma(p[:, :, key, None], v_tile[:, None, key, :], acc)
        o = (acc / np.maximum(l, np.float32(1e-30))[..., None]).astype(np.float32)
        out[:, q0:q0 + n_rows] = o[:, :n_rows]
    return out.reshape(b, h, lq, d)


def _qkv(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (lq, lk, lk))


@functools.lru_cache(maxsize=None)
def _jax_out(shape, causal):
    b, h, lq, lk, d = shape
    q, k, v = _qkv(*shape, seed=d)
    return np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                                 block_k=8))


#: (b, h, lq, lk, d): two query and three key tiles at D = 136, and the
#: ragged cross-attention pairs
EMULATED = [(1, 2, 100, 130, 136), (2, 1, 33, 70, 200), (1, 1, 70, 33, 256)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_jax_and_the_plain_version(shape, causal):
    q, k, v = _qkv(*shape, seed=shape[4])
    got = emulate_flash_resident(q, k, v, causal)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_out(shape, causal), rtol=RTOL, atol=ATOL)
    plain = ck.flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


def test_the_kernel_sums_a_row_in_the_emulated_order():
    """Four xor shuffles across the 16 threads of a row, for the max and
    the sum; l = fma(l, corr, sum); o / max(l, 1e-30)."""
    body = SRC[SRC.index("flash_attention_resident_kernel(const"):]
    body = body[:body.index("\ntemplate <int G>")]
    for shift in (1, 2, 4, 8):
        assert f"sum += __shfl_xor_sync(0xffffffffu, sum, {shift});" in body
        assert f"mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, {shift}));" in body
    assert "l[i] = fmaf(l[i], corr, sum);" in body
    assert "fmaxf(s_l[pr + 16 * i], 1e-30f)" in body
    assert "atomic" not in body


def test_the_c_entry_scales_by_the_true_width_and_copies_by_alignment():
    entry = SRC[SRC.index('extern "C" int pio_flash_attention_resident('):]
    entry = entry[:entry.index("\n}\n")]
    assert "static_cast<float>(1.0 / std::sqrt(width))" in entry
    assert "const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);" \
        in entry
    assert "D <= kMaxD || D > kRMaxD" in entry


@pytest.mark.parametrize("d", [129, 200, 272])
def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing(d):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 20, 30, d, seed=d))
    before = ck.flash_attention_fwd.launches
    got = ck.flash_attention_fwd(q, k, v, True)
    assert ck.flash_attention_fwd.launches == before
    assert torch.equal(got, ck.flash_attention_fwd_reference(q, k, v, True))
