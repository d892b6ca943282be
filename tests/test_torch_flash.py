"""The flash-attention kernel's launch plan, thread maps, masks and
arithmetic order, on the CPU.

``csrc/flash_attention.cu`` runs only on the card, so what can be checked
here is checked in Python: :func:`flash_launch_plan` (pure arithmetic,
checked again by the C entry point, transcribed here with the source's
own constants) at every head width, the heavy-first block map, the
thread → (rows, keys) and thread → (rows, columns) maps of the register
micro-tiles, the rule that applies the causal and length tests only on
the tiles that need them, and a numpy float32 emulation of the kernel's
order: q pre-scaled by 1/sqrt(D), each score one FMA chain over D in
ascending order, the tile's max, ``exp``, the tile's sum over the keys g,
g + 4, g + 8, ... one after another and then across g = 0..3 by two xor
shuffles (four threads a row's order), ``l = fma(l, corr, sum)``, O
scaled by ``corr`` and then P·V key by key, the key tiles in ascending
order. The emulation is held
against the JAX ``flash_attention_pallas`` (interpret mode, as
``tests/test_torch_attention.py`` runs it) and against
``flash_attention_fwd_reference`` at rtol 2e-4 / atol 2e-5, the JAX
``TestFlashPallas`` tolerance.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import flash_attention_pallas as jax_flash_attention_pallas
from predictionio_tpu_torch.ops import cuda_kernels
from predictionio_tpu_torch.ops.cuda_kernels import (
    FLASH_BQS,
    FLASH_KERNELS,
    FLASH_MAX_D,
    FLASH_MAX_SMEM,
    FLASH_TILE,
    flash_attention_fwd,
    flash_attention_fwd_reference,
    flash_launch_plan,
    flash_smem_bytes,
)

RTOL, ATOL = 2e-4, 2e-5
WIDTHS = list(range(8, FLASH_MAX_D + 1, 8))

SRC = (pathlib.Path(cuda_kernels.__file__).parent.parent / "kernels" / "csrc"
       / "flash_attention.cu").read_text()


def _const(name):
    """A constant of the source: an integer, or kTile plus one."""
    value = re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)
    tile = int(re.search(r"constexpr int kTile = (\d+);", SRC).group(1))
    return tile + int(value.split("+")[1]) if value.startswith("kTile +") else int(value)


def test_python_constants_are_the_kernels():
    assert _const("kTile") == FLASH_TILE
    assert _const("kRows") == cuda_kernels.FLASH_ROWS
    assert _const("kKeyThreads") == cuda_kernels.FLASH_KEY_THREADS
    assert _const("kPad") == cuda_kernels.FLASH_PAD
    assert _const("kPStride") == cuda_kernels.FLASH_P_STRIDE == 72
    assert _const("kMaxD") == FLASH_MAX_D
    assert _const("kMaxQTiles") == cuda_kernels.FLASH_MAX_Q_TILES
    assert "return (bq + 2 * kTile) * (d + kPad) + 2 * kTile * d + bq * kPStride;" in SRC
    assert "constexpr int kMaxSmem = 232448;" in SRC


# -- the kernel's tile rules, transcribed --------------------------------------
def flash_tiles_walked(q_tile, bq, n_kv, causal):
    """Key tiles a block of query tile ``q_tile`` walks, from tile 0: under
    causal the JAX formula ``min(((i + 1)·bq + bk − 1) // bk, n_kv)``."""
    return min(((q_tile + 1) * bq + FLASH_TILE - 1) // FLASH_TILE, n_kv) if causal else n_kv


def flash_tile_masks(q_tile, k_tile, bq, lk, causal):
    """Which tests the kernel applies on (query tile, key tile): the causal
    test only on a tile whose last key lies above its first row, the
    length test only on a tile that reaches past Lk."""
    q0, k0 = q_tile * bq, k_tile * FLASH_TILE
    return causal and k0 + FLASH_TILE - 1 > q0, k0 + FLASH_TILE > lk


def flash_block_tile(block, bh, q_tiles):
    """The (batch · head, query tile) block ``block`` takes: heaviest query
    tiles first, every head of a tile side by side."""
    return block % bh, q_tiles - 1 - block // bh


# -- the launch plan -----------------------------------------------------------
def _c_entry_accepts(plan, bh, lq, d):
    """``pio_flash_attention``'s check of a plan, transcribed, with the
    source's own constants."""
    tile, pad, stride = _const("kTile"), _const("kPad"), _const("kPStride")
    if plan.bq not in (tile, 2 * tile) or d % 8 or not 8 <= d <= _const("kMaxD"):
        return False
    q_tiles = -(-lq // plan.bq)
    smem = 4 * ((plan.bq + 2 * tile) * (d + pad) + 2 * tile * d + plan.bq * stride)
    return (q_tiles <= _const("kMaxQTiles") and plan.blocks == q_tiles * bh
            and plan.blocks <= 2**31 - 1 and plan.threads == 2 * plan.bq
            and plan.smem == smem <= _const("kMaxSmem"))


def _per_sm(bq, d, regs):
    threads = 2 * bq
    return min(65536 // (threads * (-(-regs // 8) * 8)),
               233472 // (flash_smem_bytes(bq, d) + 1024), 32, 2048 // threads)


#: (b, h, lq, lk): the training and serving shapes, the long shape, a
#: cross-attention pair, a ragged tail
SHAPES_FOR_PLAN = [(64, 4, 64, 64), (1, 4, 64, 64), (8, 4, 2048, 2048),
                   (2, 2, 70, 300), (2, 2, 300, 70), (1, 2, 2049, 2049)]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", WIDTHS)
def test_plan_is_valid_at_every_width(d, causal, sm_count):
    regs = (96, 128)
    for b, h, lq, lk in SHAPES_FOR_PLAN:
        plan = flash_launch_plan(b, h, lq, lk, d, causal, sm_count, regs)
        assert plan.bq in FLASH_BQS and plan.bk == FLASH_TILE
        assert plan.threads == 2 * plan.bq
        assert plan.s_tile == (4, 8) and plan.o_tile == (4, d // 8)
        assert plan.smem == flash_smem_bytes(plan.bq, d) <= FLASH_MAX_SMEM
        assert plan.regs == regs[FLASH_BQS.index(plan.bq)]
        assert plan.blocks_per_sm == _per_sm(plan.bq, d, plan.regs) >= 1
        assert plan.q_tiles == -(-lq // plan.bq) and plan.kv_tiles == -(-lk // 64)
        assert plan.blocks == b * h * plan.q_tiles
        assert plan.waves == -(-plan.blocks // (sm_count * plan.blocks_per_sm))
        if lq <= 64:
            assert plan.bq == 64
        assert _c_entry_accepts(plan, b * h, lq, d), plan
        assert flash_launch_plan.__wrapped__(b, h, lq, lk, d, causal, sm_count, regs) == plan


@pytest.mark.parametrize("bq", FLASH_BQS)
@pytest.mark.parametrize("d", WIDTHS)
def test_every_instantiation_but_one_fits_the_card(d, bq):
    """Both query tiles at every width fit a block's shared memory, but
    128 rows at D = 128 (232 KB with two K/V buffers): no plan takes it,
    and the C entry refuses it. A plan forced to any other passes the C
    entry's check."""
    if (d, bq) == (128, 128):
        assert flash_smem_bytes(bq, d) > FLASH_MAX_SMEM
        with pytest.raises(ValueError, match="no flash launch plan"):
            flash_launch_plan(8, 4, 2048, 2048, d, True, 132, (64, 64), bq)
        assert flash_launch_plan(8, 4, 2048, 2048, d, True, 132, (64, 64)).bq == 64
        return
    assert flash_smem_bytes(bq, d) <= FLASH_MAX_SMEM
    assert _per_sm(bq, d, 128) >= 1
    plan = flash_launch_plan(8, 4, 2048, 2048, d, True, 132, (128, 128), bq)
    assert plan.bq == bq and plan.blocks_per_sm == _per_sm(bq, d, 128)
    assert _c_entry_accepts(plan, 32, 2048, d)
    assert not _c_entry_accepts(plan._replace(smem=plan.smem + 16), 32, 2048, d)
    assert not _c_entry_accepts(plan._replace(blocks=plan.blocks + 1), 32, 2048, d)
    assert not _c_entry_accepts(plan._replace(threads=bq), 32, 2048, d)


def test_plan_takes_128_rows_only_when_the_wider_grid_fills_the_card():
    # wide heads: 512 blocks of 128 rows fill 132 SMs at one a block
    assert flash_launch_plan(8, 4, 2048, 2048, 96, True, 132, (168, 168)).bq == 128
    # the training shape: one 64-row tile
    assert flash_launch_plan(64, 4, 64, 64, 16, True, 132, (64, 64)).bq == 64
    # 16 blocks of 128 rows would leave most SMs idle
    assert flash_launch_plan(2, 4, 160, 160, 96, True, 132, (168, 168)).bq == 64


def test_plan_follows_the_card_and_the_registers():
    """The SM count and the registers come from the card: more registers
    a thread mean fewer blocks an SM, and fewer SMs more waves. 128-row
    blocks are taken only while an SM holds as many of their threads as
    of 64-row blocks."""
    for causal in (True, False):
        for d in (16, 64):
            for regs in ((64, 64), (64, 136), (96, 128), (168, 168), (168, 190)):
                plan = flash_launch_plan(8, 4, 2048, 2048, d, causal, 132, regs)
                threads = {bq: 2 * bq * _per_sm(bq, d, r) for bq, r in zip(FLASH_BQS, regs)}
                wide = threads[128] > threads[64] or (
                    threads[128] == threads[64] and not causal)
                assert plan.bq == (128 if wide else 64), (causal, d, regs)
    # D = 64 at 168 registers: two 64-row blocks an SM (shared memory), or
    # one 128-row block (registers): the same threads, so 64 rows under
    # causal and 128 without
    assert flash_launch_plan(8, 4, 2048, 2048, 64, True, 132, (168, 168)).bq == 64
    assert flash_launch_plan(8, 4, 2048, 2048, 64, False, 132, (168, 168)).bq == 128
    # D = 96: one block an SM either way (shared memory), so 128 rows
    assert flash_launch_plan(8, 4, 2048, 2048, 96, True, 132, (168, 168)).bq == 128
    base = flash_launch_plan(8, 4, 2048, 2048, 64, False, 132, (96, 128))
    narrow = flash_launch_plan(8, 4, 2048, 2048, 64, False, 66, (96, 128))
    assert base.bq == narrow.bq
    assert narrow.waves > base.waves
    train = flash_launch_plan(64, 4, 64, 64, 16, True, 132, (40, 48))
    assert train.blocks_per_sm == _per_sm(64, 16, 40)
    assert flash_launch_plan(64, 4, 64, 64, 16, True, 132, (200, 48)).blocks_per_sm \
        == _per_sm(64, 16, 200) < train.blocks_per_sm


@pytest.mark.parametrize("args", [
    (0, 4, 64, 64, 16), (1, 0, 64, 64, 16), (1, 4, 0, 64, 16), (1, 4, 64, 0, 16),
    (1, 4, 64, 64, 12), (1, 4, 64, 64, FLASH_MAX_D + 8),
])
def test_plan_refuses_bad_inputs(args):
    with pytest.raises(ValueError, match="no flash launch plan"):
        flash_launch_plan(*args, True, 132, (64, 64))
    with pytest.raises(ValueError, match="no flash launch plan"):
        flash_launch_plan(1, 4, 64, 64, 16, True, 132, (64,))
    with pytest.raises(ValueError, match="no flash launch plan"):
        flash_launch_plan(1, 4, 64, 64, 16, True, 132, (64, 64), 96)


def test_wrapper_passes_as_many_arguments_as_the_c_entry_takes():
    params = re.search(r'extern "C" int pio_flash_attention\(([^)]*)\)', SRC).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names == ["q", "k", "v", "o", "BH", "Lq", "Lk", "D", "D_true", "causal", "bq",
                     "threads", "smem", "blocks", "stream"]
    kinds = ["p" if "void*" in p else "i" for p in params.split(",")]
    want = ["p" if t is cuda_kernels.ctypes.c_void_p else "i"
            for t in cuda_kernels._FLASH_ARGTYPES]
    assert kinds == want


def test_attributes_cover_every_instantiation_in_order():
    rows = re.search(r"kKernels\[[^\]]*\] = \{(.*?)\};", SRC, re.S).group(1)
    widths = [int(d) for d in re.findall(r"PIO_FLASH_ROW\((\d+)\)", rows)]
    assert [(d, bq) for d in widths for bq in FLASH_BQS] == list(FLASH_KERNELS)
    launches = re.search(r"kLaunch\[[^\]]*\]\[2\] = \{(.*?)\};", SRC, re.S).group(1)
    assert [int(d) for d in re.findall(r"PIO_FLASH_ROW\((\d+)\)", launches)] == WIDTHS


# -- the block map and the thread maps -----------------------------------------
@pytest.mark.parametrize("bh,q_tiles", [(1, 1), (256, 1), (32, 16), (32, 32), (3, 7)])
def test_heavy_first_block_map_covers_every_tile_once(bh, q_tiles):
    assert "q_tiles - 1 - static_cast<int>(blockIdx.x / static_cast<unsigned>(BH))" in SRC
    assert "blockIdx.x % static_cast<unsigned>(BH)" in SRC
    taken = [flash_block_tile(blk, bh, q_tiles) for blk in range(bh * q_tiles)]
    assert sorted(taken) == [(h, t) for h in range(bh) for t in range(q_tiles)]
    for bq in FLASH_BQS:
        n_kv = -(-q_tiles * bq // 64)
        walked = [flash_tiles_walked(t, bq, n_kv, True) for _, t in taken]
        assert walked == sorted(walked, reverse=True)  # heaviest first
        assert walked[0] == n_kv


def _thread_maps(bq, d):
    """The kernel's thread → (rows, keys) map of S and thread → (rows,
    columns) map of O, transcribed."""
    w = 4 if (d // 8) % 4 == 0 else 2 if (d // 8) % 2 == 0 else 1
    for tid in range(2 * bq):
        kx, ry = tid % 8, tid // 8
        rows = [ry + bq // 4 * i for i in range(4)]
        keys = [kx + 8 * t for t in range(8)]
        cols = [kx * w + 8 * w * g + c for g in range(d // 8 // w) for c in range(w)]
        yield tid, rows, keys, cols


@pytest.mark.parametrize("bq", FLASH_BQS)
@pytest.mark.parametrize("d", WIDTHS)
def test_thread_maps_cover_every_score_and_output_once(d, bq):
    s_count = np.zeros((bq, FLASH_TILE), int)
    o_count = np.zeros((bq, d), int)
    warp_of_row = {}
    for tid, rows, keys, cols in _thread_maps(bq, d):
        s_count[np.ix_(rows, keys)] += 1
        o_count[np.ix_(rows, cols)] += 1
        for r in rows:  # a row's key-threads sit in one warp
            assert warp_of_row.setdefault(r, tid // 32) == tid // 32
    assert (s_count == 1).all() and (o_count == 1).all()


@pytest.mark.parametrize("d", [16, 64])
def test_one_load_instruction_reads_distinct_banks(d):
    """The 8 keys (and the 4 rows) one shared load of a warp reads lie in
    distinct 16-byte bank groups at the padded stride, so a float4 load
    of K or Q is one wavefront, and the probability stores of a warp hit
    distinct banks."""
    ds, ps = d + cuda_kernels.FLASH_PAD, cuda_kernels.FLASH_P_STRIDE
    for bq in FLASH_BQS:
        for warp in range(2 * bq // 32):
            lanes = list(_thread_maps(bq, d))[32 * warp:32 * warp + 32]
            for t in range(8):
                k_groups = {(keys[t] * ds // 4) % 8 for _, _, keys, _ in lanes}
                assert len(k_groups) == 8
            for i in range(4):
                q_rows = {rows[i] for _, rows, _, _ in lanes}
                q_groups = {(r * ds // 4) % 8 for r in q_rows}
                assert len(q_groups) == len(q_rows) == 4
                for t in range(8):
                    banks = {(rows[i] * ps + keys[t]) % 32 for _, rows, keys, _ in lanes}
                    assert len(banks) == 32


# -- the masks -----------------------------------------------------------------
MASK_SHAPES = [(64, 64), (70, 300), (300, 70), (2048, 1000), (1000, 2048), (2049, 2049),
               (7, 13), (128, 96), (1, 1)]


@pytest.mark.parametrize("bq", FLASH_BQS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", MASK_SHAPES)
def test_masks_are_applied_exactly_where_the_plain_mask_drops_a_score(lq, lk, causal, bq):
    """On a tile where the kernel skips a test, the plain version's mask
    keeps every score that test would look at; on a tile where it applies
    one, that test drops at least one of the tile's scores; and a tile
    that the causal skip never walks holds no kept score of a real row."""
    n_kv = -(-lk // 64)
    for qt in range(-(-lq // bq)):
        rows = np.arange(qt * bq, qt * bq + bq)[:, None]
        hi = flash_tiles_walked(qt, bq, n_kv, causal)
        for kt in range(n_kv):
            keys = np.arange(kt * 64, kt * 64 + 64)[None, :]
            causal_keep = rows >= keys if causal else np.ones((bq, 64), bool)
            length_keep = np.broadcast_to(keys < lk, (bq, 64))
            if kt >= hi:
                assert not (causal_keep & length_keep)[rows[:, 0] < lq].any()
                continue
            c_test, l_test = flash_tile_masks(qt, kt, bq, lk, causal)
            assert c_test == (not causal_keep.all())
            assert l_test == (not length_keep.all())


def test_the_kernel_applies_the_same_rule():
    assert "const bool cross = causal && k0 + kTile - 1 > q0;" in SRC
    assert "if (cross || k0 + kTile > Lk) {" in SRC
    assert "const int hi = causal ? min((q0 + BQ + kTile - 1) / kTile, n_kv) : n_kv;" in SRC


@pytest.mark.parametrize("bq", FLASH_BQS)
def test_tiles_walked_is_the_jax_formula(bq):
    """``min(((i + 1)·bq + bk − 1) // bk, n_kv)``: every tile holding a
    key some row of the query tile keeps, and none above."""
    for n_kv in (1, 2, 5, 32, 33):
        for i in range(-(-n_kv * 64 // bq) + 1):
            last_row = (i + 1) * bq - 1
            assert flash_tiles_walked(i, bq, n_kv, True) == min(last_row // 64 + 1, n_kv)
            assert flash_tiles_walked(i, bq, n_kv, False) == n_kv


# -- the kernel's arithmetic, emulated -----------------------------------------
def _fma(a, b, c):
    """float32 fma(a, b, c) through float64 (the product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_flash(q, k, v, causal, bq, d_true=None):
    """The kernel's forward of ``q [B, H, Lq, D]``, ``k, v [B, H, Lk, D]``
    at ``bq`` query rows a block, in its order (every head and row of a
    query tile at once), q scaled by 1/sqrt(``d_true``) (default D: the
    C entry's true width). The card's expf is within 2 ulp; here it is
    numpy's."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bh, bk = b * h, FLASH_TILE
    qscale = np.float32(1.0 / np.sqrt(np.float64(d if d_true is None else d_true)))
    q = (np.asarray(q, np.float32).reshape(bh, lq, d) * qscale).astype(np.float32)
    k = np.asarray(k, np.float32).reshape(bh, lk, d)
    v = np.asarray(v, np.float32).reshape(bh, lk, d)
    n_kv = -(-lk // bk)
    neg = np.float32(-1e30)
    lane = np.arange(4)
    out = np.zeros((bh, lq, d), np.float32)
    for qt in range(-(-lq // bq)):
        q0 = qt * bq
        rows = min(bq, lq - q0)
        q_tile = np.zeros((bh, bq, d), np.float32)
        q_tile[:, :rows] = q[:, q0:q0 + rows]
        m = np.full((bh, bq), neg, np.float32)
        l = np.zeros((bh, bq), np.float32)
        acc = np.zeros((bh, bq, d), np.float32)
        for kt in range(flash_tiles_walked(qt, bq, n_kv, causal)):
            k0 = kt * bk
            valid = min(bk, lk - k0)
            k_tile = np.zeros((bh, bk, d), np.float32)
            v_tile = np.zeros((bh, bk, d), np.float32)
            k_tile[:, :valid] = k[:, k0:k0 + valid]
            v_tile[:, :valid] = v[:, k0:k0 + valid]
            s = np.zeros((bh, bq, bk), np.float32)
            for c in range(d):
                s = _fma(q_tile[:, :, c, None], k_tile[:, None, :, c], s)
            if any(flash_tile_masks(qt, kt, bq, lk, causal)):
                q_pos = q0 + np.arange(bq)[:, None]
                k_pos = k0 + np.arange(bk)[None, :]
                keep = (k_pos < lk) & ((q_pos >= k_pos) if causal else True)
                s = np.where(keep, s, neg)
            m_new = np.maximum(m, s.max(axis=-1))
            corr = np.exp(m - m_new).astype(np.float32)
            p = np.exp(s - m_new[..., None]).astype(np.float32)
            by_group = p.reshape(bh, bq, 16, 4)  # [n, g]: key g + 4 n
            part = np.zeros((bh, bq, 4), np.float32)
            for n in range(16):  # keys g, g + 4, ... one after another
                part = (part + by_group[:, :, n, :]).astype(np.float32)
            for shift in (1, 2):  # __shfl_xor_sync across g
                part = (part + part[..., lane ^ shift]).astype(np.float32)
            l = _fma(l, corr, part[..., 0])
            m = m_new
            acc = (acc * corr[..., None]).astype(np.float32)
            for key in range(bk):
                acc = _fma(p[:, :, key, None], v_tile[:, None, key, :], acc)
        o = (acc / np.maximum(l, np.float32(1e-30))[..., None]).astype(np.float32)
        out[:, q0:q0 + rows] = o[:, :rows]
    return out.reshape(b, h, lq, d)


def _qkv(b, h, lq, lk, d, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, d)).astype(np.float32)
    return q, k, v


#: ``test_torch_attention.py``'s shapes (with their JAX blocks), then the
#: cross-attention pair and D = 120 (b, h, lq, lk, d, bq, bk)
EMULATED = [
    (2, 4, 64, 64, 16, 32, 32),
    (1, 2, 60, 60, 8, 32, 16),
    (1, 1, 7, 13, 8, 8, 8),
    (2, 2, 128, 96, 32, 64, 32),
    (2, 2, 70, 300, 64, 64, 64),
    (2, 2, 300, 70, 64, 64, 64),
    (1, 2, 96, 160, 120, 32, 32),
]


@functools.lru_cache(maxsize=None)
def _jax_out(shape, causal):
    b, h, lq, lk, d, bq, bk = shape
    q, k, v = _qkv(b, h, lq, lk, d)
    return np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=bq,
                                                 block_k=bk))


@pytest.mark.parametrize("bq", FLASH_BQS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: "x".join(map(str, s[:5])))
def test_emulation_matches_jax_and_the_plain_version(shape, causal, bq):
    b, h, lq, lk, d, _, _ = shape
    q, k, v = _qkv(b, h, lq, lk, d)
    got = emulate_flash(q, k, v, causal, bq)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_out(shape, causal), rtol=RTOL, atol=ATOL)
    plain = flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


def test_the_sum_of_a_row_follows_four_threads_a_rows_order():
    """The kernel's eight key-threads of a row (thread kx holds keys kx +
    8 t) pair with their partner kx ^ 4 and add keys g, g + 4, g + 8, ...
    in turn, then shuffle across g: every thread ends with the sum of a
    four-threads-a-row layout (keys g + 4 n each) to the bit."""
    p = np.random.default_rng(2).random(64).astype(np.float32) * np.float32(3.0)
    sums = []
    for kx in range(8):
        low, partner, acc = kx < 4, kx ^ 4, np.float32(0)
        for t in range(8):
            mine, other = p[kx + 8 * t], p[partner + 8 * t]
            acc = np.float32(acc + (mine if low else other))
            acc = np.float32(acc + (other if low else mine))
        sums.append(acc)
    for shift in (1, 2):
        sums = [np.float32(sums[x] + sums[x ^ shift]) for x in range(8)]
    four = [np.float32(0)] * 4
    for g in range(4):
        for n in range(16):
            four[g] = np.float32(four[g] + p[g + 4 * n])
    for shift in (1, 2):
        four = [np.float32(four[g] + four[g ^ shift]) for g in range(4)]
    assert len(set(sums)) == 1 and sums[0] == four[0]
    assert "const float other = __shfl_xor_sync(0xffffffffu, p, kKeyThreads / 2);" in SRC


def test_emulation_is_the_same_at_both_query_tiles_up_to_rounding():
    """The query tile changes which key tiles a block walks under causal
    (128 rows walk one more tile above the diagonal for the first 64),
    never a kept score: the two agree to the tolerance, and rows whose
    walked tiles coincide agree bit for bit."""
    q, k, v = _qkv(1, 2, 256, 256, 16, seed=3)
    narrow, wide = (emulate_flash(q, k, v, True, bq) for bq in FLASH_BQS)
    np.testing.assert_allclose(narrow, wide, rtol=RTOL, atol=ATOL)
    # rows 64..127 walk tiles 0..1 under both; the extra masked tile adds 0
    assert np.array_equal(narrow[:, :, 64:128], wide[:, :, 64:128])


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 70, 130, 16, seed=1))
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, True)
    assert flash_attention_fwd.launches == before
    assert torch.equal(got, flash_attention_fwd_reference(q, k, v, True))


# -- head widths that are not a multiple of 8 ------------------------------------
ODD_WIDTHS = [1, 6, 12, 15, 100]


@pytest.mark.parametrize("bq", FLASH_BQS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", ODD_WIDTHS)
def test_zero_padded_heads_give_the_true_widths_answer(d, causal, bq):
    """What the card runs for an odd width: q, k and v zero-padded to the
    next multiple of 8, the kernel at that width scaled by the true D,
    o sliced back. The zero columns add exact zeros to every FMA chain,
    so the answer is the kernel's at the true width bit for bit, and it
    agrees with the JAX kernel and the plain version at the true D."""
    q, k, v = _qkv(1, 2, 70, 70, d, seed=d)
    d_pad = -(-d // 8) * 8
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, 0), (0, d_pad - d)))  # noqa: E731
    padded = emulate_flash(pad(q), pad(k), pad(v), causal, bq, d_true=d)
    assert not padded[..., d:].any()  # the padded columns of o stay zero
    got = padded[..., :d]
    assert np.array_equal(got, emulate_flash(q, k, v, causal, bq))
    want = np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=32,
                                                 block_k=32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


def test_the_c_entry_scales_by_the_true_width():
    """The factor is today's expression with the true width, so a width
    that needs no padding (D_true = D) keeps its bits; a D_true that does
    not round up to D is refused."""
    assert "static_cast<float>(1.0 / std::sqrt(static_cast<double>(D_true)))" in SRC
    assert "D_true < D - 7 || D_true > D" in SRC
    assert "std::sqrt(static_cast<double>(D))" not in SRC
    assert "int Lq, int Lk, int causal, int blocks, int smem, float qscale," in SRC


@pytest.mark.parametrize("d", [0, FLASH_MAX_D + 1, 136, 256])
def test_heads_wider_than_the_tuned_path_are_answered_and_zero_width_raises(d):
    """D = 0 is refused on either device; wider heads than the tuned
    path's 128 are answered (the wide-head path on the card, the plain
    version here) as the JAX kernel answers."""
    if d == 0:
        q = torch.zeros((1, 1, 4, 0))
        with pytest.raises(ValueError, match="D >= 1"):
            flash_attention_fwd(q, q, q, True)
        with pytest.raises(ValueError, match="D >= 1"):
            flash_attention_fwd_reference(q, q, q, True)
        return
    q, k, v = _qkv(1, 2, 20, 20, d, seed=d)
    want = np.asarray(jax_flash_attention_pallas(q, k, v, causal=True, block_q=8,
                                                 block_k=8))
    got = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# -- the wide-head path (D > 128) ---------------------------------------------------
def _wide_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _wide_c_entry_accepts(plan, bh, lq, d):
    """``pio_flash_attention_wide``'s check of a plan, transcribed, with
    the source's own constants."""
    rows, cols = _wide_const("kWRows"), _wide_const("kWCols")
    blocks = -(-lq // rows) * bh * -(-d // cols)
    return (d > _const("kMaxD") and plan.blocks == blocks <= 2**31 - 1
            and plan.threads == _wide_const("kWThreads"))


def test_wide_constants_are_the_kernels():
    assert _wide_const("kWRows") == cuda_kernels.FLASH_WIDE_ROWS
    assert _wide_const("kWKeys") == cuda_kernels.FLASH_WIDE_KEYS
    assert _wide_const("kWThreads") == cuda_kernels.FLASH_WIDE_THREADS
    assert _wide_const("kWCols") == cuda_kernels.FLASH_WIDE_COLS
    assert _wide_const("kWChunk") == 64
    assert 65536 // (_wide_const("kWThreads") * _wide_const("kWMinBlocks")) \
        == cuda_kernels.FLASH_WIDE_REGS
    chunk = _wide_const("kWChunk")
    assert cuda_kernels.FLASH_WIDE_SMEM == 4 * (
        2 * cuda_kernels.FLASH_WIDE_ROWS * (chunk + 1)
        + cuda_kernels.FLASH_WIDE_KEYS * cuda_kernels.FLASH_WIDE_COLS
        + cuda_kernels.FLASH_WIDE_ROWS * (cuda_kernels.FLASH_WIDE_KEYS + 1))
    assert 'extern "C" int pio_flash_attention_wide(' in SRC
    params = re.search(r'extern "C" int pio_flash_attention_wide\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(cuda_kernels._WIDE_ARGTYPES["flash_attention"])


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("d", [129, 136, 192, 200, 256, 300, 384, 512])
def test_wide_plan_is_accepted_by_the_c_entry(d, sm_count):
    for b, h, lq, lk in ((64, 4, 64, 64), (8, 4, 2048, 2048), (1, 1, 1, 1), (3, 2, 70, 300)):
        plan = cuda_kernels.flash_wide_launch_plan(b, h, lq, lk, d, sm_count)
        assert plan.passes == -(-d // 128) and plan.q_tiles == -(-lq // 32)
        assert plan.kv_tiles == -(-lk // 32) and plan.blocks_per_sm >= 1
        assert plan.waves == -(-plan.blocks // (sm_count * plan.blocks_per_sm))
        assert _wide_c_entry_accepts(plan, b * h, lq, d), (b, h, lq, d, plan)


@pytest.mark.parametrize("d", [1, 8, 100, 128])
def test_wide_plan_refuses_the_tuned_widths(d):
    with pytest.raises(ValueError, match="no flash wide launch plan"):
        cuda_kernels.flash_wide_launch_plan(1, 1, 8, 8, d, 132)


@pytest.mark.parametrize("d", [6, 64, 128, 129, 136, 256, 512])
def test_the_path_is_picked_by_the_head_width_alone(d, monkeypatch):
    """``flash_plan_for`` takes the wide-head plan exactly above 128,
    whatever the other dimensions are."""
    monkeypatch.setattr(cuda_kernels, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_kernels, "_flash_regs",
                        lambda index: {key: 96 for key in FLASH_KERNELS})
    for b, h, lq, lk in ((64, 4, 64, 64), (1, 1, 1, 1), (8, 4, 2048, 2048)):
        q = torch.zeros((b, h, lq, d), device="meta")
        k = torch.zeros((b, h, lk, d), device="meta")
        d_k = -(-d // 8) * 8
        if d > FLASH_MAX_D:
            plan = cuda_kernels.flash_plan_for(q, k, True)
            assert plan.passes >= 2 and plan.threads == cuda_kernels.FLASH_WIDE_THREADS
        else:
            qp = torch.zeros((b, h, lq, d_k), device="meta")
            plan = cuda_kernels.flash_plan_for(qp, k, True)
            assert plan.passes == 1 and plan.bq in FLASH_BQS


def emulate_flash_wide(q, k, v, causal):
    """The wide-head kernel's forward in its order: 32 query rows and 32
    keys a tile, q scaled by 1/sqrt(D), each score one FMA chain over D in
    ascending order (the 64-column chunks continue one chain), every tile
    masked, the row max, ``exp``, the sum of a thread's keys kx + 8 t in
    t order then across kx by three xor shuffles, ``l = fma(l, corr,
    sum)``, O scaled by ``corr`` and then P·V key by key; key tiles
    ascending, the causal ones above the diagonal skipped."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bh, rows, bk = b * h, 32, 32
    qscale = np.float32(1.0 / np.sqrt(np.float64(d)))
    q = (np.asarray(q, np.float32).reshape(bh, lq, d) * qscale).astype(np.float32)
    k = np.asarray(k, np.float32).reshape(bh, lk, d)
    v = np.asarray(v, np.float32).reshape(bh, lk, d)
    n_kv = -(-lk // bk)
    neg = np.float32(-1e30)
    lane = np.arange(8)
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
            by_thread = p.reshape(bh, rows, 4, 8)  # [t, kx]: key kx + 8 t
            part = np.zeros((bh, rows, 8), np.float32)
            for t in range(4):
                part = (part + by_thread[:, :, t, :]).astype(np.float32)
            for shift in (1, 2, 4):  # __shfl_xor_sync across kx
                part = (part + part[..., lane ^ shift]).astype(np.float32)
            l = _fma(l, corr, part[..., 0])
            m = m_new
            acc = (acc * corr[..., None]).astype(np.float32)
            for key in range(bk):
                acc = _fma(p[:, :, key, None], v_tile[:, None, key, :], acc)
        o = (acc / np.maximum(l, np.float32(1e-30))[..., None]).astype(np.float32)
        out[:, q0:q0 + n_rows] = o[:, :n_rows]
    return out.reshape(b, h, lq, d)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 40, 40, 136), (2, 1, 33, 70, 200),
                                   (1, 1, 70, 33, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wide_emulation_matches_jax_and_the_plain_version(shape, causal):
    b, h, lq, lk, d = shape
    q, k, v = _qkv(b, h, lq, lk, d, seed=d)
    got = emulate_flash_wide(q, k, v, causal)
    want = np.asarray(jax_flash_attention_pallas(q, k, v, causal=causal, block_q=8,
                                                 block_k=8))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)
