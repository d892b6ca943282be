"""The cluster attention path (512 < D <= 1024), on the CPU.

``csrc/flash_attention.cu``'s ``flash_attention_cluster_kernel`` runs only on
the card (a cluster of two blocks, distributed shared memory), so what can be
checked here is checked in Python: its constants against the source,
:func:`flash_cluster_launch_plan` (pure arithmetic) against the C entry's
check transcribed with the source's own constants, the widest head against
its register plan and a block's shared memory, the choice of path by the head
width alone, the thread maps of the two blocks (every partial score once a
block, every output column once across the pair), a race check of the
exchange of the partial scores through distributed shared memory (each
store into the partner's buffer, the barrier phase that publishes it, the
read, and the reuse of the buffer for P and the next tile), and a numpy
float32 emulation of the kernel's order: each block's partial score one FMA
chain over its slice of D ascending, the two partials added in one rounded
add, then the wide streamed path's masks, row max, ``exp``, sum of a row,
``l = fma(l, corr, sum)`` and P·V key by key. The emulation is held against
the JAX ``flash_attention_pallas`` (interpret mode) and
``flash_attention_fwd_reference`` at rtol 2e-4 / atol 2e-5, the JAX
``TestFlashPallas`` tolerance.
"""

import re

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import cuda_kernels as ck
from test_torch_flash_wide import SRC, _const, _fma, _qkv
from test_torch_flash_wide_streamed import _jax_out, o_map, s_map

RTOL, ATOL = 2e-4, 2e-5
D_MAX = ck.FLASH_CLUSTER_MAX_D
D_WS = ck.FLASH_WIDE_STREAMED_MAX_D
THREADS = ck.FLASH_CLUSTER_THREADS
P_STRIDE = ck.FLASH_WIDE_RES_P_STRIDE

BODY = SRC[SRC.index("flash_attention_cluster_kernel(const"):]
BODY = BODY[:BODY.index("\nstatic_assert")]
ENTRY = SRC[SRC.index('extern "C" int pio_flash_attention_cluster('):]
ENTRY = ENTRY[:ENTRY.index("\n}\n")]


def _slices(d):
    """``cl_slice_width`` transcribed: D rounded up to 8, halved and
    rounded up to 8 for rank 0, the rest for rank 1."""
    w = -(-d // 8) * 8
    first = -(-(w // 2) // 8) * 8
    return first, w - first


def test_constants_are_the_kernels():
    assert _const("kCBlocks") == ck.FLASH_CLUSTER_BLOCKS == 2
    assert _const("kCGroups") == ck.FLASH_CLUSTER_GROUPS == 8
    assert _const("kCMaxD") == D_MAX >= 768
    assert _const("kWSThreads") == THREADS == 512
    assert "return (res_width(d) / 2 + 7) / 8 * 8;" in SRC
    assert "return rank == 0 ? cl_slice0(d) : res_width(d) - cl_slice0(d);" in SRC
    assert "return ws_smem_floats(cl_slice0(d));" in SRC
    params = re.search(r'extern "C" int pio_flash_attention_cluster\(([^)]*)\)', SRC).group(1)
    assert len(params.split(",")) == len(
        ck._EXTRA_ENTRIES["flash_attention"]["pio_flash_attention_cluster"])
    # one block an SM at 512 threads allows the registers the plan assumes
    assert "__global__ void __launch_bounds__(kWSThreads, 1)\n    flash_attention_cluster_kernel" \
        in SRC
    assert 65536 // THREADS >= ck.FLASH_CLUSTER_REGS


@pytest.mark.parametrize("d", [513, 520, 576, 640, 650, 768, 900, 1000, D_MAX])
def test_slices_are_the_sources(d):
    first, second = ck.flash_cluster_slices(d)
    assert (first, second) == _slices(d)
    assert first % 8 == 0 and second % 8 == 0 and 0 < second <= first <= first + 8
    assert first + second == -(-d // 8) * 8
    assert ck.flash_cluster_smem_bytes(d) == ck.flash_wide_streamed_smem_bytes(first)


def _c_entry_accepts(plan, bh, lq, d):
    """``pio_flash_attention_cluster``'s check of a plan, transcribed, with
    the source's own constants."""
    rows, keys, pad = _const("kWSRows"), _const("kWSKeys"), _const("kPad")
    if not _const("kMaxD") < d <= _const("kCMaxD"):
        return False
    first, second = _slices(d)
    buffer = keys * (max(_const("kWSKChunk"), _const("kWSVChunk")) + 4)
    smem = 4 * (rows * (first + pad) + _const("kWSStages") * buffer
                + rows * _const("kRPStride") + 2 * rows)
    blocks = -(-lq // rows) * bh * _const("kCBlocks")
    return (plan.blocks == blocks <= 2**31 - 1 and plan.threads == _const("kWSThreads")
            and plan.cluster == _const("kCBlocks") and tuple(plan.slices) == (first, second)
            and plan.smem == smem <= _const("kMaxSmem"))


#: (b, h, lq, lk): the training shape, the long shape, one row, a ragged pair
PLAN_SHAPES = [(64, 4, 64, 64), (8, 4, 2048, 2048), (1, 1, 1, 1), (3, 2, 70, 300)]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("d", [513, 520, 576, 640, 768, D_MAX])
def test_plan_is_accepted_by_the_c_entry(d, sm_count):
    for b, h, lq, lk in PLAN_SHAPES:
        plan = ck.flash_cluster_launch_plan(b, h, lq, lk, d, sm_count, ck.FLASH_CLUSTER_REGS)
        assert plan.path == "cluster" and plan.passes == 1 and plan.cluster == 2
        assert plan.q_tiles == -(-lq // 64) and plan.kv_tiles == -(-lk // 64)
        assert plan.blocks == 2 * b * h * plan.q_tiles and plan.blocks_per_sm == 1
        assert plan.waves == -(-plan.blocks // sm_count)
        assert plan.s_tile == (2, 4) and plan.o_tile == (2, 4 * ck.FLASH_CLUSTER_GROUPS)
        assert _c_entry_accepts(plan, b * h, lq, d), (b, h, lq, d, plan)
        # a doctored plan is refused
        assert not _c_entry_accepts(plan._replace(smem=plan.smem + 16), b * h, lq, d)
        assert not _c_entry_accepts(plan._replace(slices=plan.slices[::-1] if
                                                  plan.slices[0] != plan.slices[1] else
                                                  (plan.slices[0] + 8, plan.slices[1] - 8)),
                                    b * h, lq, d)


def test_the_c_entry_checks_what_the_transcription_checks():
    for text in ("D <= kMaxD || D > kCMaxD", "blocks != want_blocks",
                 "threads != kWSThreads", "cluster != kCBlocks",
                 "slice0 != cl_slice_width(D, 0) || slice1 != cl_slice_width(D, 1)",
                 "smem != cl_smem_floats(D) * static_cast<int>(sizeof(float))",
                 "const long long want_blocks = q_tiles * BH * kCBlocks;",
                 "attr->val.clusterDim.x = kCBlocks;", "cudaLaunchKernelEx(&cfg, "):
        assert text in ENTRY or text in SRC, text
    occupancy = SRC[SRC.index('extern "C" int pio_flash_attention_cluster_occupancy('):]
    assert "cudaOccupancyMaxActiveClusters(out, flash_attention_cluster_kernel<kCGroups>, &cfg)" \
        in occupancy


@pytest.mark.parametrize("d", [1, 64, 128, D_MAX + 1, 2048])
def test_plan_refuses_widths_outside_the_path(d):
    with pytest.raises(ValueError, match="no flash cluster launch plan"):
        ck.flash_cluster_launch_plan(1, 1, 8, 8, d, 132, ck.FLASH_CLUSTER_REGS)
    widest = ck.flash_cluster_launch_plan(1, 1, 8, 8, D_MAX, 132, ck.FLASH_CLUSTER_REGS)
    assert not _c_entry_accepts(widest, 1, 8, d)


def test_the_ceiling_is_the_register_plan_and_its_tiles_fit_a_block():
    """Every width up to kCMaxD fits a block's shared memory with O in
    kCGroups float4 column groups a thread on each slice; the next width
    would need a ninth group on rank 0, which the wide streamed block's
    registers do not take (a ninth group spills there), so the register plan,
    not shared memory, bounds the path. The exchange needs no shared memory
    of its own: it lands in the probability buffer."""
    for d in range(D_WS + 1, D_MAX + 1):
        first, second = _slices(d)
        assert ck.flash_cluster_smem_bytes(d) <= ck.FLASH_MAX_SMEM, d
        assert -(-first // 64) <= ck.FLASH_CLUSTER_GROUPS, d
    assert _slices(D_MAX) == (64 * ck.FLASH_CLUSTER_GROUPS,) * 2
    assert _slices(D_MAX + 1)[0] > 64 * ck.FLASH_CLUSTER_GROUPS
    assert ck.flash_cluster_smem_bytes(D_MAX) == 217600
    # a separate [64][68] exchange buffer would not fit at the ceiling
    assert ck.flash_cluster_smem_bytes(D_MAX) + 64 * P_STRIDE * 4 > ck.FLASH_MAX_SMEM
    assert ck.flash_cluster_smem_bytes(D_MAX) + 1024 <= 233472 < 2 * (
        ck.flash_cluster_smem_bytes(D_WS + 1) + 1024)
    assert "cl_smem_floats(kCMaxD) * 4 <= kMaxSmem && cl_slice0(kCMaxD) == kCGroups * 64" in SRC
    assert "cl_slice0(kCMaxD + 1) > kCGroups * 64" in SRC


@pytest.mark.parametrize("d,path", [(D_WS, "wide_streamed"), (D_WS + 1, "cluster"),
                                    (576, "cluster"), (650, "cluster"), (768, "cluster"),
                                    (D_MAX, "cluster"), (D_MAX + 1, "passes")])
def test_flash_plan_for_picks_the_path_by_the_head_width_alone(d, path, monkeypatch):
    monkeypatch.setattr(ck, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(ck, "_flash_wide_streamed_regs", lambda index: 128)
    monkeypatch.setattr(ck, "_flash_cluster_regs", lambda index: 126)
    for b, h, lq, lk in ((64, 4, 64, 64), (1, 1, 1, 1), (8, 4, 2048, 2048)):
        q = torch.zeros((b, h, lq, d), device="meta")
        k = torch.zeros((b, h, lk, d), device="meta")
        plan = ck.flash_plan_for(q, k, False)
        assert plan.path == path
        if path == "cluster":
            assert plan.regs == 126 and plan.smem == ck.flash_cluster_smem_bytes(d)
            assert plan.blocks == 2 * b * h * -(-lq // 64)


# -- the thread maps of the pair -----------------------------------------------
def test_the_kernel_uses_the_wide_streamed_maps_on_its_slice():
    for text in ("const int kx = lane & 15;", "const int s_row0 = 2 * (tid >> 4);",
                 "const int pr = (warp >> 2) * 8 + (lane >> 2);",
                 "const int cx = (warp & 3) * 4 + (lane & 3);",
                 "q_c + (s_row0 + i) * ds + x", "s_k + (kx + 16 * t) * kWSKStride + x",
                 "s_p + (pr + 32 * i) * kRPStride + kk", "s_v + (kk + u) * kWSVStride + 64 * gg",
                 "const int c = 4 * (cx + 16 * g);", "if (c >= lim) continue;",
                 "const int c_base = rank * cl_slice0(D);",
                 "const int sw = cl_slice_width(D, rank);",
                 "const int lim = min(D - c_base, sw);",
                 "cluster_map(s_p + s_row0 * kRPStride + kx, cluster_rank() ^ 1u)",
                 "static_cast<int>(cluster_rank()) * cl_slice0(D);",
                 "x_remote + 4u * static_cast<unsigned>(i * kRPStride + 16 * t)",
                 "s_p[(s_row0 + i) * kRPStride + kx + 16 * t]",
                 "const int cl = static_cast<int>(blockIdx.x / kCBlocks);",
                 "const int q_tile = q_tiles - 1 - cl / BH;"):
        assert text in BODY, text


def _exchange_places(tid):
    """The s_p offsets a thread stores its partials to in the partner (and,
    in the partner, its thread tid reads): rows s_row0 + i, keys kx + 16 t."""
    rows, keys = s_map(tid)
    return [r * P_STRIDE + t for r in rows for t in keys]


@pytest.mark.parametrize("d", [513, 576, 650, 768, 1000, D_MAX])
def test_thread_maps_cover_every_partial_score_and_output_column_once(d):
    """Each block's threads hold every (row, key) partial score of a tile
    once, and a thread's places in the partner are its own partner's;
    across the pair every output column of [0, D) is written once (columns
    of a slice past D are not written)."""
    first, _ = _slices(d)
    places = [p for tid in range(THREADS) for p in _exchange_places(tid)]
    assert len(places) == len(set(places)) == 64 * 64
    assert {p // P_STRIDE for p in places} == set(range(64))
    assert {p % P_STRIDE for p in places} == set(range(64))
    outs = {}
    for rank in (0, 1):
        c_base = rank * first
        lim = min(d - c_base, _slices(d)[rank])
        for tid in range(THREADS):
            rows, cols = o_map(tid)
            for r in rows:
                for c in cols:
                    if c < lim:
                        outs[(r, c_base + c)] = outs.get((r, c_base + c), 0) + 1
    assert set(outs) == {(r, c) for r in range(64) for c in range(d)}
    assert set(outs.values()) == {1}


# -- the exchange's race check ---------------------------------------------------
#: ways to break the protocol, each of which the check must catch: no phase
#: between the stores and the read (no_publish), none between one tile's use
#: of s_p and the partner's next stores into it (no_reuse), the reuse phase's
#: arrive taken right after the read, before P is written and read (early_reuse)
BROKEN = ("no_publish", "no_reuse", "early_reuse")


def exchange_program(d, rank, tid, hi, broken=None):
    """One thread's accesses to the s_p buffers of the pair, and its
    barriers, in the kernel's order: ("arrive",), ("wait",) for the cluster
    barrier, ("sync",) for __syncthreads, ("w" | "r", block, places) for a
    store or load of ``block``'s s_p at those offsets. Per tile: the K
    chunks (a barrier each), the wait, the stores into the partner, the
    publishing phase, the read of the partner's partials, P over them, the
    V chunks (a barrier each, then P's rows read), the arrive that frees
    s_p; a barrier for l, then a last wait."""
    sw = _slices(d)[rank]
    nk, nv = -(-sw // 64), -(-sw // 128)
    mine = _exchange_places(tid)
    o_rows = o_map(tid)[0]
    p_rows = [r * P_STRIDE + key for r in o_rows for key in range(64)]
    ev = [("arrive",)]
    for _ in range(hi):
        ev += [("sync",)] * nk
        if broken != "no_reuse":
            ev.append(("wait",))
        ev.append(("w", 1 - rank, mine))
        if broken != "no_publish":
            ev += [("arrive",), ("wait",)]
        ev.append(("r", rank, mine))
        if broken == "early_reuse":
            ev.append(("arrive",))
        ev.append(("w", rank, mine))
        for _ in range(nv):
            ev += [("sync",), ("r", rank, p_rows)]
        if broken not in ("no_reuse", "early_reuse"):
            ev.append(("arrive",))
    ev += [("sync",), ("wait",)]
    return ev


def exchange_accesses(d, hi, broken=None):
    """Every access of both blocks to s_p, as arrays: the block whose s_p
    it is, the offset, the executing block and thread, the cluster arrives
    and waits and the __syncthreads the thread has passed before it, its
    place in the thread's program, and whether it writes. Thread 0 of each
    block also writes its whole s_p at its start and at its exit: a store
    from the partner must come after the first and before the second."""
    cols = {k: [] for k in ("block", "place", "exec", "tid", "a", "w", "s", "idx", "write")}

    def add(block, places, rank, tid, a, w, s, idx, write):
        n = len(places)
        for key, val in (("block", block), ("exec", rank), ("tid", tid), ("a", a), ("w", w),
                         ("s", s), ("idx", idx), ("write", write)):
            cols[key].append(np.full(n, val, np.int64))
        cols["place"].append(np.asarray(places, np.int64))

    whole = list(range(64 * P_STRIDE))
    for rank in (0, 1):
        for tid in range(THREADS):
            a = w = s = 0
            ev = exchange_program(d, rank, tid, hi, broken)
            if tid == 0:
                add(rank, whole, rank, tid, 0, 0, 0, -1, True)
            for idx, e in enumerate(ev):
                if e[0] == "arrive":
                    a += 1
                elif e[0] == "wait":
                    w += 1
                elif e[0] == "sync":
                    s += 1
                else:
                    add(e[1], e[2], rank, tid, a, w, s, idx, e[0] == "w")
            if tid == 0:
                add(rank, whole, rank, tid, a, w, s, len(ev), True)
    return {k: np.concatenate(v) for k, v in cols.items()}


def exchange_races(acc):
    """Pairs of accesses to one place of one block's s_p, at least one a
    write, by two threads (or blocks), that nothing orders: not a cluster
    phase (the earlier's thread arrives at it after the access, the later's
    waits for it before), not a __syncthreads of one block, not program
    order. Returns their count and a few of them."""
    loc = acc["block"] * 64 * P_STRIDE + acc["place"]
    order = np.argsort(loc, kind="stable")
    loc = loc[order]
    f = {k: v[order] for k, v in acc.items()}
    starts = np.searchsorted(loc, loc, side="left")
    ends = np.searchsorted(loc, loc, side="right")
    writes = np.nonzero(f["write"])[0]
    counts = ends[writes] - starts[writes]
    x = np.repeat(writes, counts)
    y = np.repeat(starts[writes] - np.cumsum(np.r_[0, counts[:-1]]), counts) + np.arange(
        counts.sum())

    def before(i, j):
        same_block = f["exec"][i] == f["exec"][j]
        return ((f["a"][i] < f["w"][j]) | (same_block & (f["s"][i] < f["s"][j]))
                | (same_block & (f["tid"][i] == f["tid"][j]) & (f["idx"][i] < f["idx"][j])))

    bad = (x != y) & ~before(x, y) & ~before(y, x)
    return int(bad.sum()), [{k: int(f[k][i]) for k in f} for i in x[bad][:3]]


def test_the_model_is_the_kernels_order():
    """The barriers, the stores, the read, P and the V chunks appear in the
    kernel's body in the order exchange_program takes them."""
    marks = [("arrive", "cluster_arrive();  // this block has started"),
             ("k_chunks", "const float* s_k = next_chunk(n0 + c);"),
             ("wait", "cluster_wait();\n    // the places the partner's thread tid reads"),
             ("store", "st.shared::cluster.f32"),
             ("arrive", "cluster_arrive();\n    cluster_wait();"),
             ("read", "s_p[(s_row0 + i) * kRPStride + kx + 16 * t]"),
             ("p", "p_row[16 * t] = p;"),
             ("v_chunks", "next_chunk(n0 + nk + g0 / kGroupsPerV)"),
             ("arrive", "cluster_arrive();  // this thread is done with s_p"),
             ("sync", "__syncthreads();\n#pragma unroll\n  for (int i = 0; i < 2; ++i) {\n"
                      "    const int q_pos = q0 + pr + 32 * i;"),
             ("wait", "cluster_wait();  // neither block leaves")]
    at = [BODY.index(text) for _, text in marks]
    assert at == sorted(at), [name for name, _ in marks]
    assert BODY.count("cluster_arrive();") == 3 and BODY.count("cluster_wait();") == 3
    assert BODY.count("__syncthreads();") == 2  # next_chunk's and the one before l is read
    assert "barrier.cluster.arrive.aligned;" in SRC and "barrier.cluster.wait.aligned;" in SRC
    assert "mapa.shared::cluster.u32" in SRC and "%%cluster_ctarank" in SRC


@pytest.mark.parametrize("d", [520, 650, 900, 1000, D_MAX])
def test_both_blocks_lay_out_their_shared_memory_alike(d):
    """A store mapped to the partner (mapa) goes to the same offset in the
    partner's shared memory, so s_p must start at one offset in both
    blocks, also where the slices differ in width: both take rank 0's Q
    row stride, and the plan's shared memory holds rank 0's layout."""
    assert "const int ds = cl_slice0(D) + kPad;" in BODY
    assert "float* s_c = s_q + kWSRows * ds;" in BODY
    assert "float* s_p = s_c + kWSStages * ws_buffer_floats();" in BODY
    first, second = _slices(d)
    buffer = 64 * (max(_const("kWSKChunk"), _const("kWSVChunk")) + 4)
    s_p = [64 * (first + 4) + _const("kWSStages") * buffer for _ in (0, 1)]
    assert s_p[0] == s_p[1]
    assert 4 * (s_p[0] + 64 * P_STRIDE + 2 * 64) == ck.flash_cluster_smem_bytes(d)
    assert second <= first


@pytest.mark.parametrize("d", [576, D_MAX])
def test_the_exchange_has_no_race(d):
    acc = exchange_accesses(d, hi=3)
    # every store into the partner's s_p, and its read, is in the check
    stores = (acc["exec"] != acc["block"]) & (acc["write"] == 1)
    assert stores.sum() == 2 * 3 * THREADS * 8
    n, examples = exchange_races(acc)
    assert n == 0, examples


@pytest.mark.parametrize("broken", BROKEN)
def test_the_race_check_catches_a_broken_protocol(broken):
    n, _ = exchange_races(exchange_accesses(576, hi=2, broken=broken))
    assert n > 0


# -- the kernel's arithmetic, emulated -------------------------------------------
def emulate_flash_cluster(q, k, v, causal):
    """The cluster kernel's forward in its order (every head and row of a
    64-row query tile at once): per key tile, each block's partial score
    one FMA chain over its slice's columns ascending (zeros past D), the
    two partials added once (rank 0's + rank 1's; the add is commutative,
    so both blocks hold these bits), then the wide streamed path's masks,
    a row's sum (a thread's 4 keys in t order, then four xor shuffles
    across the row's 16 threads), ``l = fma(l, corr, sum)``, O scaled by
    ``corr`` and then P·V key by key on every column (each column's chain
    is the same whichever block and V chunk it sits in). The card's expf is
    within 2 ulp; here it is numpy's."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bh, rows, bk = b * h, 64, 64
    w = -(-d // 8) * 8
    first, second = _slices(d)
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
            k_tile = np.zeros((bh, bk, w), np.float32)
            k_tile[:, :valid] = k[:, k0:k0 + valid]
            v_tile = np.zeros((bh, bk, w), np.float32)
            v_tile[:, :valid] = v[:, k0:k0 + valid]
            partials = []
            for c0, width in ((0, first), (first, second)):
                s = np.zeros((bh, rows, bk), np.float32)
                for c in range(c0, c0 + width):
                    s = _fma(q_tile[:, :, c, None], k_tile[:, None, :, c], s)
                partials.append(s)
            s = (partials[0] + partials[1]).astype(np.float32)
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
        out[:, q0:q0 + n_rows] = o[:, :n_rows, :d]
    return out.reshape(b, h, lq, d)


#: (b, h, lq, lk, d): Lq != Lk, Lk not a multiple of 64, two query tiles;
#: D = 576 (two slices of 288), 650 (copied 4 bytes at a time on the card,
#: rank 1's slice 6 columns short of its 328) and the widest head
EMULATED = [(1, 2, 70, 100, 576), (1, 1, 100, 70, 650), (2, 1, 33, 130, D_MAX)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_jax_and_the_plain_version(shape, causal):
    q, k, v = _qkv(*shape, seed=shape[4])
    got = emulate_flash_cluster(q, k, v, causal)
    assert np.isfinite(got).all()
    assert np.array_equal(got, emulate_flash_cluster(q, k, v, causal))
    np.testing.assert_allclose(got, _jax_out(shape, causal), rtol=RTOL, atol=ATOL)
    plain = ck.flash_attention_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


def test_the_kernel_sums_a_row_in_the_emulated_order():
    """The partner's partial added once, rounded (no fma can absorb it);
    then the wide streamed path's row: four xor shuffles across its 16
    threads for the max and the sum, l = fma(l, corr, sum), O scaled once a
    tile at its first V chunk, o / max(l, 1e-30), expf, no atomics."""
    assert "s[i][t] = __fadd_rn(s[i][t], s_p[(s_row0 + i) * kRPStride + kx + 16 * t]);" in BODY
    for shift in (1, 2, 4, 8):
        assert f"sum += __shfl_xor_sync(0xffffffffu, sum, {shift});" in BODY
        assert f"mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, {shift}));" in BODY
    assert "l[i] = fmaf(l[i], corr, sum);" in BODY
    assert "if (g0 == 0) {" in BODY and "const float corr = s_corr[pr + 32 * i];" in BODY
    assert "fmaxf(s_l[pr + 32 * i], 1e-30f)" in BODY
    assert "expf(" in BODY and "exp2f" not in BODY
    assert "atomic" not in BODY


def test_the_c_entry_scales_by_the_true_width_and_copies_by_alignment():
    assert "static_cast<float>(1.0 / std::sqrt(width))" in ENTRY
    assert "const int vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);" \
        in ENTRY


@pytest.mark.parametrize("d", [513, 650, D_MAX])
def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing(d):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 20, 30, d, seed=d))
    before = ck.flash_attention_fwd.launches
    by_path = dict(ck.flash_attention_fwd.launches_by_path)
    got = ck.flash_attention_fwd(q, k, v, True)
    assert ck.flash_attention_fwd.launches == before
    assert ck.flash_attention_fwd.launches_by_path == by_path
    assert by_path["cluster"] == 0
    assert torch.equal(got, ck.flash_attention_fwd_reference(q, k, v, True))
