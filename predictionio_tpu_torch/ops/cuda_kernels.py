"""Wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

Counterpart of ``predictionio_tpu/ops/pallas_kernels.py`` for the kernels
ported: the streaming top-k (``top_k_streaming``,
``top_k_for_users_streaming``), the fused gather + Gramian of the ALS
normal equations (``gramian_fused``), the batched SPD solve
(``spd_solve``, with ``spd_solve_t`` in the JAX package's transposed
layout) and the flash-attention forward (``flash_attention_fwd``, the
counterpart of ``ops/attention.py``'s Pallas kernel). A wrapper
validates its inputs, then:

- on CPU tensors it runs the plain version (the CPU tests hold that
  against the JAX kernel in interpret mode);
- on CUDA tensors it launches the kernel on the current stream, or
  raises — there is no fallback;
- it counts its launches in a plain int attribute (``.launches``), so a
  run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import build

NEG_INF = float("-inf")

#: items per stage-1 tile of ``csrc/topk_streaming.cu`` (kTileItems)
TOPK_TILE_ITEMS = 256
#: queries per stage-1 block (kTileQueries)
TOPK_TILE_QUERIES = 8
#: ranks staged per step (kRankChunk)
TOPK_RANK_CHUNK = 16
#: the kernel's ceiling on k (kMaxK): the catalog's, :data:`TOPK_MAX_ITEMS`,
#: so that any k clamped to N is taken
TOPK_MAX_K = 1 << 29
#: stage 1 keeps a running list of k keys over a run of tiles for k up to
#: this (kRunMaxKt); above it every tile is sorted on its own
TOPK_RUN_MAX_KT = 256
#: stage 1's kernels by the name a plan gives them (the C entry's ``stage1``
#: code is the index): the per-tile sort (``topk_tile_kernel``), the running
#: list with one item a thread (``topk_run_kernel``), the running list
#: with a register tile of 4 items x 8 queries a thread
#: (``topk_run_tiled_kernel``) and the threshold select
#: (``topk_select_score_kernel``, then ``topk_select_kernel``: every score
#: stored and counted in a histogram, then a block a query sorts only the
#: keys at or above the k-th key's bin; its own C entry, ``pio_topk_select``)
TOPK_STAGE1 = ("tile_sort", "running_list", "running_list_tiled", "select")
#: the plan's own pick: ``running_list`` for k up to this, the tiled
#: running list above it up to :data:`TOPK_RUN_MAX_KT`
TOPK_RUN_NARROW_MAX_K = 128
#: plan tiles a step of the tiled kernel scores at once (kStepTiles), one
#: item of each a thread: its T is a multiple of this, or the whole catalog
TOPK_STEP_TILES = 4
#: the tiled kernel's staged rank chunk (kTiledChunk) and its row stride in
#: floats (kStepStride)
TOPK_TILED_CHUNK, TOPK_STEP_STRIDE = 8, 4 * 256 + 4
#: a slice of the tiled kernel is dense (sorts all its candidates) above
#: this many survivors in some query (kTiledSparseMax); up to twice as many
#: keys a query wait pending before they merge into its list (kPendMax)
TOPK_TILED_SPARSE_MAX = 64
TOPK_PEND_MAX = 2 * TOPK_TILED_SPARSE_MAX
#: dynamic shared memory a block may opt into on the card (kMaxSmem)
TOPK_MAX_SMEM = 232448
#: the most stage-1 blocks an SM holds at once (64 registers a thread, 256
#: threads); their shared memory can lower it. The launch plan aims at one
#: full wave of blocks.
TOPK_BLOCKS_PER_SM = 4
#: the same for the tiled kernel, its launch bound (up to 128 registers)
TOPK_TILED_BLOCKS_PER_SM = 2
#: shared memory of an SM, and what the card keeps of it for each block
TOPK_SM_SMEM, TOPK_BLOCK_SMEM_RESERVE = 233472, 1024
#: the kernel's item indices are int32, padding indices sit above
#: 2**31 - 1 - TOPK_MAX_K, and the merge indexes a query's keys with ints
TOPK_MAX_ITEMS = 1 << 29
#: stage 1 tiles queries by 8 on grid.y (at most 65,535 blocks), so one
#: launch takes at most this many queries; a larger batch is cut into
#: consecutive slices of at most this many (:func:`topk_batch_slices`)
TOPK_MAX_BATCH = TOPK_TILE_QUERIES * 65535
#: the select path's histogram: a query's order keys counted by their top
#: 11 bits (kSelectBins), then, in its boundary bin, by the next 11 and the
#: last 10
TOPK_SELECT_BINS = 2048
#: the select path's scoring blocks an SM (kSelectScoreBlocksPerSm, its
#: launch bound; its histogram's shared memory allows no more)
TOPK_SELECT_BLOCKS_PER_SM = 2
#: the select path's smallest survivor buffer
TOPK_SELECT_MIN_SURVIVORS = 2048
#: threads of the select path's block a query (kSelectThreads)
TOPK_SELECT_THREADS = 1024
#: the select path sorts a query's survivors in one buffer of packed 8-byte
#: keys in shared memory, a power of two long: the longest whose keys and
#: histogram fit :data:`TOPK_MAX_SMEM` (kSelectMaxKeys). The plan picks the
#: path for 256 < k <= this; above it the per-tile sort answers.
TOPK_SELECT_MAX_K = 16384
#: the most scratch one launch may allocate on the card: its stage-1 lists
#: (8 bytes a key) and, when the merge runs in device memory, their second
#: copy. A slice is cut to stay within it, but never below one query tile.
TOPK_MAX_SCRATCH_BYTES = 2 << 30


class TopkPlan(NamedTuple):
    """What one launch of ``csrc/topk_streaming.cu`` needs beyond its
    tensors (see :func:`topk_launch_plan`)."""

    kt: int  #: keys a stage-1 list holds, min(k, 256)
    n_tiles: int  #: 256-item tiles of the catalog
    tiles_per_block: int  #: T, consecutive tiles one stage-1 block walks
    n_runs: int  #: lists per query that stage 1 writes, ceil(n_tiles / T)
    query_tile: int  #: queries per stage-1 block
    n_query_tiles: int
    #: [B, n_runs, kt], scores and ids; on the select path [B, 1, row]: a
    #: query's scores (N rounded up to 4) and its TOPK_SELECT_BINS counts
    scratch_shape: Tuple[int, int, int]
    stage1: str  #: the stage-1 kernel, one of :data:`TOPK_STAGE1`
    stage1_smem: int  #: bytes; 0 = the per-tile kernel (static memory)
    #: bytes; 0 = the rounds run between two scratches. On the select path
    #: the select kernel's (survivor keys and a histogram)
    merge_smem: int
    merge_threads: int  #: threads of the shared-memory merge's (or select's) block
    #: the select path: keys a query's block can hold and sort; a boundary
    #: bin whose keys do not fit is refined on the next bits (0 elsewhere)
    survivors: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def topk_run_smem(rank: int, kt: int) -> int:
    """``topk_run_kernel``'s dynamic shared memory (run_smem_bytes in the
    .cu): q rows, one staged rank chunk of 16, two candidate buffers, two
    copies of the running lists, the survivor counts and the exclusion
    bits."""
    return 4 * (TOPK_TILE_QUERIES * rank + TOPK_RANK_CHUNK * (TOPK_TILE_ITEMS + 1)
                + 4 * TOPK_TILE_QUERIES * TOPK_TILE_ITEMS + 4 * TOPK_TILE_QUERIES * kt
                + TOPK_TILE_QUERIES + TOPK_TILE_QUERIES * (TOPK_TILE_ITEMS // 32))


def topk_run_tiled_smem(rank: int, kt: int) -> int:
    """``topk_run_tiled_kernel``'s (run_tiled_smem_bytes in the .cu): q
    rows, the step's rank chunk (:data:`TOPK_TILED_CHUNK` rows of
    :data:`TOPK_STEP_STRIDE` floats), one candidate buffer, two copies of
    the running lists, three sets of survivor counts, a step's exclusion
    bits and :data:`TOPK_PEND_MAX` pending keys a query."""
    return 4 * (TOPK_TILE_QUERIES * rank + TOPK_TILED_CHUNK * TOPK_STEP_STRIDE
                + 2 * TOPK_TILE_QUERIES * TOPK_TILE_ITEMS + 4 * TOPK_TILE_QUERIES * kt
                + 3 * TOPK_TILE_QUERIES
                + TOPK_TILE_QUERIES * (TOPK_STEP_TILES * TOPK_TILE_ITEMS // 32)
                + 2 * TOPK_TILE_QUERIES * TOPK_PEND_MAX)


def topk_select_score_smem(rank: int) -> int:
    """``topk_select_score_kernel``'s dynamic shared memory
    (select_score_smem_bytes in the .cu): q rows, the step's rank chunk
    (the tiled running list's, :data:`TOPK_TILED_CHUNK` rows of
    :data:`TOPK_STEP_STRIDE` floats), a histogram of
    :data:`TOPK_SELECT_BINS` counts for each of the block's queries and a
    step's exclusion bits."""
    return 4 * (TOPK_TILE_QUERIES * rank + TOPK_TILED_CHUNK * TOPK_STEP_STRIDE
                + TOPK_TILE_QUERIES * TOPK_SELECT_BINS
                + TOPK_TILE_QUERIES * (TOPK_STEP_TILES * TOPK_TILE_ITEMS // 32))


def topk_select_survivors(k_eff: int) -> int:
    """Keys the select kernel's block holds and sorts for one query: the
    bitonic network's length for k keys, the power of two at or above k,
    and 2,048 at least. Keys from the boundary bin up that do not fit are
    counted again on the next bits: at k = 4,096 those passes over the
    query's scores cost less than sorting twice as many keys; up to k =
    1,024 the boundary bin's keys beside the k above it fit 2,048 without
    a pass (measured on the card: PERF.md)."""
    return max(TOPK_SELECT_MIN_SURVIVORS, 1 << (k_eff - 1).bit_length())


def topk_select_smem(survivors: int) -> int:
    """``topk_select_kernel``'s (select_smem_bytes in the .cu): the
    survivors as packed 8-byte keys, one histogram and 64 ints of block
    scan and counters."""
    return 8 * survivors + 4 * (TOPK_SELECT_BINS + 64)


def topk_select_row(n_items: int) -> int:
    """Floats of a query's select scratch: its scores, N rounded up to 4
    (16-byte stores and loads), then its histogram."""
    return 4 * _cdiv(n_items, 4) + TOPK_SELECT_BINS


@functools.lru_cache(maxsize=256)
def topk_launch_plan(b: int, n_items: int, k_eff: int, sm_count: int,
                     rank: int, stage1: Optional[str] = None) -> TopkPlan:
    """The launch plan of the streaming top-k for ``b`` queries of width
    ``rank`` over ``n_items`` items, ``k_eff = min(k, n_items)``, on a
    card with ``sm_count`` SMs. Pure arithmetic (the C entry point checks
    it and refuses a plan that does not match its own).

    Stage 1 walks ``tiles_per_block`` (T) consecutive item tiles per
    block with a running list of k keys, so a query leaves ``n_runs``
    lists for the tree merge instead of one per tile: ``running_list`` up
    to k = :data:`TOPK_RUN_NARROW_MAX_K`, ``running_list_tiled`` above it
    up to :data:`TOPK_RUN_MAX_KT`. T is 1 while one block per (query tile,
    item tile) fits the card in one wave (the blocks an SM holds at once:
    :data:`TOPK_BLOCKS_PER_SM`, or :data:`TOPK_TILED_BLOCKS_PER_SM`, or
    fewer by their shared memory), and grows with the batch beyond that;
    the runs are then evened out, and the tiled kernel's (and the select
    path's) T is rounded up to whole steps of :data:`TOPK_STEP_TILES`
    tiles (or the whole catalog). For 256 < k <=
    :data:`TOPK_SELECT_MAX_K` the plan picks the threshold select
    (``select``): its scoring blocks walk runs of T tiles as the tiled
    running list does, store every score and count it, and one block of
    :data:`TOPK_SELECT_THREADS` a query then sorts only the keys from the
    k-th key's bin up (``survivors`` of them at most,
    :func:`topk_select_survivors`; ``merge_smem`` and ``merge_threads``
    are that block's). Above it, or for a rank whose q rows do not fit in
    shared memory, stage 1 sorts every tile (``tile_sort``, T = 1).
    ``stage1`` names the kernel instead of the plan's pick (the running
    lists take k up to :data:`TOPK_RUN_MAX_KT`, the select path up to
    :data:`TOPK_SELECT_MAX_K`); it raises where that kernel cannot run.
    The merge rounds run in shared memory when two copies of a query's
    lists fit, else between the scratch and a second one."""
    if min(b, n_items, k_eff, sm_count, rank) < 1 or k_eff > n_items:
        raise ValueError(
            f"no launch plan for b={b}, n_items={n_items}, k_eff={k_eff}, "
            f"sm_count={sm_count}, rank={rank}"
        )
    kt = min(k_eff, TOPK_TILE_ITEMS)
    n_tiles = _cdiv(n_items, TOPK_TILE_ITEMS)
    n_query_tiles = _cdiv(b, TOPK_TILE_QUERIES)
    smem = {"running_list": topk_run_smem(rank, kt),
            "running_list_tiled": topk_run_tiled_smem(rank, kt),
            "select": topk_select_score_smem(rank)}
    max_k = {"tile_sort": TOPK_MAX_K, "running_list": TOPK_RUN_MAX_KT,
             "running_list_tiled": TOPK_RUN_MAX_KT, "select": TOPK_SELECT_MAX_K}
    if stage1 is None:
        stage1 = ("running_list" if k_eff <= TOPK_RUN_NARROW_MAX_K
                  else "running_list_tiled" if k_eff <= TOPK_RUN_MAX_KT
                  else "select" if k_eff <= TOPK_SELECT_MAX_K else "tile_sort")
        if stage1 != "tile_sort" and smem[stage1] > TOPK_MAX_SMEM:
            stage1 = "tile_sort"
    elif stage1 not in TOPK_STAGE1 or k_eff > max_k[stage1] or (
            stage1 != "tile_sort" and smem[stage1] > TOPK_MAX_SMEM):
        raise ValueError(f"stage 1 {stage1!r} cannot take k={k_eff} at rank {rank}")
    if stage1 == "tile_sort":
        stage1_smem, tiles_per_block, n_runs = 0, 1, n_tiles
    else:
        stage1_smem = smem[stage1]
        per_sm = {"running_list": TOPK_BLOCKS_PER_SM,
                  "running_list_tiled": TOPK_TILED_BLOCKS_PER_SM,
                  "select": TOPK_SELECT_BLOCKS_PER_SM}[stage1]
        # as many runs as fit the card in one wave of blocks, evened out
        resident = min(per_sm, TOPK_SM_SMEM // (stage1_smem + TOPK_BLOCK_SMEM_RESERVE))
        n_runs = (resident * sm_count) // n_query_tiles
        tiles_per_block = _cdiv(n_tiles, min(max(1, n_runs), n_tiles))
        if stage1 != "running_list":  # whole steps, or the whole catalog
            tiles_per_block = min(n_tiles, _cdiv(tiles_per_block, TOPK_STEP_TILES)
                                  * TOPK_STEP_TILES)
        n_runs = _cdiv(n_tiles, tiles_per_block)
    if stage1 == "select":
        survivors = topk_select_survivors(k_eff)
        return TopkPlan(
            kt=kt, n_tiles=n_tiles, tiles_per_block=tiles_per_block, n_runs=n_runs,
            query_tile=TOPK_TILE_QUERIES, n_query_tiles=n_query_tiles,
            scratch_shape=(b, 1, topk_select_row(n_items)), stage1=stage1,
            stage1_smem=stage1_smem, merge_smem=topk_select_smem(survivors),
            merge_threads=TOPK_SELECT_THREADS, survivors=survivors)
    keys = n_runs * kt
    merge_smem = 16 * keys if 16 * keys <= TOPK_MAX_SMEM else 0
    return TopkPlan(
        kt=kt, n_tiles=n_tiles, tiles_per_block=tiles_per_block,
        n_runs=n_runs, query_tile=TOPK_TILE_QUERIES,
        n_query_tiles=n_query_tiles, scratch_shape=(b, n_runs, kt),
        stage1=stage1, stage1_smem=stage1_smem, merge_smem=merge_smem,
        # one block merges a query's lists in shared memory; in device
        # memory every round is a launch of 256-thread blocks
        merge_threads=64 if keys <= 128 else 256 if keys <= 1024 else 1024,
    )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _configured(name: str, argtypes) -> ctypes.CDLL:
    """Kernel library ``name`` with its entry points' ctypes signatures set
    (every pointer and the stream as ``c_void_p``, ints as ``c_int``): its
    ``pio_<name>`` and the entries :data:`_EXTRA_ENTRIES` lists for it."""
    lib = build.load_library(name)
    if not getattr(lib, "_pio_configured", False):
        entries = {f"pio_{name}": argtypes, **_EXTRA_ENTRIES.get(name, {})}
        for entry_name, types in entries.items():
            entry = getattr(lib, entry_name)
            entry.argtypes = types
            entry.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        lib._pio_configured = True
    return lib


_ATTRS_ARGTYPES = [ctypes.POINTER(ctypes.c_int)]
#: each library's entries beside ``pio_<name>``: the wide paths, the
#: resident attention path and the ``cudaFuncGetAttributes`` reports
_EXTRA_ENTRIES = {
    "topk_streaming": {
        "pio_topk_select": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 5,
        "pio_topk_streaming_attrs": _ATTRS_ARGTYPES,
        "pio_topk_streaming_occupancy": [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)],
    },
    "gramian_fused": {
        "pio_gramian_rows": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4,
        "pio_gramian_fused_attrs": _ATTRS_ARGTYPES,
    },
    "spd_solve": {
        "pio_spd_solve_wide": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "pio_spd_solve_blocked": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
        "pio_spd_solve_cluster": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
        "pio_spd_solve_tiled": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] * 2 + [ctypes.c_void_p],
        "pio_spd_solve_tiled_attrs": _ATTRS_ARGTYPES,
        "pio_spd_solve_attrs": _ATTRS_ARGTYPES,
        "pio_spd_solve_cluster_attrs": _ATTRS_ARGTYPES,
        "pio_spd_solve_cluster_occupancy": [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)],
    },
    "flash_attention": {
        "pio_flash_attention_wide": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p],
        "pio_flash_attention_resident": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
        "pio_flash_attention_streamed": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
        "pio_flash_attention_wide_streamed": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
        "pio_flash_attention_cluster": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
        + [ctypes.c_void_p],
        "pio_flash_attention_cluster_occupancy": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
        "pio_flash_attention_cluster_attrs": _ATTRS_ARGTYPES,
        "pio_flash_attention_attrs": _ATTRS_ARGTYPES,
        "pio_flash_attention_wide_attrs": _ATTRS_ARGTYPES,
        "pio_flash_attention_resident_attrs": _ATTRS_ARGTYPES,
        "pio_flash_attention_streamed_attrs": _ATTRS_ARGTYPES,
        "pio_flash_attention_wide_streamed_attrs": _ATTRS_ARGTYPES,
    },
}


def _raise_on_error(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.pio_cuda_error_string(code).decode(errors="replace")
        raise build.KernelLaunchError(f"{name} launch failed: {msg}")


def _check_topk_inputs(query_vectors, item_factors, k, exclude_idx) -> None:
    for name, t in (("query_vectors", query_vectors),
                    ("item_factors", item_factors)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if query_vectors.shape[1] != item_factors.shape[1]:
        raise ValueError(
            f"rank mismatch: queries {tuple(query_vectors.shape)} vs items "
            f"{tuple(item_factors.shape)}"
        )
    if query_vectors.device != item_factors.device:
        raise ValueError(
            f"queries on {query_vectors.device}, items on {item_factors.device}"
        )
    if not isinstance(k, int) or k < 0:
        raise ValueError(f"k must be a non-negative int, got {k!r}")
    if exclude_idx is not None:
        if not isinstance(exclude_idx, torch.Tensor):
            raise TypeError("exclude_idx must be a torch.Tensor or None")
        if exclude_idx.dim() != 2 or exclude_idx.shape[0] != query_vectors.shape[0]:
            raise ValueError(
                f"exclude_idx must be [B, E] with B = {query_vectors.shape[0]},"
                f" got {tuple(exclude_idx.shape)}"
            )
        if exclude_idx.dtype != torch.int32:
            raise TypeError(f"exclude_idx must be int32, got {exclude_idx.dtype}")
        if not exclude_idx.is_contiguous():
            raise ValueError("exclude_idx must be contiguous")
        if exclude_idx.device != query_vectors.device:
            raise ValueError(
                f"exclude_idx on {exclude_idx.device}, queries on "
                f"{query_vectors.device}"
            )


def _pad_k(scores, idx, k: int):
    """Pad [B, k_eff] results back to k with (-inf, -1)."""
    pad = k - scores.shape[1]
    if pad <= 0:
        return scores, idx
    b = scores.shape[0]
    scores = torch.cat(
        [scores, scores.new_full((b, pad), NEG_INF)], dim=1
    )
    idx = torch.cat([idx, idx.new_full((b, pad), -1)], dim=1)
    return scores, idx


def top_k_streaming_reference(
    query_vectors: torch.Tensor,  # [B, R] float32
    item_factors: torch.Tensor,  # [N, R] float32
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,  # [B, E] int32, -1 padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the streaming top-k, on any device.

    Same contract as the kernel: score descending, index ascending on
    ties (a stable descending sort keeps equal scores in index order),
    excluded ids score -inf, every -inf slot carries index -1, k clamped
    to N and padded back. Materializes the ``[B, N]`` scores — it is the
    yardstick of correctness, not of speed."""
    _check_topk_inputs(query_vectors, item_factors, k, exclude_idx)
    b, n_items = query_vectors.shape[0], item_factors.shape[0]
    k_eff = min(k, n_items)
    scores = query_vectors @ item_factors.T
    if exclude_idx is not None and exclude_idx.shape[1] > 0:
        excl = exclude_idx.long()
        hit = (excl >= 0) & (excl < n_items)
        rows = torch.arange(b, device=excl.device)[:, None].expand_as(excl)
        scores[rows[hit], excl[hit]] = NEG_INF
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k_eff].contiguous()
    top_i = top_i[:, :k_eff].to(torch.int32)
    top_i = torch.where(torch.isneginf(top_s), -1, top_i)
    return _pad_k(top_s, top_i, k)


def topk_scratch_bytes(plan: TopkPlan) -> int:
    """Device memory the launch of ``plan`` allocates for its stage-1
    lists: scores and ids (8 bytes a key), twice when the merge rounds
    run between two scratches (``merge_smem == 0``). On the select path
    a query's scores and histogram, 4 bytes each (:func:`topk_select_row`:
    about 4·N bytes a query); its survivors stay in shared memory."""
    b, n_runs, kt = plan.scratch_shape
    if plan.stage1 == "select":
        return 4 * b * n_runs * kt
    return b * n_runs * kt * (16 if plan.merge_smem == 0 else 8)


def topk_batch_slices(b: int, max_batch: int = TOPK_MAX_BATCH, *,
                      n_items: Optional[int] = None, k_eff: Optional[int] = None,
                      rank: Optional[int] = None, sm_count: Optional[int] = None,
                      stage1: Optional[str] = None):
    """The ``[start, stop)`` row ranges one call of ``b`` queries is cut
    into: consecutive, covering every row once (none for ``b = 0``), at
    most ``max_batch`` rows each. Each range is one launch of the kernel
    (or one call of the plain version on the CPU).

    Given the catalog (``n_items``, with ``k_eff``, ``rank`` and the
    card's ``sm_count``, and ``stage1``: what :func:`topk_launch_plan`
    reads), a range is
    also cut so that its launch's scratch (:func:`topk_scratch_bytes`)
    stays within :data:`TOPK_MAX_SCRATCH_BYTES` — but never below one query tile of
    :data:`TOPK_TILE_QUERIES` rows, whatever one query's lists take. On
    a running list (k <= :data:`TOPK_RUN_MAX_KT`) a launch keeps about one
    wave of lists, far below the budget, so those plans keep the
    ``max_batch`` ranges; the select path (256 < k <=
    :data:`TOPK_SELECT_MAX_K`) keeps every score and a histogram, about
    4·N + 8 KB a query, and is cut past about 18,500 queries on 27,000
    items; the per-tile path (above it, or forced) keeps every tile's
    list, about 8·N bytes a query (16·N with the merge in device memory),
    and is cut sooner. Pure arithmetic."""
    if b < 0 or max_batch < 1:
        raise ValueError(f"no batch slices for b={b}, max_batch={max_batch}")
    rows = max_batch
    if n_items is not None and b > 0:
        rows = min(rows, b)
        # a smaller slice can only keep as many lists a query or more, so
        # the rows shrink until the slice fits (or reach one query tile)
        while rows > TOPK_TILE_QUERIES:
            plan = topk_launch_plan(rows, n_items, k_eff, sm_count, rank, stage1)
            scratch = topk_scratch_bytes(plan)
            if scratch <= TOPK_MAX_SCRATCH_BYTES:
                break
            per_query = _cdiv(scratch, rows)
            fit = (TOPK_MAX_SCRATCH_BYTES // per_query) // TOPK_TILE_QUERIES * TOPK_TILE_QUERIES
            rows = max(TOPK_TILE_QUERIES, min(fit, rows - TOPK_TILE_QUERIES))
    return [(s, min(s + rows, b)) for s in range(0, b, rows)]


def top_k_streaming(
    query_vectors: torch.Tensor,  # [B, R] float32
    item_factors: torch.Tensor,  # [N, R] float32
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,  # [B, E] int32, -1 padded
    stage1: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k gather-dot: (scores ``[B, k]`` f32, item indices
    ``[B, k]`` i32) without materializing ``[B, N]`` scores on the card.

    The counterpart of ``pallas_kernels.top_k_streaming`` (same sentinel
    contract: a slot with fewer than k valid candidates holds -inf and
    index -1, which callers must treat as absent). CUDA tensors launch
    ``csrc/topk_streaming.cu``; CPU tensors run
    :func:`top_k_streaming_reference`. Any batch is answered: one above
    :data:`TOPK_MAX_BATCH` queries is cut by :func:`topk_batch_slices`,
    each slice written into its rows of one ``[B, k]`` output; on the
    card a slice is also cut so that its scratch stays within
    :data:`TOPK_MAX_SCRATCH_BYTES`. Any k is taken: it is clamped to N,
    and N may reach :data:`TOPK_MAX_ITEMS`. ``stage1`` forces a stage-1
    kernel on the card (:func:`topk_launch_plan`); the answer is the same
    bit for bit, only the time differs. The CPU ignores it."""
    _check_topk_inputs(query_vectors, item_factors, k, exclude_idx)
    b, r = query_vectors.shape
    n_items = item_factors.shape[0]
    k_eff = min(k, n_items)
    # the kernel's limits on k and the catalog hold on every device, so a
    # CPU run refuses what the card would; the batch is sliced on both
    if k_eff > TOPK_MAX_K:
        raise ValueError(
            f"k = {k_eff} exceeds the streaming kernel's ceiling {TOPK_MAX_K}"
        )
    if n_items > TOPK_MAX_ITEMS:
        raise ValueError(f"catalog of {n_items} items exceeds {TOPK_MAX_ITEMS}")
    if r == 0:
        raise ValueError("the streaming kernel needs rank >= 1")
    if stage1 is not None and stage1 not in TOPK_STAGE1:
        raise ValueError(f"stage1 must be one of {TOPK_STAGE1}, got {stage1!r}")
    device = query_vectors.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"top_k_streaming runs on cuda or cpu, not {device}")
    out_s = torch.empty((b, k_eff), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k_eff), dtype=torch.int32, device=device)
    if k_eff > 0:  # else nothing to score: every slot is a sentinel
        if device.type == "cuda":
            index = device.index if device.index is not None else torch.cuda.current_device()
            slices = topk_batch_slices(b, n_items=n_items, k_eff=k_eff, rank=r,
                                       sm_count=_sm_count(index), stage1=stage1)
        else:  # the plain version keeps no scratch
            slices = topk_batch_slices(b)
        for start, stop in slices:
            excl = None if exclude_idx is None else exclude_idx[start:stop]
            _topk_slice(query_vectors[start:stop], item_factors, k_eff, excl,
                        out_s[start:stop], out_i[start:stop], stage1)
    return _pad_k(out_s, out_i, k)


def _topk_slice(q, item_factors, k_eff, exclude_idx, out_s, out_i,
                stage1: Optional[str] = None) -> None:
    """One slice of :func:`topk_batch_slices` into its rows
    ``out_s``/``out_i`` (contiguous views of the call's output): the
    plain version on the CPU, one launch of the kernel on the card."""
    if q.device.type == "cpu":
        s, i = top_k_streaming_reference(q, item_factors, k_eff, exclude_idx)
        out_s.copy_(s)
        out_i.copy_(i)
        return
    b, r = q.shape
    n_items = item_factors.shape[0]
    device = q.device
    e = 0 if exclude_idx is None else exclude_idx.shape[1]
    index = device.index if device.index is not None else torch.cuda.current_device()
    plan = topk_launch_plan(b, n_items, k_eff, _sm_count(index), r, stage1)
    lib = _configured("topk_streaming", _TOPK_ARGTYPES)
    if plan.stage1 == "select":
        _topk_select_slice(lib, plan, q, item_factors, k_eff, exclude_idx, e, out_s, out_i)
        return
    # one allocation: scores and ids of the stage-1 lists, and a second
    # copy of both when the merge rounds do not fit in shared memory
    keys = b * plan.n_runs * plan.kt
    scratch = torch.empty(
        (4 if plan.merge_smem == 0 else 2, keys), dtype=torch.float32, device=device
    )
    base, step = scratch.data_ptr(), 4 * keys
    alt = (base + 2 * step, base + 3 * step) if plan.merge_smem == 0 else (None, None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.pio_topk_streaming(
            q.data_ptr(), item_factors.data_ptr(),
            exclude_idx.data_ptr() if e else None,
            b, n_items, r, e, k_eff, plan.kt, plan.n_tiles,
            plan.tiles_per_block, plan.n_runs, TOPK_STAGE1.index(plan.stage1),
            plan.stage1_smem, plan.merge_smem, plan.merge_threads,
            base, base + step, alt[0], alt[1],
            out_s.data_ptr(), out_i.data_ptr(), stream,
        )
    top_k_streaming.launches += 1
    top_k_streaming.launches_by_stage1[plan.stage1] += 1
    _raise_on_error(lib, "topk_streaming", code)


def _topk_select_slice(lib, plan, q, item_factors, k_eff, exclude_idx, e, out_s,
                       out_i) -> None:
    """One launch of the select path (``pio_topk_select``): its scratch
    is a query's scores and histogram (:func:`topk_select_row`), one
    allocation; it raises if the launch fails."""
    b, r = q.shape
    n_items = item_factors.shape[0]
    row = plan.scratch_shape[2]
    ld = row - TOPK_SELECT_BINS
    scratch = torch.empty((b, row), dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.pio_topk_select(
            q.data_ptr(), item_factors.data_ptr(),
            exclude_idx.data_ptr() if e else None,
            b, n_items, r, e, k_eff, plan.n_tiles, plan.tiles_per_block, plan.n_runs,
            ld, plan.stage1_smem, plan.merge_smem, plan.survivors,
            base, base + 4 * b * ld, out_s.data_ptr(), out_i.data_ptr(), stream,
        )
    top_k_streaming.launches += 1
    top_k_streaming.launches_by_stage1["select"] += 1
    _raise_on_error(lib, "topk_select", code)


#: kernel launches since the count was last reset (CUDA tensors only), and
#: the same launches by the plan's stage-1 kernel
top_k_streaming.launches = 0
top_k_streaming.launches_by_stage1 = dict.fromkeys(TOPK_STAGE1, 0)

_TOPK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_void_p] * 7
#: the kernels ``pio_topk_streaming_attrs`` reports on, in its order
TOPK_KERNELS = ("running_list", "running_list_tiled", "tile_sort", "merge",
                "merge_round", "store", "select_score", "select")


def topk_blocks_per_sm(stage1: str, smem: int, device=None) -> int:
    """Blocks of the running-list kernel ``stage1`` an SM holds at
    ``smem`` bytes of dynamic shared memory, set up as its launch sets it
    up (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _configured("topk_streaming", _TOPK_ARGTYPES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "topk_streaming_occupancy", lib.pio_topk_streaming_occupancy(
            TOPK_STAGE1.index(stage1), smem, ctypes.byref(out)))
    return out.value


def topk_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of every top-k kernel (:data:`TOPK_KERNELS`), as
    ``cudaFuncGetAttributes`` reports them on the card."""
    lib = _configured("topk_streaming", _TOPK_ARGTYPES)
    out = (ctypes.c_int * (3 * len(TOPK_KERNELS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "topk_streaming_attrs", lib.pio_topk_streaming_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {name: dict(zip(keys, out[3 * n:3 * n + 3]))
            for n, name in enumerate(TOPK_KERNELS)}


def top_k_for_users_streaming(
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    user_idx: torch.Tensor,
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Known-user wrapper (gather user vectors, then stream)."""
    return top_k_streaming(
        user_factors[user_idx.long()].contiguous(), item_factors, k,
        exclude_idx,
    )


def _check_tensor(name, t, dims, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != dims:
        raise ValueError(f"{name} must be {dims}-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


# -- fused gather + Gramian (csrc/gramian_fused.cu) --------------------------
#: the widest rank R of the tuned path (kMaxR: one thread per 4 x 4 block of
#: [A | b], at most 576 threads a block); wider R take the general-rank path
GRAMIAN_MAX_RANK = 128
#: ratings staged in shared memory per step (kKTile); a chunk is a whole
#: number of them
GRAMIAN_K_TILE = 32
#: each thread owns a 4 x 4 block of the system (kTile)
GRAMIAN_BLOCK_TILE = 4
#: registers a thread of the chunk kernel takes (``-Xptxas -v``; chip_smoke
#: holds it against ``cudaFuncGetAttributes``): with the threads and the
#: shared memory of a block it sets how many blocks an SM holds at once
GRAMIAN_REGS = 69
#: a split row's chunks aim at this many waves of resident blocks
GRAMIAN_WAVES = 4
#: no chunk is narrower than this many ratings (kMinChunk)
GRAMIAN_MIN_CHUNK = 256
#: an SM's registers, shared memory, and what the card keeps of the latter
#: for each block; the most blocks and threads an SM holds (H100)
_SM_REGS, _SM_SMEM, _BLOCK_SMEM_RESERVE = 65536, 233472, 1024
_SM_MAX_BLOCKS, _SM_MAX_THREADS = 32, 2048
#: threads of a block of the reduce pass
GRAMIAN_REDUCE_THREADS = 256


class GramianPlan(NamedTuple):
    """What one launch of ``csrc/gramian_fused.cu`` needs beyond its
    tensors (see :func:`gramian_launch_plan`)."""

    threads: int  #: threads of a chunk block
    chunk: int  #: kc, ratings of a row one chunk block walks (a multiple of 32)
    n_chunks: int  #: S = ceil(K / kc), chunk blocks per row
    blocks: int  #: chunk blocks, B * S
    chunk_smem: int  #: dynamic shared memory of a chunk block, bytes
    partial: int  #: P = R(R+1)/2 + R floats of a chunk's partial system
    scratch_shape: Tuple[int, int, int]  #: [B, S, P] f32; (0, 0, 0) when S = 1
    reduce_smem: int  #: dynamic shared memory of a reduce block, bytes
    blocks_per_sm: int  #: chunk blocks an SM holds at once
    path: str = "tuned"  #: "tuned" (R <= GRAMIAN_MAX_RANK), "rows" or "wide" (tiles)
    tiles: int = 1  #: output tiles of a row's [A | b] (the wide path's blocks a
    #: chunk; the rows path's register tiles a row)


@functools.lru_cache(maxsize=256)
def gramian_launch_plan(b: int, k: int, r: int, sm_count: int) -> GramianPlan:
    """The launch plan of the gather + Gramian build for ``b`` rows of
    ``k`` rating slots at rank ``r`` on a card of ``sm_count`` SMs. Pure
    arithmetic (the C entry point checks it and refuses a plan that does
    not match its own).

    A row is cut into ``S`` chunks of ``kc`` slots, one block each. While
    ``b`` blocks already fill every SM (the blocks an SM holds, from the
    kernel's registers and shared memory), ``S = 1``: one pass writes the
    systems. Otherwise ``S`` grows until ``b * S`` blocks make
    :data:`GRAMIAN_WAVES` waves, with chunks no narrower than
    :data:`GRAMIAN_MIN_CHUNK`; each chunk block writes its partial system
    to a ``[B, S, P]`` scratch and a second pass adds the ``S`` partials
    of each row in chunk order."""
    if min(b, sm_count, r) < 1 or k < 0 or r > GRAMIAN_MAX_RANK:
        raise ValueError(
            f"no gramian launch plan for b={b}, k={k}, r={r}, sm_count={sm_count}"
        )
    tile, kt = GRAMIAN_BLOCK_TILE, GRAMIAN_K_TILE
    # 4 x 4 blocks: rows of A by columns of [A | b] (b is column R)
    t, tc = _cdiv(r, tile), _cdiv(r + 1, tile)
    # one thread per block of A's upper triangle, plus (i, T) when column R
    # needs a block column of its own
    blocks = t * (t + 1) // 2 + (t if tc > t else 0)
    threads = _cdiv(blocks, 32) * 32
    # shared memory: the two operands of a tile, two slots of its weights
    tiles = kt * (t + tc) * tile + 6 * kt + 4
    partial = r * (r + 1) // 2 + r
    warp_regs = 32 * _cdiv(GRAMIAN_REGS, 8) * 8
    blocks_per_sm = min(
        _SM_REGS // (threads // 32 * warp_regs),
        _SM_SMEM // (4 * tiles + _BLOCK_SMEM_RESERVE),
        _SM_MAX_BLOCKS,
        _SM_MAX_THREADS // threads,
    )
    resident = blocks_per_sm * sm_count
    n_chunks = 1
    if b < resident and k > GRAMIAN_MIN_CHUNK:
        want = _cdiv(GRAMIAN_WAVES * resident, b)
        kc = max(GRAMIAN_MIN_CHUNK, _cdiv(_cdiv(k, want), kt) * kt)
        n_chunks = _cdiv(k, kc)
    # the same number of chunks, evened out (a split chunk stays at least
    # GRAMIAN_MIN_CHUNK wide)
    kc = _cdiv(max(k, 1), n_chunks * kt) * kt
    if n_chunks > 1:
        kc = max(GRAMIAN_MIN_CHUNK, kc)
    n_chunks = max(1, _cdiv(k, kc))
    split = n_chunks > 1
    # the finished system (or partial) is staged where the tiles were
    chunk_smem = 4 * max(tiles, partial if split else r * r + r)
    return GramianPlan(
        threads=threads, chunk=kc, n_chunks=n_chunks,
        blocks=b * n_chunks, chunk_smem=chunk_smem, partial=partial,
        scratch_shape=(b, n_chunks, partial) if split else (0, 0, 0),
        reduce_smem=4 * partial if split else 0, blocks_per_sm=blocks_per_sm,
    )


# the general-rank path (R > GRAMIAN_MAX_RANK)
#: side of an output tile of [A | b] (kWTile) and threads a block (kWThreads,
#: a 4 x 4 block each)
GRAMIAN_WIDE_TILE, GRAMIAN_WIDE_THREADS = 64, 256
#: registers a thread at most: the kernel's launch bound of 4 blocks an SM
GRAMIAN_WIDE_REGS = 64
#: static shared memory of a block: the two staged operands [32][64], the
#: finished tile [64][65] and two slots of a tile's weights, indices and counts
GRAMIAN_WIDE_SMEM = 4 * (2 * GRAMIAN_K_TILE * GRAMIAN_WIDE_TILE
                         + GRAMIAN_WIDE_TILE * (GRAMIAN_WIDE_TILE + 1)
                         + 6 * GRAMIAN_K_TILE + 3)
#: the widest R the general-rank path takes (kWMaxR: R * R stays an int)
GRAMIAN_WIDE_MAX_RANK = 46340


def gramian_wide_tiles(r: int) -> int:
    """Output tiles of the upper triangle of one row's ``[A | b]`` (R
    rows, R + 1 columns) on the general-rank path."""
    tr, tcw = _cdiv(r, GRAMIAN_WIDE_TILE), _cdiv(r + 1, GRAMIAN_WIDE_TILE)
    return tr * tcw - tr * (tr - 1) // 2


@functools.lru_cache(maxsize=256)
def gramian_wide_launch_plan(b: int, k: int, r: int, sm_count: int,
                             chunk: Optional[int] = None) -> GramianPlan:
    """The launch plan of the build's tile path (``r`` above
    :data:`GRAMIAN_ROWS_MAX_RANK`, or any ``r`` above
    :data:`GRAMIAN_MAX_RANK` to compare it with the rows path): one block
    of :data:`GRAMIAN_WIDE_THREADS` per (row, output tile, chunk). The
    chunks follow :func:`gramian_launch_plan`'s rule with ``b * tiles``
    blocks in place of ``b``: one pass while they fill every SM, else ``S``
    chunks a row of at least :data:`GRAMIAN_MIN_CHUNK` ratings and the
    chunk-order reduce; ``chunk`` forces ``kc`` (the rows path's, for
    bits at equal chunks). Pure arithmetic, checked again by the C entry
    point."""
    if (min(b, sm_count) < 1 or k < 0 or not GRAMIAN_MAX_RANK < r <= GRAMIAN_WIDE_MAX_RANK):
        raise ValueError(
            f"no gramian wide launch plan for b={b}, k={k}, r={r}, sm_count={sm_count}"
        )
    kt, threads = GRAMIAN_K_TILE, GRAMIAN_WIDE_THREADS
    tiles = gramian_wide_tiles(r)
    partial = r * (r + 1) // 2 + r
    blocks_per_sm = min(
        _SM_REGS // (threads * GRAMIAN_WIDE_REGS),
        _SM_SMEM // (GRAMIAN_WIDE_SMEM + _BLOCK_SMEM_RESERVE),
        _SM_MAX_BLOCKS, _SM_MAX_THREADS // threads,
    )
    resident = blocks_per_sm * sm_count
    if chunk is not None:
        kc, n_chunks = _forced_chunks(k, chunk)
    else:
        n_chunks = 1
        if b * tiles < resident and k > GRAMIAN_MIN_CHUNK:
            want = _cdiv(GRAMIAN_WAVES * resident, b * tiles)
            kc = max(GRAMIAN_MIN_CHUNK, _cdiv(_cdiv(k, want), kt) * kt)
            n_chunks = _cdiv(k, kc)
        kc = _cdiv(max(k, 1), n_chunks * kt) * kt
        if n_chunks > 1:
            kc = max(GRAMIAN_MIN_CHUNK, kc)
        n_chunks = max(1, _cdiv(k, kc))
    split = n_chunks > 1
    return GramianPlan(
        threads=threads, chunk=kc, n_chunks=n_chunks,
        blocks=b * tiles * n_chunks, chunk_smem=0, partial=partial,
        scratch_shape=(b, n_chunks, partial) if split else (0, 0, 0),
        reduce_smem=0, blocks_per_sm=blocks_per_sm, path="wide", tiles=tiles,
    )


# the rows path (GRAMIAN_MAX_RANK < R <= GRAMIAN_ROWS_MAX_RANK)
#: a thread's register tile of A is kRTile x kRTile (a tile of b kRTile x 1);
#: the thread map walks groups of kRGroup block rows
GRAMIAN_ROWS_TILE, GRAMIAN_ROWS_GROUP = 8, 4
#: the most threads a block (kRMaxThreads: the launch bound, 128 registers a
#: thread) and register tiles a thread walks a step (kRMaxRounds)
GRAMIAN_ROWS_MAX_THREADS, GRAMIAN_ROWS_MAX_ROUNDS = 512, 4
#: steps of live weights, rhs and rows in shared memory (kRMeta)
GRAMIAN_ROWS_META = 3
#: the shared memory one block may opt into (kMaxSmem, H100)
GRAMIAN_MAX_SMEM = 232448
#: registers a thread of each rows-path kernel takes, read off the card
#: (``gramian_kernel_attributes``; chip_smoke holds the card to every entry):
#: one pass and split, holding two steps of rows or one, and the reduce
GRAMIAN_ROWS_REGS = {"rows_one_pass": 118, "rows_split": 118, "rows_one_pass_s1": 125,
                     "rows_split_s1": 116, "rows_reduce": 128}
#: a split row's chunks aim at this many waves of resident blocks (a row's
#: live length varies, so more, shorter blocks even out the SMs' work)
GRAMIAN_ROWS_WAVES = 16


def gramian_rows_tiles(r: int, tile: int = GRAMIAN_ROWS_TILE) -> Tuple[int, int]:
    """(T, register tiles a row) on the rows path at rank ``r``: T =
    ceil(r / tile) block rows, T(T+1)/2 tiles of A's upper triangle and T
    of b."""
    t = _cdiv(r, tile)
    return t, t * (t + 1) // 2 + t


def gramian_rows_partial(r: int, tile: int = GRAMIAN_ROWS_TILE) -> int:
    """Floats of one chunk's sums on the rows path (rows_partial in the
    .cu): tile² a tile of A, tile a tile of b."""
    t, _ = gramian_rows_tiles(r, tile)
    return tile * tile * (t * (t + 1) // 2) + tile * t


def gramian_rows_smem(r: int, tile: int = GRAMIAN_ROWS_TILE, stages: int = 2) -> int:
    """Dynamic shared memory of a rows-path block (rows_smem_bytes in the
    .cu): the chunk's sums, ``stages`` steps of gathered rows (tile·T
    floats a rating: 2 copies the next step during this one's FMAs),
    GRAMIAN_ROWS_META steps of live weights, rhs and rows, and the counts."""
    t, _ = gramian_rows_tiles(r, tile)
    meta = GRAMIAN_ROWS_META
    return 4 * (gramian_rows_partial(r, tile) + stages * GRAMIAN_K_TILE * tile * t
                + 3 * meta * GRAMIAN_K_TILE + meta + 1)


def _gramian_rows_max_rank() -> int:
    r = GRAMIAN_MAX_RANK
    while gramian_rows_smem(r + 1) <= GRAMIAN_MAX_SMEM:
        r += 1
    return r


#: the widest rank of the rows path (kRMaxR): the widest R whose block, with
#: two steps of rows, fits in GRAMIAN_MAX_SMEM; wider R take the tile path
GRAMIAN_ROWS_MAX_RANK = _gramian_rows_max_rank()


def gramian_rows_threads(r: int, tile: int = GRAMIAN_ROWS_TILE, rounds: int = 0,
                         max_rounds: int = GRAMIAN_ROWS_MAX_ROUNDS) -> int:
    """Threads of a rows-path block: a row's register tiles over ``rounds``
    rounds (at least the fewest of at most GRAMIAN_ROWS_MAX_THREADS, at most
    ``max_rounds``), rounded up to a warp."""
    _, items = gramian_rows_tiles(r, tile)
    rounds = max(rounds, _cdiv(items, GRAMIAN_ROWS_MAX_THREADS))
    if rounds > max_rounds:
        raise ValueError(f"{items} register tiles take more than {max_rounds} rounds")
    return _cdiv(_cdiv(items, rounds), 32) * 32


def _forced_chunks(k: int, chunk: int) -> Tuple[int, int]:
    """(kc, S) for a forced chunk width: a positive multiple of
    GRAMIAN_K_TILE, at least GRAMIAN_MIN_CHUNK when the row is split."""
    kt = GRAMIAN_K_TILE
    if chunk < kt or chunk % kt:
        raise ValueError(f"a chunk is a positive multiple of {kt}, got {chunk}")
    n_chunks = max(1, _cdiv(k, chunk))
    if n_chunks > 1 and chunk < GRAMIAN_MIN_CHUNK:
        raise ValueError(f"a split chunk is at least {GRAMIAN_MIN_CHUNK} wide, got {chunk}")
    return chunk, n_chunks


def _chunks(b: int, k: int, resident: int, waves: int) -> Tuple[int, int]:
    """(kc, S): one chunk unless ``b`` rows make fewer than ``waves`` waves
    of ``resident`` blocks, then S chunks (at least GRAMIAN_MIN_CHUNK wide)
    that do, evened out."""
    kt = GRAMIAN_K_TILE
    n_chunks = 1
    if b < waves * resident and k > GRAMIAN_MIN_CHUNK:
        want = _cdiv(waves * resident, b)
        kc = max(GRAMIAN_MIN_CHUNK, _cdiv(_cdiv(k, want), kt) * kt)
        n_chunks = _cdiv(k, kc)
    kc = _cdiv(max(k, 1), n_chunks * kt) * kt
    if n_chunks > 1:
        kc = max(GRAMIAN_MIN_CHUNK, kc)
    return kc, max(1, _cdiv(k, kc))


def gramian_rows_blocks_per_sm(threads: int, smem: int) -> int:
    """Rows-path blocks an SM holds: by registers (the most any rows
    kernel takes, :data:`GRAMIAN_ROWS_REGS`, in granules of 8), shared
    memory and threads."""
    regs = _cdiv(max(GRAMIAN_ROWS_REGS.values()), 8) * 8
    return min(_SM_REGS // (threads * regs), _SM_SMEM // (smem + _BLOCK_SMEM_RESERVE),
               _SM_MAX_BLOCKS, _SM_MAX_THREADS // threads)


def gramian_rows_shape(r: int) -> Tuple[int, int, int]:
    """(steps of rows a block holds, threads, blocks an SM holds) on the
    rows path at rank ``r``: two steps of rows (the next one copied during
    this one's FMAs) at the fewest rounds of register tiles, unless one
    step and twice the rounds fits more blocks on an SM, whose latencies
    then hide behind each other's FMAs (on an H100: R <= 200 but 161-168)."""
    threads = gramian_rows_threads(r)
    best = (2, threads, gramian_rows_blocks_per_sm(threads, gramian_rows_smem(r, stages=2)))
    _, items = gramian_rows_tiles(r)
    rounds = _cdiv(items, GRAMIAN_ROWS_MAX_THREADS) * 2
    if rounds <= GRAMIAN_ROWS_MAX_ROUNDS:
        threads = gramian_rows_threads(r, rounds=rounds)
        per_sm = gramian_rows_blocks_per_sm(threads, gramian_rows_smem(r, stages=1))
        if per_sm > best[2]:
            best = (1, threads, per_sm)
    return best


@functools.lru_cache(maxsize=256)
def gramian_rows_launch_plan(b: int, k: int, r: int, sm_count: int) -> GramianPlan:
    """The launch plan of the build's rows path (``GRAMIAN_MAX_RANK < r <=
    GRAMIAN_ROWS_MAX_RANK``): one block per (row, chunk) of the threads and
    steps of rows :func:`gramian_rows_shape` picks, each thread a register
    tile or a few of the row's ``[A | b]``. One pass while the rows make
    :data:`GRAMIAN_ROWS_WAVES` waves of resident blocks, else ``S`` chunks
    a row and the chunk-order reduce. Pure arithmetic, checked again by the
    C entry point."""
    if (min(b, sm_count) < 1 or k < 0 or not GRAMIAN_MAX_RANK < r <= GRAMIAN_ROWS_MAX_RANK):
        raise ValueError(
            f"no gramian rows launch plan for b={b}, k={k}, r={r}, sm_count={sm_count}"
        )
    stages, threads, blocks_per_sm = gramian_rows_shape(r)
    smem = gramian_rows_smem(r, stages=stages)
    partial = gramian_rows_partial(r)
    kc, n_chunks = _chunks(b, k, blocks_per_sm * sm_count, GRAMIAN_ROWS_WAVES)
    split = n_chunks > 1
    return GramianPlan(
        threads=threads, chunk=kc, n_chunks=n_chunks, blocks=b * n_chunks,
        chunk_smem=smem, partial=partial,
        scratch_shape=(b, n_chunks, partial) if split else (0, 0, 0),
        reduce_smem=0, blocks_per_sm=blocks_per_sm, path="rows",
        tiles=gramian_rows_tiles(r)[1],
    )


def gramian_plan(b: int, k: int, r: int, sm_count: int) -> GramianPlan:
    """The build's launch plan, its path picked by the rank alone: the
    tuned path (:func:`gramian_launch_plan`) up to
    :data:`GRAMIAN_MAX_RANK`, the rows path
    (:func:`gramian_rows_launch_plan`) up to
    :data:`GRAMIAN_ROWS_MAX_RANK`, the tile path
    (:func:`gramian_wide_launch_plan`) above it."""
    if r > GRAMIAN_ROWS_MAX_RANK:
        return gramian_wide_launch_plan(b, k, r, sm_count)
    if r > GRAMIAN_MAX_RANK:
        return gramian_rows_launch_plan(b, k, r, sm_count)
    return gramian_launch_plan(b, k, r, sm_count)


#: the most bytes of systems (A and b) and split-path scratch that one build
#: launch of a bucket may hold on the card. Every bucket of ML-20M stays one
#: slice up to rank 128 (the users' K = 128 bucket, 97,972 rows, holds 6.5
#: GB of systems at R = 128), and a slice leaves the card's 80 GB room for
#: the tables, the solve and a second slice in flight.
ALS_SYSTEMS_MAX_BYTES = 8 << 30


def gramian_row_slices(b: int, k: int, r: int, sm_count: Optional[int] = None) -> list:
    """Cut a bucket of ``b`` rows of width ``k`` at rank ``r`` into
    consecutive ``(start, stop)`` slices whose systems (``[rows, R, R]``
    and ``[rows, R]`` f32) and, on the card (``sm_count`` given), the split
    path's ``[rows, S, P]`` scratch stay within ``ALS_SYSTEMS_MAX_BYTES``,
    evened out, never below one row. A bucket within the budget is one slice."""
    if b < 1:
        return []
    budget = ALS_SYSTEMS_MAX_BYTES

    def per_row(rows: int) -> int:
        n = r * r + r
        if sm_count is not None:
            plan = gramian_plan(rows, k, r, sm_count)
            if plan.n_chunks > 1:
                n += plan.n_chunks * plan.partial
        return 4 * n

    rows = b
    while rows > 1 and rows * per_row(rows) > budget:
        rows = max(1, min(rows - 1, budget // per_row(rows)))
    n = _cdiv(b, rows)
    step = _cdiv(b, n)
    return [(s, min(b, s + step)) for s in range(0, b, step)]


#: the plain version gathers at most this many floats ([rows, K, R]) at once
_PLAIN_GATHER_FLOATS = 1 << 24


def _check_gramian_inputs(y, idx, w2, rhs, ridge, yty) -> None:
    device = y.device if isinstance(y, torch.Tensor) else None
    _check_tensor("y", y, 2, (torch.float32, torch.bfloat16), device)
    _check_tensor("idx", idx, 2, (torch.int32,), device)
    b, k = idx.shape
    r = y.shape[1]
    for name, t in (("w2", w2), ("rhs", rhs)):
        _check_tensor(name, t, 2, (torch.float32,), device)
        if t.shape != idx.shape:
            raise ValueError(f"{name} must be [B, K] = {tuple(idx.shape)}, got {tuple(t.shape)}")
    _check_tensor("ridge", ridge, 1, (torch.float32,), device)
    if ridge.shape[0] != b:
        raise ValueError(f"ridge must be [B] = [{b}], got {tuple(ridge.shape)}")
    if yty is not None:
        _check_tensor("yty", yty, 2, (torch.float32,), device)
        if tuple(yty.shape) != (r, r):
            raise ValueError(f"yty must be [R, R] = [{r}, {r}], got {tuple(yty.shape)}")
    if r < 1 or y.shape[0] < 1:
        raise ValueError(f"the factor table y is empty: {tuple(y.shape)}")


def gramian_fused_reference(
    y: torch.Tensor,  # [N, R] f32 (or bf16, upcast)
    idx: torch.Tensor,  # [B, K] int32
    w2: torch.Tensor,  # [B, K] f32
    rhs: torch.Tensor,  # [B, K] f32
    ridge: torch.Tensor,  # [B] f32
    yty: Optional[torch.Tensor] = None,  # [R, R] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the fused build, on any device:
    gather ``y[idx]`` and contract with einsum, a block of rows at a
    time so the ``[rows, K, R]`` gather stays bounded. Same contract as
    the kernel (``A`` [B, R, R], ``b`` [B, R], f32; a slot with both
    weights 0 contributes nothing, whatever its row holds)."""
    _check_gramian_inputs(y, idx, w2, rhs, ridge, yty)
    y = y.float()
    b, k = idx.shape
    r = y.shape[1]
    a_out = torch.empty((b, r, r), dtype=torch.float32, device=y.device)
    b_out = torch.empty((b, r), dtype=torch.float32, device=y.device)
    step = max(1, _PLAIN_GATHER_FLOATS // max(1, k * r))
    for s in range(0, b, step):
        g = y[idx[s:s + step].long()]  # [rows, K, R]
        # a slot whose weights are both 0 reads no row, as in the kernel
        dead = (w2[s:s + step] == 0) & (rhs[s:s + step] == 0)
        g.masked_fill_(dead[..., None], 0.0)
        a_out[s:s + step] = torch.einsum("bkr,bk,bks->brs", g, w2[s:s + step], g)
        b_out[s:s + step] = torch.einsum("bkr,bk->br", g, rhs[s:s + step])
    a_out += ridge[:, None, None] * torch.eye(r, device=y.device)
    if yty is not None:
        a_out += yty
    return a_out, b_out


def gramian_fused(
    y: torch.Tensor,  # [N, R] f32 or bf16 — opposite-side factor table
    idx: torch.Tensor,  # [B, K] int32 — factor-row index per rating
    w2: torch.Tensor,  # [B, K] f32 — Gramian weight (mask, or c-1 implicit)
    rhs: torch.Tensor,  # [B, K] f32 — rhs weight (masked rating / c·p)
    ridge: torch.Tensor,  # [B] f32 — per-row diagonal ridge (λ·n_u)
    yty: Optional[torch.Tensor] = None,  # [R, R] f32 — implicit-mode base
    plan: Optional[GramianPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused normal-equation build: ``(A [B, R, R], b [B, R])`` with
    ``A_b = yty + ridge_b·I + Σ_k w2[b,k]·y[idx[b,k]]⊗y[idx[b,k]]`` and
    ``b_b = Σ_k rhs[b,k]·y[idx[b,k]]``, without a ``[B, K, R]`` gather in
    device memory.

    The counterpart of ``pallas_kernels.gramian_fused`` (same padding
    contract: a slot with ``w2 = rhs = 0`` contributes nothing), without
    its R % 8 rule or lane padding. A bf16 table is upcast to f32 first,
    as the TPU kernel does. CUDA tensors launch ``csrc/gramian_fused.cu``
    by :func:`gramian_launch_plan` (wide rows are split into chunks whose
    partial systems a second kernel adds in chunk order; one launch is
    counted either way); CPU tensors run :func:`gramian_fused_reference`.
    Any R: up to :data:`GRAMIAN_MAX_RANK` the tuned path, up to
    :data:`GRAMIAN_ROWS_MAX_RANK` the rows path, above it the tile path
    (:func:`gramian_plan` picks by R alone). ``plan`` overrides the pick on
    the card (a :func:`gramian_wide_launch_plan` at any R > 128 launches the
    tile kernel, to compare it with the rows path; the C entry point still
    checks it); CPU tensors ignore it."""
    _check_gramian_inputs(y, idx, w2, rhs, ridge, yty)
    if y.shape[1] > GRAMIAN_WIDE_MAX_RANK:
        raise ValueError(
            f"rank {y.shape[1]} exceeds the gramian_fused kernel's ceiling "
            f"{GRAMIAN_WIDE_MAX_RANK} (R * R must stay an int)"
        )
    device = y.device
    if device.type == "cpu":
        return gramian_fused_reference(y, idx, w2, rhs, ridge, yty)
    if device.type != "cuda":
        raise ValueError(f"gramian_fused runs on cuda or cpu, not {device}")
    y = y.float().contiguous()
    b, k = idx.shape
    n, r = y.shape
    a_out = torch.empty((b, r, r), dtype=torch.float32, device=device)
    b_out = torch.empty((b, r), dtype=torch.float32, device=device)
    if b == 0:
        return a_out, b_out
    if plan is None:
        index = device.index if device.index is not None else torch.cuda.current_device()
        plan = gramian_plan(b, k, r, _sm_count(index))
    if plan.blocks > 2**31 - 1:
        raise ValueError(f"gramian_fused: {plan.blocks} blocks are past the grid")
    # the chunk partials of a split row, from PyTorch's caching allocator
    part = (torch.empty(plan.scratch_shape, dtype=torch.float32, device=device)
            if plan.n_chunks > 1 else None)
    lib = _configured("gramian_fused", _GRAMIAN_ARGTYPES)
    args = (y.data_ptr(), idx.data_ptr(), w2.data_ptr(), rhs.data_ptr(),
            ridge.data_ptr(), None if yty is None else yty.data_ptr(),
            b, k, n, r, plan.chunk, plan.n_chunks, plan.threads)
    outs = (None if part is None else part.data_ptr(), a_out.data_ptr(), b_out.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan.path == "rows":
            code = lib.pio_gramian_rows(*args, plan.chunk_smem, *outs, stream)
        else:
            code = lib.pio_gramian_fused(*args, plan.chunk_smem, GRAMIAN_REDUCE_THREADS,
                                         plan.reduce_smem, *outs, stream)
    gramian_fused.launches += 1
    gramian_fused.launches_by_path[plan.path] += 1
    _raise_on_error(lib, "gramian_fused", code)
    return a_out, b_out


#: kernel launches since the count was last reset (CUDA tensors only), in
#: all and by path (a split launch's reduce counts with its chunk kernel)
gramian_fused.launches = 0
gramian_fused.launches_by_path = dict.fromkeys(("tuned", "rows", "wide"), 0)

_GRAMIAN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 4

#: the kernels ``pio_gramian_fused_attrs`` reports on, in its order: the
#: tuned path's chunk kernels, the tile path's, the rows path's (two steps of
#: rows, then one) and its reduce
GRAMIAN_KERNELS = ("one_pass", "split", "wide_one_pass", "wide_split", "rows_one_pass",
                   "rows_split", "rows_one_pass_s1", "rows_split_s1", "rows_reduce")


def gramian_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the build's kernels (:data:`GRAMIAN_KERNELS`), as
    ``cudaFuncGetAttributes`` reports them on the card."""
    lib = _configured("gramian_fused", _GRAMIAN_ARGTYPES)
    out = (ctypes.c_int * (3 * len(GRAMIAN_KERNELS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "gramian_fused_attrs", lib.pio_gramian_fused_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {name: dict(zip(keys, out[3 * n:3 * n + 3]))
            for n, name in enumerate(GRAMIAN_KERNELS)}


# -- batched SPD solve (csrc/spd_solve.cu) -----------------------------------
#: the widest system of the tuned paths (kMaxN, ``pio_spd_solve``); wider
#: systems take the wide path (``pio_spd_solve_wide``)
SPD_MAX_N = 128
#: the wide path: the most threads a block (kWideThreads, one column each
#: while n <= 256), registers a thread at most (its launch bound of 4 blocks
#: an SM), the widest n (kWideMaxN: n(n+1)/2 stays an int), and the most
#: dynamic shared memory a block may opt into (kMaxSmem)
SPD_WIDE_THREADS, SPD_WIDE_REGS, SPD_WIDE_MAX_N = 256, 64, 46340
SPD_MAX_SMEM = 232448
#: n up to this solves on the registers path (kRegMaxN: each system held in
#: one warp's registers); above it on the shared path, the first version
SPD_REG_MAX_N = 64
#: registers a thread of the registers kernel at each padded width np_, as
#: the card allocates them: ``cudaFuncGetAttributes``' count rounded up to
#: the granule of 8 (chip_smoke holds the card to every entry). The count
#: itself varies between builds of the same source (145 or 149 at np_ =
#: 56, 154 or 158 at 64); what the card allocates, and so the occupancy,
#: does not. With a block's shared memory they set the systems an SM holds.
SPD_REGS = {8: 40, 16: 64, 24: 72, 32: 88, 40: 112, 48: 152, 56: 152, 64: 160}
#: the shared path's systems a block and its default shared memory
#: (kMaxWarps, 48 KB)
_SPD_SHARED_MAX_WARPS, _SPD_DEFAULT_SMEM = 8, 48 * 1024
#: a block's shared memory on the registers path holds np_ rows of U, each
#: 32 · slots + SPD_HIST_PAD floats (kHistPad)
SPD_HIST_PAD = 4
#: the blocked path: the tile width nb (kBlkNb, a panel's columns), threads a
#: block (kBlkThreads) and the registers a thread of its kernel takes, read off
#: the card (chip_smoke holds the card to it; its launch bound allows 64)
SPD_BLOCKED_NB, SPD_BLOCKED_THREADS, SPD_BLOCKED_REGS = 16, 256, 64


def spd_blocked_smem(n: int, nb: int = SPD_BLOCKED_NB) -> int:
    """Dynamic shared memory of a blocked-path block at system size ``n``
    (``blk_smem_bytes`` in the .cu): the t(t+1)/2 tiles of nb × nb floats of
    the upper triangle at t = ceil(n / nb), L's strip rows ``[nb, t·nb]``, y
    ``[t·nb]``, the diagonal tile's L rows ``[nb, nb]``, the panel's inv_d and
    z_j ``[nb]`` each, and the tile table (an int a tile)."""
    t = _cdiv(n, nb)
    tiles = t * (t + 1) // 2
    return 4 * (tiles * nb * nb + nb * t * nb + t * nb + nb * nb + 2 * nb + tiles)


def _spd_blocked_max_n(nb: int) -> int:
    t = 1
    while spd_blocked_smem((t + 1) * nb, nb) <= SPD_MAX_SMEM:
        t += 1
    return t * nb


#: the widest system of the blocked path: the widest n whose block fits in
#: SPD_MAX_SMEM; wider systems take the cluster path
SPD_BLOCKED_MAX_N = _spd_blocked_max_n(SPD_BLOCKED_NB)

#: the cluster path: threads a block (kClThreads) and the cluster sizes it
#: takes, smallest first (kClSizes)
SPD_CLUSTER_THREADS, SPD_CLUSTER_SIZES = 256, (2, 4, 8)
#: registers a thread of the cluster kernel at each cluster size, as the
#: card allocates them (``cudaFuncGetAttributes``' count rounded up to the
#: granule of 8; chip_smoke holds the card to every entry). Its launch bound
#: is one block an SM: at the plan's own sizes a block's shared memory
#: allows no second, and at a bound of two blocks ptxas spilled.
SPD_CLUSTER_REGS = {2: 168, 4: 168, 8: 184}


def spd_cluster_columns(t: int, c: int, rank: int) -> int:
    """Tile columns block ``rank`` of a cluster of ``c`` owns at ``t`` tiles
    a side (``cl_cols`` in the .cu): J = rank, rank + c, ... < t."""
    return (t - 1 - rank) // c + 1 if rank < t else 0


def spd_cluster_tiles(t: int, c: int, rank: int) -> int:
    """Tiles of block ``rank`` (``cl_tiles``): (I, J) for I <= J over its
    columns, J + 1 a column."""
    m = spd_cluster_columns(t, c, rank)
    return m * (rank + 1) + c * m * (m - 1) // 2


def spd_cluster_table(t: int, c: int, rank: int) -> list:
    """Block ``rank``'s tile table: its tiles (I, J) in the order they lie in
    its shared memory, row-major (I ascending, then J)."""
    return [(i, j) for i in range(t) for j in range(rank, t, c) if j >= i]


def spd_cluster_smem(n: int, c: int, nb: int = SPD_BLOCKED_NB) -> int:
    """Dynamic shared memory of each block of a cluster of ``c`` at system
    size ``n`` (``cl_smem_bytes``): the blocked path's terms, with the
    largest block's tiles in place of the whole triangle's (every block lays
    its memory out alike, so a buffer lies at the same offset in each)."""
    t = _cdiv(n, nb)
    tiles = max(spd_cluster_tiles(t, c, r) for r in range(c))
    return 4 * (tiles * nb * nb + nb * t * nb + t * nb + nb * nb + 2 * nb + tiles)


def spd_cluster_size(n: int) -> int:
    """The cluster size at system size ``n``: the smallest of
    :data:`SPD_CLUSTER_SIZES` whose largest block fits in SPD_MAX_SMEM, or
    0 where none does."""
    return next((c for c in SPD_CLUSTER_SIZES if spd_cluster_smem(n, c) <= SPD_MAX_SMEM), 0)


def _spd_cluster_max_n(nb: int) -> int:
    t = 1
    while spd_cluster_size((t + 1) * nb):
        t += 1
    return t * nb


#: the widest system of the cluster path (a cluster of 8 blocks); wider
#: systems take the tiled path
SPD_CLUSTER_MAX_N = _spd_cluster_max_n(SPD_BLOCKED_NB)
#: the solve's paths, in the order of the widths they take; the wide path
#: takes none of its own since the tiled path (only a plan forces it)
SPD_PATHS = ("registers", "shared", "blocked", "cluster", "tiled", "wide")

#: the tiled path: the tile width (kTlNb), threads of its copy and
#: back-substitution blocks (kTlThreads) and of a strip block
#: (kTlStripThreads, a column each), back substitution's sub-panel (kTlSub,
#: one warp's rows), and its kernels in the order of the plan's threads
#: (TlKernel)
SPD_TILED_NB = 64
SPD_TILED_THREADS, SPD_TILED_STRIP_THREADS, SPD_TILED_SUB = 256, 128, 32
SPD_TILED_KERNELS = ("copy", "diag", "strip", "update", "back")
#: device memory one call of the tiled path keeps for its working copy: a
#: call of more systems is cut into calls that stay within it (never below
#: one system), as the top-k cuts a batch (TOPK_MAX_SCRATCH_BYTES)
SPD_TILED_MAX_SCRATCH_BYTES = 2 << 30


def spd_tiled_threads(nb: int = SPD_TILED_NB) -> Tuple[int, ...]:
    """Threads a block of each tiled kernel (:data:`SPD_TILED_KERNELS`) at
    tile width ``nb`` (``tl_threads``): the diagonal tile one warp, the
    trailing update a 4 × 4 register tile a thread, the strip
    :data:`SPD_TILED_STRIP_THREADS`, the others :data:`SPD_TILED_THREADS`."""
    return tuple(32 if k == "diag" else (nb // 4) ** 2 if k == "update"
                 else SPD_TILED_STRIP_THREADS if k == "strip" else SPD_TILED_THREADS
                 for k in SPD_TILED_KERNELS)


def spd_tiled_system_floats(n: int, nb: int) -> int:
    """Floats of one system's working copy on the tiled path
    (``tl_system_floats``): the t(t+1)/2 tiles of nb × nb at t =
    ceil(n / nb), y ``[t·nb]``, L's rows of a panel ``[nb, t·nb]``, the
    panel's diagonal L rows ``[nb, nb]``, its inv_d and z_j ``[nb]`` each."""
    t = _cdiv(n, nb)
    return t * (t + 1) // 2 * nb * nb + t * nb * (1 + nb) + nb * nb + 2 * nb


def spd_tiled_schedule(t: int, nb: int) -> list:
    """The launches of one tiled call at ``t`` tiles a side (``tl_for_each_launch``),
    in order, as (kernel, panel, blocks a system): the copy (a block a
    tile); for each panel p its diagonal tile (one warp), then, but for the
    last panel, its strip (a block of :data:`SPD_TILED_STRIP_THREADS`
    columns right of the panel) and its trailing update (a block a tile right of
    and below it); back substitution (a block). 3t launches."""
    np_ = t * nb
    out = [("copy", -1, t * (t + 1) // 2)]
    for p in range(t):
        out.append(("diag", p, 1))
        if p + 1 < t:
            m = t - p - 1
            out.append(("strip", p, _cdiv(np_ - (p + 1) * nb, SPD_TILED_STRIP_THREADS)))
            out.append(("update", p, m * (m + 1) // 2))
    out.append(("back", -1, 1))
    return out


def spd_tiled_systems(n: int) -> int:
    """Systems one tiled call takes at most: as many working copies as fit
    in :data:`SPD_TILED_MAX_SCRATCH_BYTES`, never fewer than one."""
    return max(1, SPD_TILED_MAX_SCRATCH_BYTES // (4 * spd_tiled_system_floats(n, SPD_TILED_NB)))


def spd_tiled_slices(b: int, n: int) -> list:
    """The ``[start, stop)`` ranges of systems a tiled solve of ``b`` is
    cut into, one call each: consecutive, covering every system once, at
    most :func:`spd_tiled_systems` each. Systems are independent, so the
    cut changes no bit."""
    rows = spd_tiled_systems(n)
    return [(s, min(s + rows, b)) for s in range(0, b, rows)]


class SpdPlan(NamedTuple):
    """What one launch of ``csrc/spd_solve.cu`` needs beyond its tensors
    (see :func:`spd_launch_plan`)."""

    path: str  #: "registers" (n <= 64), "shared" (n <= 128), "blocked",
    #: "cluster", "tiled" or "wide"
    np_: int  #: the padded width, a multiple of 8 and at least n (blocked,
    #: cluster: of nb; wide: n)
    slots: int  #: column slots a lane holds, ceil(np_ / 32) (blocked, wide:
    #: columns a thread)
    warps: int  #: systems (one warp each) a block holds; 1 on the registers
    #: path; on the blocked, cluster and wide paths the warps of a block
    blocks: int  #: ceil(B / warps) (blocked, wide: B; cluster: B · cluster)
    smem: int  #: dynamic shared memory of a block, bytes
    blocks_per_sm: int  #: blocks an SM holds at once
    waves: int  #: ceil(blocks / (SMs · blocks_per_sm)); cluster path: ceil(B
    #: / (SMs · blocks_per_sm // cluster)), a lower estimate: it ignores how
    #: the card packs clusters into GPCs, so the card may hold fewer clusters
    #: at once (``cudaOccupancyMaxActiveClusters``, :func:`spd_cluster_occupancy`)
    #: and run more waves. Nothing launches from it.
    scratch: int = 0  #: floats a system in device memory (wide path, large
    #: n; tiled path: the working copy)
    nb: int = 0  #: the tile width (blocked, cluster, tiled)
    tiles: int = 0  #: tiles of the upper triangle, t(t+1)/2 (blocked, tiled
    #: path); the largest block's tiles (cluster path)
    cluster: int = 0  #: blocks a system (cluster path)
    panels: int = 0  #: panels, t (tiled path)
    threads: Tuple[int, ...] = ()  #: threads a block of each kernel, in
    #: :data:`SPD_TILED_KERNELS`' order (tiled path)
    launch_blocks: Tuple[int, ...] = ()  #: blocks a system of each launch of
    #: a call, in :func:`spd_tiled_schedule`'s order (tiled path)
    systems: int = 0  #: systems a call takes at most (tiled path:
    #: :func:`spd_tiled_systems`; a solve of more is cut into calls)


def _spd_blocks_per_sm(warps: int, smem: int, regs: Optional[int]) -> int:
    fits = [_SM_SMEM // (smem + _BLOCK_SMEM_RESERVE), _SM_MAX_BLOCKS,
            _SM_MAX_THREADS // (32 * warps)]
    if regs is not None:
        fits.append(_SM_REGS // (warps * 32 * _cdiv(regs, 8) * 8))
    return min(fits)


@functools.lru_cache(maxsize=256)
def spd_launch_plan(b: int, n: int, sm_count: int) -> SpdPlan:
    """The launch plan of the batched SPD solve for ``b`` systems of size
    ``n`` on a card of ``sm_count`` SMs. Pure arithmetic (the C entry
    point checks it and refuses a plan that does not match its own).

    The path follows from n alone: n <= :data:`SPD_REG_MAX_N` takes the
    registers path (one system a block of one warp, padded to ``np_``; the
    blocks an SM holds follow from :data:`SPD_REGS` and the block's shared
    memory), n <= :data:`SPD_MAX_N` the shared path (warps a block from 48
    KB of shared memory), n <= :data:`SPD_BLOCKED_MAX_N` the blocked path
    (:func:`spd_blocked_launch_plan`), n <= :data:`SPD_CLUSTER_MAX_N` the
    cluster path (:func:`spd_cluster_launch_plan`) and wider n the tiled
    path (:func:`spd_tiled_launch_plan`). No n takes the wide path, which
    :func:`spd_wide_launch_plan` still forces."""
    if min(b, n, sm_count) < 1 or n > SPD_WIDE_MAX_N:
        raise ValueError(f"no spd launch plan for b={b}, n={n}, sm_count={sm_count}")
    if n > SPD_CLUSTER_MAX_N:
        return spd_tiled_launch_plan(b, n, sm_count)
    if n > SPD_BLOCKED_MAX_N:
        return spd_cluster_launch_plan(b, n, sm_count)
    if n > SPD_MAX_N:
        return spd_blocked_launch_plan(b, n, sm_count)
    np_ = _cdiv(n, 8) * 8
    if n > SPD_REG_MAX_N:
        path, regs = "shared", None
        per_warp = 4 * (n * n + 2 * n)
        warps = min(_SPD_SHARED_MAX_WARPS, max(1, _SPD_DEFAULT_SMEM // per_warp))
    else:
        path, regs, warps = "registers", SPD_REGS[np_], 1
        per_warp = 4 * np_ * (32 * _cdiv(np_, 32) + SPD_HIST_PAD)
    blocks, smem = _cdiv(b, warps), per_warp * warps
    per_sm = _spd_blocks_per_sm(warps, smem, regs)
    return SpdPlan(path=path, np_=np_, slots=_cdiv(np_, 32), warps=warps,
                   blocks=blocks, smem=smem, blocks_per_sm=per_sm,
                   waves=_cdiv(blocks, sm_count * per_sm))


@functools.lru_cache(maxsize=256)
def spd_blocked_launch_plan(b: int, n: int, sm_count: int) -> SpdPlan:
    """The blocked path's plan (``SPD_MAX_N < n <= SPD_BLOCKED_MAX_N``): one
    block of :data:`SPD_BLOCKED_THREADS` a system, its upper triangle in
    shared memory as tiles of :data:`SPD_BLOCKED_NB` (padded to ``np_`` =
    t·nb with identity columns), a panel of nb columns a step. The blocks
    an SM holds follow from the shared memory, :data:`SPD_BLOCKED_REGS` and
    the threads. Pure arithmetic, checked again by the C entry point."""
    if min(b, sm_count) < 1 or not SPD_MAX_N < n <= SPD_BLOCKED_MAX_N:
        raise ValueError(f"no spd blocked plan for b={b}, n={n}, sm_count={sm_count}")
    nb, threads = SPD_BLOCKED_NB, SPD_BLOCKED_THREADS
    t = _cdiv(n, nb)
    smem = spd_blocked_smem(n, nb)
    per_sm = _spd_blocks_per_sm(threads // 32, smem, SPD_BLOCKED_REGS)
    return SpdPlan(path="blocked", np_=t * nb, slots=_cdiv(t * nb, threads),
                   warps=threads // 32, blocks=b, smem=smem, blocks_per_sm=per_sm,
                   waves=_cdiv(b, sm_count * per_sm), nb=nb, tiles=t * (t + 1) // 2)


@functools.lru_cache(maxsize=256)
def spd_cluster_launch_plan(b: int, n: int, sm_count: int) -> SpdPlan:
    """The cluster path's plan (``SPD_BLOCKED_MAX_N < n <=
    SPD_CLUSTER_MAX_N``): one system a cluster of :func:`spd_cluster_size`
    blocks of :data:`SPD_CLUSTER_THREADS` (the smallest cluster whose
    largest block fits), tile column J of the blocked path's tiles in block
    J mod cluster. The blocks an SM holds follow from the shared memory,
    :data:`SPD_CLUSTER_REGS` and the threads. Pure arithmetic, checked again
    by the C entry point."""
    if min(b, sm_count) < 1 or not SPD_BLOCKED_MAX_N < n <= SPD_CLUSTER_MAX_N:
        raise ValueError(f"no spd cluster plan for b={b}, n={n}, sm_count={sm_count}")
    nb, threads, c = SPD_BLOCKED_NB, SPD_CLUSTER_THREADS, spd_cluster_size(n)
    t = _cdiv(n, nb)
    smem = spd_cluster_smem(n, c, nb)
    per_sm = _spd_blocks_per_sm(threads // 32, smem, SPD_CLUSTER_REGS[c])
    clusters = max(1, sm_count * per_sm // c)
    return SpdPlan(path="cluster", np_=t * nb, slots=_cdiv(t * nb, threads),
                   warps=threads // 32, blocks=b * c, smem=smem, blocks_per_sm=per_sm,
                   waves=_cdiv(b, clusters), nb=nb,
                   tiles=max(spd_cluster_tiles(t, c, r) for r in range(c)), cluster=c)


#: registers a thread of each tiled kernel, as the card allocates them
#: (``cudaFuncGetAttributes``' count rounded up to the granule of 8;
#: chip_smoke holds the card to every entry); with the threads and the
#: static shared memory they set the blocks an SM holds
SPD_TILED_REGS = {"copy": 32, "diag": 168, "strip": 144, "update": 56, "back": 72}


@functools.lru_cache(maxsize=256)
def spd_tiled_launch_plan(b: int, n: int, sm_count: int) -> SpdPlan:
    """The tiled path's plan (n > :data:`SPD_CLUSTER_MAX_N`; any n >
    :data:`SPD_MAX_N` to compare it with the blocked and cluster paths):
    the upper triangle copied into a working copy in device memory as nb ×
    nb tiles (nb = :data:`SPD_TILED_NB`, padded to ``np_`` = t·nb with
    identity columns), each panel of nb columns three launches (its
    diagonal tile, its strip, its trailing update: one block a tile), then
    back substitution (:func:`spd_tiled_schedule`). ``blocks`` counts every
    launch's blocks for the whole call of ``b``; ``blocks_per_sm`` and
    ``waves`` are the first trailing update's, the largest launch. A call
    takes at most ``systems`` systems (the working copies' budget); the
    wrapper cuts a larger one. Pure arithmetic, checked again by the C
    entry point."""
    nb = SPD_TILED_NB
    if min(b, sm_count) < 1 or not SPD_MAX_N < n <= SPD_WIDE_MAX_N:
        raise ValueError(f"no spd tiled plan for b={b}, n={n}, sm_count={sm_count}")
    t = _cdiv(n, nb)
    threads = spd_tiled_threads(nb)
    launch_blocks = tuple(blocks for _, _, blocks in spd_tiled_schedule(t, nb))
    update = threads[SPD_TILED_KERNELS.index("update")]
    per_sm = _spd_blocks_per_sm(update // 32, 8 * nb * nb, SPD_TILED_REGS["update"])
    first = (t - 1) * t // 2  # tiles of the first trailing update
    return SpdPlan(path="tiled", np_=t * nb, slots=_cdiv(t * nb, SPD_TILED_THREADS),
                   warps=update // 32, blocks=b * sum(launch_blocks), smem=0,
                   blocks_per_sm=per_sm, waves=_cdiv(b * max(first, 1), sm_count * per_sm),
                   scratch=spd_tiled_system_floats(n, nb), nb=nb, tiles=t * (t + 1) // 2,
                   panels=t, threads=threads, launch_blocks=launch_blocks,
                   systems=min(b, spd_tiled_systems(n)))


@functools.lru_cache(maxsize=256)
def spd_wide_launch_plan(b: int, n: int, sm_count: int) -> SpdPlan:
    """The wide path's plan, the first version (no n takes it since the
    tiled path; any n > :data:`SPD_MAX_N` to compare it with the blocked,
    cluster and tiled paths): one block a system, its packed upper triangle in
    shared memory while it fits (beside y and L's column), else in a ``[B,
    n(n+1)/2]`` scratch. Pure arithmetic, checked again by the C entry
    point."""
    if min(b, sm_count) < 1 or not SPD_MAX_N < n <= SPD_WIDE_MAX_N:
        raise ValueError(f"no spd wide plan for b={b}, n={n}, sm_count={sm_count}")
    threads = min(SPD_WIDE_THREADS, _cdiv(n, 32) * 32)
    tri = n * (n + 1) // 2
    fits = 4 * (tri + 2 * n) <= SPD_MAX_SMEM
    smem = 4 * (tri + 2 * n) if fits else 8 * n
    per_sm = min(_SM_SMEM // (smem + _BLOCK_SMEM_RESERVE), _SM_MAX_BLOCKS,
                 _SM_MAX_THREADS // threads, _SM_REGS // (threads * SPD_WIDE_REGS))
    return SpdPlan(path="wide", np_=n, slots=_cdiv(n, threads), warps=threads // 32,
                   blocks=b, smem=smem, blocks_per_sm=per_sm,
                   waves=_cdiv(b, sm_count * per_sm), scratch=0 if fits else tri)


def _check_spd_inputs(a, b) -> None:
    device = a.device if isinstance(a, torch.Tensor) else None
    _check_tensor("a", a, 3, (torch.float32,), device)
    _check_tensor("b", b, 2, (torch.float32,), device)
    bsz, n, n2 = a.shape
    if n != n2 or tuple(b.shape) != (bsz, n):
        raise ValueError(
            f"spd_solve needs a [B, n, n] and b [B, n], got {tuple(a.shape)} "
            f"and {tuple(b.shape)}"
        )
    if n < 1:
        raise ValueError("spd_solve needs n >= 1")


def spd_solve_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the batched SPD solve, on any device:
    the TPU kernel's right-looking Cholesky loop over batched tensor ops
    (the whole block updated each step, as ``_spd_kernel`` does), with
    forward substitution interleaved and the same zero-pivot guard, then
    back substitution. Not ``torch.linalg.cholesky``, which fails on the
    all-zero padding systems that must solve to exactly 0."""
    _check_spd_inputs(a, b)
    a = a.clone()
    y = b.clone()
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j in range(n):
        colj = a[:, j, :].clone()  # row j = column j of the trailing block
        d2 = colj[:, j]
        inv_d = torch.where(d2 > 0, torch.rsqrt(d2), zero)
        lj = colj * inv_d[:, None]
        ljm = lj - eye[j]
        a -= ljm[:, :, None] * lj[:, None, :]
        y -= ljm * (y[:, j] * inv_d)[:, None]
    x = torch.zeros_like(y)
    for j in range(n - 1, -1, -1):
        lrow = a[:, j, :]
        d = lrow[:, j]
        inv = torch.where(d > 0, 1.0 / d, zero)
        dot = (lrow * x).sum(dim=1)  # x[:, j] is still 0 here
        x[:, j] = (y[:, j] - dot) * inv
    return x


def spd_solve(a: torch.Tensor, b: torch.Tensor, plan: Optional[SpdPlan] = None) -> torch.Tensor:
    """Batched SPD solve ``a[s] x[s] = b[s]`` for ``a [B, n, n]``,
    ``b [B, n]`` (f32, batch-major: the layout :func:`gramian_fused`
    writes). An all-zero system solves to exactly 0; a zero pivot gives a
    zero component. Only the upper triangle of each system is read. Any B
    and any n. CUDA tensors launch ``csrc/spd_solve.cu`` by
    :func:`spd_launch_plan` (n <= 64 with each system in one warp's
    registers, n <= 128 through shared memory, n <= SPD_BLOCKED_MAX_N on
    the blocked path, n <= SPD_CLUSTER_MAX_N on a cluster of blocks, wider
    n on the tiled path; one launch is counted a call of a C entry, in all
    and by path: the tiled path makes one call for each
    :func:`spd_tiled_slices` range); ``plan`` overrides it (a
    :func:`spd_wide_launch_plan` at any n > 128 launches the wide kernel,
    a :func:`spd_tiled_launch_plan` the tiled path, to compare them with
    the other paths; the C entry point still checks it). A cluster launch
    the card refuses raises. CPU tensors run :func:`spd_solve_reference`."""
    _check_spd_inputs(a, b)
    if a.shape[-1] > SPD_WIDE_MAX_N:
        raise ValueError(
            f"system size {a.shape[-1]} exceeds the spd_solve kernel's "
            f"ceiling {SPD_WIDE_MAX_N} (n(n+1)/2 must stay an int)"
        )
    device = a.device
    if device.type == "cpu":
        return spd_solve_reference(a, b)
    if device.type != "cuda":
        raise ValueError(f"spd_solve runs on cuda or cpu, not {device}")
    bsz, n, _ = a.shape
    x = torch.empty((bsz, n), dtype=torch.float32, device=device)
    if bsz == 0:
        return x
    if plan is None:
        index = device.index if device.index is not None else torch.cuda.current_device()
        plan = spd_launch_plan(bsz, n, _sm_count(index))
    lib = _configured("spd_solve", _SPD_ARGTYPES)
    if plan.path == "tiled":
        _spd_solve_tiled(lib, a, b, x, plan)
        return x
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan.path == "wide":
            scratch = (torch.empty((bsz, plan.scratch), dtype=torch.float32, device=device)
                       if plan.scratch else None)
            code = lib.pio_spd_solve_wide(
                a.data_ptr(), b.data_ptr(), x.data_ptr(),
                None if scratch is None else scratch.data_ptr(), bsz, n,
                32 * plan.warps, plan.blocks, plan.smem, stream,
            )
        elif plan.path == "blocked":
            code = lib.pio_spd_solve_blocked(
                a.data_ptr(), b.data_ptr(), x.data_ptr(), bsz, n, plan.nb,
                32 * plan.warps, plan.tiles, plan.blocks, plan.smem, stream,
            )
        elif plan.path == "cluster":
            code = lib.pio_spd_solve_cluster(
                a.data_ptr(), b.data_ptr(), x.data_ptr(), bsz, n, plan.nb,
                32 * plan.warps, plan.cluster, plan.tiles, plan.blocks, plan.smem, stream,
            )
        else:
            code = lib.pio_spd_solve(
                a.data_ptr(), b.data_ptr(), x.data_ptr(), bsz, n,
                0 if plan.path == "registers" else 1, plan.np_, plan.warps,
                plan.blocks, plan.smem, stream,
            )
    spd_solve.launches += 1
    spd_solve.launches_by_path[plan.path] += 1
    _raise_on_error(lib, "spd_solve", code)
    return x


def _spd_solve_tiled(lib, a, b, x, plan: SpdPlan) -> None:
    """The tiled path: one call of ``pio_spd_solve_tiled`` (3t launches on
    the current stream) for each range of at most ``plan.systems`` systems,
    one working copy reused by every call, each call counted."""
    bsz, n, _ = a.shape
    work = torch.empty((min(bsz, plan.systems), plan.scratch), dtype=torch.float32,
                       device=a.device)
    threads = (ctypes.c_int * len(plan.threads))(*plan.threads)
    blocks = (ctypes.c_int * len(plan.launch_blocks))(*plan.launch_blocks)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for s0 in range(0, bsz, plan.systems):
            s1 = min(bsz, s0 + plan.systems)
            code = lib.pio_spd_solve_tiled(
                a[s0:s1].data_ptr(), b[s0:s1].data_ptr(), x[s0:s1].data_ptr(), work.data_ptr(),
                s1 - s0, n, plan.nb, plan.tiles, plan.panels, plan.scratch, threads,
                len(plan.threads), blocks, len(plan.launch_blocks), stream,
            )
            spd_solve.launches += 1
            spd_solve.launches_by_path["tiled"] += 1
            _raise_on_error(lib, "spd_solve", code)


#: kernel launches since the count was last reset (CUDA tensors only), in
#: all and by the plan's path
spd_solve.launches = 0
spd_solve.launches_by_path = dict.fromkeys(SPD_PATHS, 0)

_SPD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
#: the kernels ``pio_spd_solve_attrs`` reports on, in its order
SPD_KERNELS = (*(f"registers_np{w}" for w in SPD_REGS), "shared", "blocked", "wide")
#: the cluster kernels ``pio_spd_solve_cluster_attrs`` reports on, in its
#: order: one a cluster size
SPD_CLUSTER_KERNELS = tuple(f"cluster_c{c}" for c in SPD_CLUSTER_SIZES)


def spd_tiled_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of each tiled kernel (:data:`SPD_TILED_KERNELS`), as
    ``cudaFuncGetAttributes`` reports them on the card."""
    lib = _configured("spd_solve", _SPD_ARGTYPES)
    out = (ctypes.c_int * (3 * len(SPD_TILED_KERNELS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "spd_solve_tiled_attrs", lib.pio_spd_solve_tiled_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {name: dict(zip(keys, out[3 * k:3 * k + 3]))
            for k, name in enumerate(SPD_TILED_KERNELS)}


def spd_cluster_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the cluster kernel at each cluster size
    (:data:`SPD_CLUSTER_KERNELS`), as ``cudaFuncGetAttributes`` reports
    them on the card."""
    lib = _configured("spd_solve", _SPD_ARGTYPES)
    out = (ctypes.c_int * (3 * len(SPD_CLUSTER_KERNELS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "spd_solve_cluster_attrs", lib.pio_spd_solve_cluster_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {name: dict(zip(keys, out[3 * k:3 * k + 3]))
            for k, name in enumerate(SPD_CLUSTER_KERNELS)}


def spd_cluster_occupancy(plan: SpdPlan, device=None) -> int:
    """Clusters of ``plan``'s size and shared memory the card holds at once,
    as ``cudaOccupancyMaxActiveClusters`` says (the plan's own estimate:
    SMs · ``blocks_per_sm`` // ``cluster``)."""
    lib = _configured("spd_solve", _SPD_ARGTYPES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "spd_solve_cluster_occupancy", lib.pio_spd_solve_cluster_occupancy(
            plan.cluster, plan.smem, ctypes.byref(out)))
    return out.value


def spd_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of every solve kernel (:data:`SPD_KERNELS`), as
    ``cudaFuncGetAttributes`` reports them on the card."""
    lib = _configured("spd_solve", _SPD_ARGTYPES)
    out = (ctypes.c_int * (3 * len(SPD_KERNELS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "spd_solve_attrs", lib.pio_spd_solve_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {name: dict(zip(keys, out[3 * k:3 * k + 3]))
            for k, name in enumerate(SPD_KERNELS)}


def spd_solve_t(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``spd_solve`` in the JAX package's transposed layout (``a_t
    [n, n, B]``, ``b_t [n, B]`` → ``x_t [n, B]``), the counterpart of
    ``pallas_kernels.spd_solve_t`` without its n % 8 and B % 128 rules."""
    if not isinstance(a_t, torch.Tensor) or a_t.dim() != 3:
        raise ValueError("spd_solve_t needs a_t [n, n, B]")
    if not isinstance(b_t, torch.Tensor) or b_t.dim() != 2:
        raise ValueError("spd_solve_t needs b_t [n, B]")
    x = spd_solve(a_t.permute(2, 0, 1).contiguous(), b_t.T.contiguous())
    return x.T.contiguous()


# -- flash attention forward (csrc/flash_attention.cu) ------------------------
#: keys per K/V tile of the kernel (kTile, the plan's ``bk``) and the smaller
#: of its two query tiles; the plain version walks the keys in tiles of the
#: same width
FLASH_TILE = 64
#: the query rows a block may take (the plan's ``bq``): one instantiation each
FLASH_BQS = (64, 128)
#: the widest head D of the tuned path (kMaxD). It is built at the multiples
#: of FLASH_D_MULTIPLE; the wrapper takes any D from 1 to FLASH_MAX_D there
#: and zero-pads q, k and v up to the next multiple. Wider heads take the
#: resident path up to FLASH_WIDE_RES_MAX_D, the streamed path up to
#: FLASH_STREAMED_MAX_D, the wide streamed path up to
#: FLASH_WIDE_STREAMED_MAX_D, the cluster path up to FLASH_CLUSTER_MAX_D and
#: the passes path above it, unpadded.
FLASH_MAX_D = 128
FLASH_D_MULTIPLE = 8
#: query tiles of one (batch · head) (kMaxQTiles); the grid is one-dimensional
FLASH_MAX_Q_TILES = 65535
#: the finite mask value of the TPU kernel (keeps fully masked rows NaN-free)
FLASH_NEG_BIG = -1e30
#: a thread's micro-tile: query rows (kRows) × keys of S (kTile / kKeyThreads);
#: its O tile is the same rows × D / FLASH_KEY_THREADS columns
FLASH_ROWS, FLASH_KEY_THREADS = 4, 8
#: floats after each Q and K row in shared memory (kPad), and the floats of a
#: probability row (kPStride)
FLASH_PAD, FLASH_P_STRIDE = 4, FLASH_TILE + 8
#: the most dynamic shared memory a block may opt into on the card
FLASH_MAX_SMEM = 232448
#: the passes path (heads wider than FLASH_CLUSTER_MAX_D): query rows and
#: keys a tile (kWRows, kWKeys), threads a block (kWThreads), O's columns a
#: pass (kWCols), registers a thread (its launch bound of 4 blocks an SM caps
#: it there, and the card reports that many), and its static shared memory (Q
#: and K chunks [32][65], V [32][128], P [32][33])
FLASH_WIDE_ROWS = FLASH_WIDE_KEYS = 32
FLASH_WIDE_THREADS, FLASH_WIDE_COLS, FLASH_WIDE_REGS = 256, 128, 64
FLASH_WIDE_SMEM = 4 * (2 * 32 * 65 + 32 * FLASH_WIDE_COLS + 32 * 33)
#: the resident path (FLASH_MAX_D < D <= FLASH_WIDE_RES_MAX_D): query rows and
#: keys a tile (kRRows, kRKeys), threads a block (kRThreads), the floats of a
#: probability row (kRPStride), and the widest head whose resident tiles fit
#: a block's shared memory (kRMaxD)
FLASH_WIDE_RES_ROWS = FLASH_WIDE_RES_KEYS = 64
FLASH_WIDE_RES_THREADS, FLASH_WIDE_RES_P_STRIDE, FLASH_WIDE_RES_MAX_D = 256, 68, 272
#: the resident path's instantiations, by G = ceil(ceil(D / 4) / 16), the
#: float4 column groups of O a thread owns, and the registers a thread of each
#: takes on the card (chip_smoke.py holds the card's count to these)
FLASH_WIDE_RES_REGS = {3: 168, 4: 234, 5: 254}
#: the streamed path (FLASH_WIDE_RES_MAX_D < D <= FLASH_STREAMED_MAX_D): the
#: resident path's block (query rows and keys a tile, kSRows and kSKeys;
#: threads, kSThreads) with K and V streamed through shared memory in column
#: chunks of FLASH_STREAMED_CHUNK (kSChunk) at a row stride of
#: FLASH_STREAMED_C_STRIDE floats (kSCStride), in FLASH_STREAMED_STAGES
#: buffers (kSStages); one instantiation, FLASH_STREAMED_GROUPS float4 column
#: groups of O a thread (kSGroups), which sets its widest head (kSMaxD), and
#: the registers a thread takes on the card (chip_smoke.py holds the card's
#: count to it)
FLASH_STREAMED_ROWS = FLASH_STREAMED_KEYS = 64
FLASH_STREAMED_THREADS, FLASH_STREAMED_CHUNK, FLASH_STREAMED_C_STRIDE = 256, 64, 68
FLASH_STREAMED_STAGES = 2
FLASH_STREAMED_GROUPS, FLASH_STREAMED_MAX_D = 5, 320
FLASH_STREAMED_REGS = 216
#: the wide streamed path (FLASH_STREAMED_MAX_D < D <=
#: FLASH_WIDE_STREAMED_MAX_D): the streamed path's block (query rows and keys
#: a tile, kWSRows and kWSKeys) at 512 threads (kWSThreads), two query rows a
#: thread in S and in O, with K streamed in column chunks of
#: FLASH_WIDE_STREAMED_K_CHUNK (kWSKChunk) and V in chunks of
#: FLASH_WIDE_STREAMED_V_CHUNK (kWSVChunk), each row 4 floats longer, in
#: FLASH_WIDE_STREAMED_STAGES buffers (kWSStages); one instantiation,
#: FLASH_WIDE_STREAMED_GROUPS float4 column groups of O a thread (kWSGroups),
#: which sets its widest head (kWSMaxD), and the registers a thread takes on
#: the card (chip_smoke.py holds the card's count to it)
FLASH_WIDE_STREAMED_ROWS = FLASH_WIDE_STREAMED_KEYS = 64
FLASH_WIDE_STREAMED_THREADS = 512
FLASH_WIDE_STREAMED_K_CHUNK, FLASH_WIDE_STREAMED_V_CHUNK = 64, 128
FLASH_WIDE_STREAMED_STAGES = 2
FLASH_WIDE_STREAMED_GROUPS, FLASH_WIDE_STREAMED_MAX_D = 8, 512
FLASH_WIDE_STREAMED_REGS = 128
#: the cluster path (FLASH_WIDE_STREAMED_MAX_D < D <= FLASH_CLUSTER_MAX_D): a
#: cluster of FLASH_CLUSTER_BLOCKS blocks (kCBlocks) a query tile, each the
#: wide streamed path's block (its rows, keys, threads, chunks and stages) on
#: a slice of D's columns (:func:`flash_cluster_slices`), with
#: FLASH_CLUSTER_GROUPS float4 column groups of O a thread (kCGroups), which
#: sets its widest head (kCMaxD), and the registers a thread takes on the
#: card (chip_smoke.py holds the card's count to it)
FLASH_CLUSTER_BLOCKS, FLASH_CLUSTER_GROUPS, FLASH_CLUSTER_MAX_D = 2, 8, 1024
FLASH_CLUSTER_THREADS = FLASH_WIDE_STREAMED_THREADS
FLASH_CLUSTER_REGS = 128
#: every instantiation, in the order ``pio_flash_attention_attrs`` reports them
FLASH_KERNELS = tuple((d, bq) for d in range(FLASH_D_MULTIPLE, FLASH_MAX_D + 1,
                                             FLASH_D_MULTIPLE) for bq in FLASH_BQS)


#: the kernel paths a plan names (``FlashPlan.path``), by head width
FLASH_PATHS = ("tuned", "resident", "streamed", "wide_streamed", "cluster", "passes")


class FlashPlan(NamedTuple):
    """What one launch of ``csrc/flash_attention.cu`` needs beyond its
    tensors (see :func:`flash_launch_plan`)."""

    bq: int  #: query rows a block, 64 or 128
    bk: int  #: keys a tile, FLASH_TILE
    threads: int  #: threads a block, 2 · bq
    s_tile: Tuple[int, int]  #: a thread's micro-tile of S, rows × keys
    o_tile: Tuple[int, int]  #: a thread's micro-tile of O, rows × columns
    smem: int  #: dynamic shared memory of a block, bytes
    regs: int  #: registers a thread of the (D, bq) instantiation, from the card
    blocks_per_sm: int  #: blocks an SM holds at once
    q_tiles: int  #: query tiles of one (batch · head), ceil(Lq / bq)
    kv_tiles: int  #: key tiles, ceil(Lk / bk)
    blocks: int  #: the grid, BH · q_tiles (· passes), heaviest query tiles first
    waves: int  #: ceil(blocks / (SMs · blocks_per_sm))
    passes: int = 1  #: blocks a query tile, each taking FLASH_WIDE_COLS of O (passes path)
    path: str = "tuned"  #: the kernel: "tuned" (D <= 128), "resident", "streamed",
    #: "wide_streamed", "cluster" or "passes"
    cluster: int = 1  #: blocks a cluster (the cluster path's FLASH_CLUSTER_BLOCKS)
    slices: Tuple[int, ...] = ()  #: each block's columns of D (cluster path)


def flash_smem_bytes(bq: int, d: int) -> int:
    """Dynamic shared memory of a block (``smem_floats`` in the .cu): the
    Q tile and two K tiles at a row stride of D + FLASH_PAD floats, two V
    tiles, and the probabilities [bq, FLASH_P_STRIDE]."""
    return 4 * ((bq + 2 * FLASH_TILE) * (d + FLASH_PAD) + 2 * FLASH_TILE * d
                + bq * FLASH_P_STRIDE)


@functools.lru_cache(maxsize=256)
def flash_launch_plan(b: int, h: int, lq: int, lk: int, d: int, causal: bool,
                      sm_count: int, regs: Tuple[int, int],
                      bq: Optional[int] = None) -> FlashPlan:
    """The launch plan of the flash-attention forward for q ``[b, h, lq,
    d]`` and k, v ``[b, h, lk, d]`` on a card of ``sm_count`` SMs, where
    ``regs`` are the registers a thread of the (d, 64) and (d, 128)
    instantiations take (:func:`flash_kernel_attributes`, read off the
    card). Pure arithmetic (the C entry point checks it and refuses a plan
    that does not match its own).

    A block takes 128 query rows when Lq is longer than one 64-row tile,
    the 128-row grid still fills every block slot of the card once, and
    an SM holds more threads of 128-row blocks than of 64-row ones (wide
    heads, where shared memory sets the blocks an SM) or as many without
    causal masking; else 64. At the same threads an SM, 128 rows were
    faster on the card without the mask (each K/V tile in shared memory
    serves twice the rows) and 64 with it (the heavy-first order has
    finer blocks to balance). The blocks an SM holds follow from the
    registers, the shared memory and the threads of a block. ``bq``
    forces the query tile (to check or time the other one)."""
    if (min(b, h, lq, lk, d, sm_count) < 1 or d > FLASH_MAX_D
            or d % FLASH_D_MULTIPLE or len(regs) != len(FLASH_BQS)
            or bq not in (None, *FLASH_BQS)
            or (bq is not None and flash_smem_bytes(bq, d) > FLASH_MAX_SMEM)):
        raise ValueError(
            f"no flash launch plan for b={b}, h={h}, lq={lq}, lk={lk}, d={d}, "
            f"sm_count={sm_count}, regs={regs}"
        )
    bh, n_kv = b * h, _cdiv(lk, FLASH_TILE)

    def per_sm(bq: int, r: int) -> int:
        threads = 2 * bq
        return min(_SM_REGS // (threads * (_cdiv(r, 8) * 8)),
                   _SM_SMEM // (flash_smem_bytes(bq, d) + _BLOCK_SMEM_RESERVE),
                   _SM_MAX_BLOCKS, _SM_MAX_THREADS // threads)

    narrow, wide = FLASH_BQS
    if bq is None:
        bq = narrow
        if lq > narrow and flash_smem_bytes(wide, d) <= FLASH_MAX_SMEM:
            threads = (wide * per_sm(wide, regs[1]), narrow * per_sm(narrow, regs[0]))
            if ((threads[0] > threads[1] or (threads[0] == threads[1] and not causal))
                    and bh * _cdiv(lq, wide) >= sm_count * per_sm(wide, regs[1])):
                bq = wide
    r = regs[FLASH_BQS.index(bq)]
    blocks_per_sm = per_sm(bq, r)
    q_tiles = _cdiv(lq, bq)
    blocks = bh * q_tiles
    return FlashPlan(
        bq=bq, bk=FLASH_TILE, threads=2 * bq,
        s_tile=(FLASH_ROWS, FLASH_TILE // FLASH_KEY_THREADS),
        o_tile=(FLASH_ROWS, d // FLASH_KEY_THREADS),
        smem=flash_smem_bytes(bq, d), regs=r, blocks_per_sm=blocks_per_sm,
        q_tiles=q_tiles, kv_tiles=n_kv, blocks=blocks,
        waves=_cdiv(blocks, sm_count * blocks_per_sm),
    )


@functools.lru_cache(maxsize=256)
def flash_wide_launch_plan(b: int, h: int, lq: int, lk: int, d: int,
                           sm_count: int) -> FlashPlan:
    """The launch plan of the passes path (``d`` above
    :data:`FLASH_WIDE_STREAMED_MAX_D`, or any ``d`` above :data:`FLASH_MAX_D`
    to compare it with the other paths): one block of
    :data:`FLASH_WIDE_THREADS` per (query tile of :data:`FLASH_WIDE_ROWS`
    rows, batch · head, pass of :data:`FLASH_WIDE_COLS` of O's columns).
    Pure arithmetic, checked again by the C entry point."""
    if min(b, h, lq, lk, sm_count) < 1 or d <= FLASH_MAX_D:
        raise ValueError(
            f"no flash wide launch plan for b={b}, h={h}, lq={lq}, lk={lk}, d={d}, "
            f"sm_count={sm_count}"
        )
    threads = FLASH_WIDE_THREADS
    per_sm = min(_SM_REGS // (threads * FLASH_WIDE_REGS),
                 _SM_SMEM // (FLASH_WIDE_SMEM + _BLOCK_SMEM_RESERVE),
                 _SM_MAX_BLOCKS, _SM_MAX_THREADS // threads)
    q_tiles, passes = _cdiv(lq, FLASH_WIDE_ROWS), _cdiv(d, FLASH_WIDE_COLS)
    blocks = b * h * q_tiles * passes
    return FlashPlan(
        bq=FLASH_WIDE_ROWS, bk=FLASH_WIDE_KEYS, threads=threads,
        s_tile=(1, FLASH_WIDE_KEYS // FLASH_KEY_THREADS),
        o_tile=(1, FLASH_WIDE_COLS // FLASH_KEY_THREADS),
        smem=FLASH_WIDE_SMEM, regs=FLASH_WIDE_REGS, blocks_per_sm=per_sm,
        q_tiles=q_tiles, kv_tiles=_cdiv(lk, FLASH_WIDE_KEYS), blocks=blocks,
        waves=_cdiv(blocks, sm_count * per_sm), passes=passes, path="passes",
    )


def flash_resident_groups(d: int) -> int:
    """G, the float4 column groups of O a thread of the resident path owns
    at head width ``d`` (``res_groups`` in the .cu): the instantiation."""
    return _cdiv(_cdiv(d, 4), 16)


def flash_resident_smem_bytes(d: int) -> int:
    """Dynamic shared memory of a resident-path block (``res_smem_floats``
    in the .cu): the Q and K tiles at a row stride of D rounded up to 8 plus
    FLASH_PAD floats, the V tile, the probabilities [64, 68] and two row
    vectors."""
    w = _cdiv(d, 8) * 8
    return 4 * ((FLASH_WIDE_RES_ROWS + FLASH_WIDE_RES_KEYS) * (w + FLASH_PAD)
                + FLASH_WIDE_RES_KEYS * w + FLASH_WIDE_RES_ROWS * FLASH_WIDE_RES_P_STRIDE
                + 2 * FLASH_WIDE_RES_ROWS)


@functools.lru_cache(maxsize=256)
def flash_resident_launch_plan(b: int, h: int, lq: int, lk: int, d: int,
                               sm_count: int, regs: int) -> FlashPlan:
    """The launch plan of the resident path (``FLASH_MAX_D < d <=
    FLASH_WIDE_RES_MAX_D``) on a card of ``sm_count`` SMs, where ``regs``
    are the registers a thread of the width's instantiation takes (read
    off the card): one block of :data:`FLASH_WIDE_RES_THREADS` per (query
    tile of :data:`FLASH_WIDE_RES_ROWS` rows, batch · head), taking all of
    D. Pure arithmetic, checked again by the C entry point."""
    if (min(b, h, lq, lk, sm_count, regs) < 1
            or not FLASH_MAX_D < d <= FLASH_WIDE_RES_MAX_D):
        raise ValueError(
            f"no flash resident launch plan for b={b}, h={h}, lq={lq}, lk={lk}, d={d}, "
            f"sm_count={sm_count}, regs={regs}"
        )
    return _whole_width_plan("resident", b * h, lq, lk, FLASH_WIDE_RES_ROWS,
                             FLASH_WIDE_RES_KEYS, FLASH_WIDE_RES_THREADS,
                             flash_resident_smem_bytes(d), regs, sm_count, (4, 4),
                             (4, 4 * flash_resident_groups(d)))


def _whole_width_plan(path: str, bh: int, lq: int, lk: int, rows: int, keys: int,
                      threads: int, smem: int, regs: int, sm_count: int,
                      s_tile: Tuple[int, int], o_tile: Tuple[int, int]) -> FlashPlan:
    """The plan of a path that takes all of D in one block per (query tile
    of ``rows`` rows, batch · head), heaviest query tiles first: blocks an
    SM from the registers, the shared memory and the threads of a block."""
    per_sm = min(_SM_REGS // (threads * _cdiv(regs, 8) * 8),
                 _SM_SMEM // (smem + _BLOCK_SMEM_RESERVE),
                 _SM_MAX_BLOCKS, _SM_MAX_THREADS // threads)
    q_tiles = _cdiv(lq, rows)
    blocks = bh * q_tiles
    return FlashPlan(
        bq=rows, bk=keys, threads=threads, s_tile=s_tile, o_tile=o_tile, smem=smem,
        regs=regs, blocks_per_sm=per_sm, q_tiles=q_tiles, kv_tiles=_cdiv(lk, keys),
        blocks=blocks, waves=_cdiv(blocks, sm_count * per_sm), path=path,
    )


def flash_streamed_smem_bytes(d: int) -> int:
    """Dynamic shared memory of a streamed-path block (``str_smem_floats``
    in the .cu): the Q tile at a row stride of D rounded up to 8 plus
    FLASH_PAD floats, FLASH_STREAMED_STAGES chunk buffers [64,
    FLASH_STREAMED_C_STRIDE] that K's and V's column chunks take in turn,
    the probabilities [64, 68] and two row vectors."""
    w = _cdiv(d, 8) * 8
    return 4 * (FLASH_STREAMED_ROWS * (w + FLASH_PAD)
                + FLASH_STREAMED_STAGES * FLASH_STREAMED_KEYS * FLASH_STREAMED_C_STRIDE
                + FLASH_STREAMED_ROWS * FLASH_WIDE_RES_P_STRIDE + 2 * FLASH_STREAMED_ROWS)


@functools.lru_cache(maxsize=256)
def flash_streamed_launch_plan(b: int, h: int, lq: int, lk: int, d: int,
                               sm_count: int, regs: int) -> FlashPlan:
    """The launch plan of the streamed path (``FLASH_MAX_D < d <=
    FLASH_STREAMED_MAX_D``; :func:`flash_plan_for` picks it above
    :data:`FLASH_WIDE_RES_MAX_D`) on a card of ``sm_count`` SMs, where
    ``regs`` are the registers a thread of its kernel takes (read off the
    card): one block of :data:`FLASH_STREAMED_THREADS` per (query tile of
    :data:`FLASH_STREAMED_ROWS` rows, batch · head), taking all of D. Pure
    arithmetic, checked again by the C entry point."""
    if (min(b, h, lq, lk, sm_count, regs) < 1
            or not FLASH_MAX_D < d <= FLASH_STREAMED_MAX_D):
        raise ValueError(
            f"no flash streamed launch plan for b={b}, h={h}, lq={lq}, lk={lk}, d={d}, "
            f"sm_count={sm_count}, regs={regs}"
        )
    return _whole_width_plan("streamed", b * h, lq, lk, FLASH_STREAMED_ROWS,
                             FLASH_STREAMED_KEYS, FLASH_STREAMED_THREADS,
                             flash_streamed_smem_bytes(d), regs, sm_count, (4, 4),
                             (4, 4 * FLASH_STREAMED_GROUPS))


def flash_wide_streamed_smem_bytes(d: int) -> int:
    """Dynamic shared memory of a wide-streamed-path block
    (``ws_smem_floats`` in the .cu): the Q tile at a row stride of D rounded
    up to 8 plus FLASH_PAD floats, FLASH_WIDE_STREAMED_STAGES chunk buffers
    of 64 rows of the wider of a K and a V chunk (plus 4 floats), the
    probabilities [64, 68] and two row vectors."""
    w = _cdiv(d, 8) * 8
    chunk = max(FLASH_WIDE_STREAMED_K_CHUNK, FLASH_WIDE_STREAMED_V_CHUNK) + FLASH_PAD
    return 4 * (FLASH_WIDE_STREAMED_ROWS * (w + FLASH_PAD)
                + FLASH_WIDE_STREAMED_STAGES * FLASH_WIDE_STREAMED_KEYS * chunk
                + FLASH_WIDE_STREAMED_ROWS * FLASH_WIDE_RES_P_STRIDE
                + 2 * FLASH_WIDE_STREAMED_ROWS)


@functools.lru_cache(maxsize=256)
def flash_wide_streamed_launch_plan(b: int, h: int, lq: int, lk: int, d: int,
                                    sm_count: int, regs: int) -> FlashPlan:
    """The launch plan of the wide streamed path (``FLASH_MAX_D < d <=
    FLASH_WIDE_STREAMED_MAX_D``; :func:`flash_plan_for` picks it above
    :data:`FLASH_STREAMED_MAX_D`) on a card of ``sm_count`` SMs, where
    ``regs`` are the registers a thread of its kernel takes (read off the
    card): one block of :data:`FLASH_WIDE_STREAMED_THREADS` per (query tile
    of :data:`FLASH_WIDE_STREAMED_ROWS` rows, batch · head), taking all of
    D. Pure arithmetic, checked again by the C entry point."""
    if (min(b, h, lq, lk, sm_count, regs) < 1
            or not FLASH_MAX_D < d <= FLASH_WIDE_STREAMED_MAX_D):
        raise ValueError(
            f"no flash wide streamed launch plan for b={b}, h={h}, lq={lq}, lk={lk}, d={d}, "
            f"sm_count={sm_count}, regs={regs}"
        )
    return _whole_width_plan("wide_streamed", b * h, lq, lk, FLASH_WIDE_STREAMED_ROWS,
                             FLASH_WIDE_STREAMED_KEYS, FLASH_WIDE_STREAMED_THREADS,
                             flash_wide_streamed_smem_bytes(d), regs, sm_count, (2, 4),
                             (2, 4 * FLASH_WIDE_STREAMED_GROUPS))


def flash_cluster_slices(d: int) -> Tuple[int, int]:
    """The cluster path's slices of a head of width ``d`` (``cl_slice_width``
    in the .cu): rank 0 the first D rounded up to 8, halved and rounded up
    to 8 columns, rank 1 the rest (zeros past D), each a multiple of 8."""
    w = _cdiv(d, 8) * 8
    first = _cdiv(w // 2, 8) * 8
    return first, w - first


def flash_cluster_smem_bytes(d: int) -> int:
    """Dynamic shared memory of a cluster-path block (``cl_smem_floats`` in
    the .cu): a wide-streamed-path block's at the wider slice; the
    probabilities double as the exchange buffer of the partial scores."""
    return flash_wide_streamed_smem_bytes(flash_cluster_slices(d)[0])


@functools.lru_cache(maxsize=256)
def flash_cluster_launch_plan(b: int, h: int, lq: int, lk: int, d: int,
                              sm_count: int, regs: int) -> FlashPlan:
    """The launch plan of the cluster path (``FLASH_MAX_D < d <=
    FLASH_CLUSTER_MAX_D``; :func:`flash_plan_for` picks it above
    :data:`FLASH_WIDE_STREAMED_MAX_D`) on a card of ``sm_count`` SMs, where
    ``regs`` are the registers a thread of its kernel takes (read off the
    card): a cluster of :data:`FLASH_CLUSTER_BLOCKS` blocks of
    :data:`FLASH_CLUSTER_THREADS` per (query tile of
    :data:`FLASH_WIDE_STREAMED_ROWS` rows, batch · head), block r taking
    slice r of D (:func:`flash_cluster_slices`). Blocks an SM and waves as
    :func:`flash_wide_streamed_launch_plan` counts them; the card may hold
    fewer clusters at once (:func:`flash_cluster_occupancy`). Pure
    arithmetic, checked again by the C entry point."""
    if (min(b, h, lq, lk, sm_count, regs) < 1
            or not FLASH_MAX_D < d <= FLASH_CLUSTER_MAX_D):
        raise ValueError(
            f"no flash cluster launch plan for b={b}, h={h}, lq={lq}, lk={lk}, d={d}, "
            f"sm_count={sm_count}, regs={regs}"
        )
    plan = _whole_width_plan("cluster", b * h * FLASH_CLUSTER_BLOCKS, lq, lk,
                             FLASH_WIDE_STREAMED_ROWS, FLASH_WIDE_STREAMED_KEYS,
                             FLASH_CLUSTER_THREADS, flash_cluster_smem_bytes(d), regs, sm_count,
                             (2, 4), (2, 4 * FLASH_CLUSTER_GROUPS))
    return plan._replace(cluster=FLASH_CLUSTER_BLOCKS, slices=flash_cluster_slices(d))


#: the serving path calls the wrapper from several batch threads at once
_flash_launch_lock = threading.Lock()

_FLASH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _check_flash_inputs(q, k, v) -> None:
    device = q.device if isinstance(q, torch.Tensor) else None
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, 4, (torch.float32,), device)
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"flash attention needs q [B, H, Lq, D] and k, v [B, H, Lk, D], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if d < 1:
        raise ValueError(f"head width D = {d}: the flash-attention kernel takes D >= 1")
    if k.shape[2] < 1:
        raise ValueError("flash attention needs at least one key")


def flash_attention_fwd_reference(
    q: torch.Tensor,  # [B, H, Lq, D] f32
    k: torch.Tensor,  # [B, H, Lk, D] f32
    v: torch.Tensor,  # [B, H, Lk, D] f32
    causal: bool,
) -> torch.Tensor:
    """The plain PyTorch version of the flash-attention kernel, on any
    device: ``attention.flash_attention`` with the kernel's arithmetic —
    q scaled by 1/sqrt(D) before the dot, keys walked in ascending tiles
    of :data:`FLASH_TILE` with the online softmax, the causal rule
    ``q_pos >= k_pos`` from 0 as a finite -1e30 mask, ``o / max(l,
    1e-30)``. It does not skip the tiles above the diagonal: once tile 0
    has made the running max a real score, a fully masked tile adds
    exactly 0 to l and o, so skipping changes no bit."""
    from .attention import flash_attention  # that module imports this one

    _check_flash_inputs(q, k, v)
    return flash_attention(q, k, v, causal=causal, block_k=FLASH_TILE, prescale_q=True)


def flash_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of every instantiation (:data:`FLASH_KERNELS`, keyed ``(d,
    bq)``), as ``cudaFuncGetAttributes`` reports them on the card."""
    lib = _configured("flash_attention", _FLASH_ARGTYPES)
    out = (ctypes.c_int * (3 * len(FLASH_KERNELS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "flash_attention_attrs", lib.pio_flash_attention_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {key: dict(zip(keys, out[3 * n:3 * n + 3]))
            for n, key in enumerate(FLASH_KERNELS)}


@functools.lru_cache(maxsize=None)
def _flash_regs(index: int) -> dict:
    return {key: a["regs"] for key, a in flash_kernel_attributes(index).items()}


def _flash_one_kernel_attributes(path: str, device) -> dict:
    """``pio_flash_attention_<path>_attrs``: registers per thread, spilled
    (local) bytes and static shared memory of that path's one kernel."""
    lib = _configured("flash_attention", _FLASH_ARGTYPES)
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, f"flash_attention_{path}_attrs",
                        getattr(lib, f"pio_flash_attention_{path}_attrs")(out))
    return dict(zip(("regs", "local_bytes", "static_smem"), out))


def flash_wide_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the passes kernel, as ``cudaFuncGetAttributes`` reports
    them on the card."""
    return _flash_one_kernel_attributes("wide", device)


def flash_resident_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the resident path's instantiations, keyed by G
    (:data:`FLASH_WIDE_RES_REGS`' keys), as ``cudaFuncGetAttributes``
    reports them on the card."""
    lib = _configured("flash_attention", _FLASH_ARGTYPES)
    out = (ctypes.c_int * (3 * len(FLASH_WIDE_RES_REGS)))()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "flash_attention_resident_attrs",
                        lib.pio_flash_attention_resident_attrs(out))
    keys = ("regs", "local_bytes", "static_smem")
    return {g: dict(zip(keys, out[3 * n:3 * n + 3]))
            for n, g in enumerate(FLASH_WIDE_RES_REGS)}


@functools.lru_cache(maxsize=None)
def _flash_resident_regs(index: int) -> dict:
    return {g: a["regs"] for g, a in flash_resident_kernel_attributes(index).items()}


def flash_streamed_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the streamed kernel, as ``cudaFuncGetAttributes`` reports
    them on the card."""
    return _flash_one_kernel_attributes("streamed", device)


@functools.lru_cache(maxsize=None)
def _flash_streamed_regs(index: int) -> int:
    return flash_streamed_kernel_attributes(index)["regs"]


def flash_wide_streamed_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the wide streamed kernel, as ``cudaFuncGetAttributes``
    reports them on the card."""
    return _flash_one_kernel_attributes("wide_streamed", device)


@functools.lru_cache(maxsize=None)
def _flash_wide_streamed_regs(index: int) -> int:
    return flash_wide_streamed_kernel_attributes(index)["regs"]


def flash_cluster_kernel_attributes(device=None) -> dict:
    """Registers per thread, spilled (local) bytes and static shared
    memory of the cluster kernel, as ``cudaFuncGetAttributes`` reports them
    on the card."""
    return _flash_one_kernel_attributes("cluster", device)


@functools.lru_cache(maxsize=None)
def _flash_cluster_regs(index: int) -> int:
    return flash_cluster_kernel_attributes(index)["regs"]


def flash_cluster_occupancy(plan: FlashPlan, device=None) -> int:
    """Clusters of the cluster path at ``plan``'s shared memory that the
    card holds at once, as ``cudaOccupancyMaxActiveClusters`` says (the
    plan's own estimate: SMs · ``blocks_per_sm`` // ``cluster``)."""
    lib = _configured("flash_attention", _FLASH_ARGTYPES)
    out = ctypes.c_int(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on_error(lib, "flash_attention_cluster_occupancy",
                        lib.pio_flash_attention_cluster_occupancy(plan.smem, ctypes.byref(out)))
    return out.value


def flash_plan_for(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   bq: Optional[int] = None) -> FlashPlan:
    """The launch plan for these CUDA tensors, with the SM count and the
    registers read off their card, picked by the head width D alone: up
    to :data:`FLASH_MAX_D` :func:`flash_launch_plan` (``bq`` forces its
    query tile), up to :data:`FLASH_WIDE_RES_MAX_D`
    :func:`flash_resident_launch_plan`, up to :data:`FLASH_STREAMED_MAX_D`
    :func:`flash_streamed_launch_plan`, up to
    :data:`FLASH_WIDE_STREAMED_MAX_D` :func:`flash_wide_streamed_launch_plan`,
    up to :data:`FLASH_CLUSTER_MAX_D` :func:`flash_cluster_launch_plan`,
    above it :func:`flash_wide_launch_plan` (``bq`` applies to none of the
    five)."""
    b, h, lq, d = q.shape
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    if d > FLASH_CLUSTER_MAX_D:
        return flash_wide_launch_plan(b, h, lq, k.shape[2], d, _sm_count(index))
    if d > FLASH_WIDE_STREAMED_MAX_D:
        return flash_cluster_launch_plan(b, h, lq, k.shape[2], d, _sm_count(index),
                                         _flash_cluster_regs(index))
    if d > FLASH_STREAMED_MAX_D:
        return flash_wide_streamed_launch_plan(b, h, lq, k.shape[2], d, _sm_count(index),
                                               _flash_wide_streamed_regs(index))
    if d > FLASH_WIDE_RES_MAX_D:
        return flash_streamed_launch_plan(b, h, lq, k.shape[2], d, _sm_count(index),
                                          _flash_streamed_regs(index))
    if d > FLASH_MAX_D:
        regs = _flash_resident_regs(index)[flash_resident_groups(d)]
        return flash_resident_launch_plan(b, h, lq, k.shape[2], d, _sm_count(index), regs)
    regs = _flash_regs(index)
    return flash_launch_plan(b, h, lq, k.shape[2], d, bool(causal), _sm_count(index),
                             tuple(regs[(d, n)] for n in FLASH_BQS), bq)


def flash_attention_fwd(
    q: torch.Tensor,  # [B, H, Lq, D] f32, contiguous
    k: torch.Tensor,  # [B, H, Lk, D] f32, contiguous
    v: torch.Tensor,  # [B, H, Lk, D] f32, contiguous
    causal: bool,
    plan: Optional[FlashPlan] = None,
) -> torch.Tensor:
    """Flash-attention forward ``o [B, H, Lq, D] = softmax(q kᵀ/√D,
    masked) v`` without an ``[Lq, Lk]`` score matrix in device memory.

    The counterpart of ``attention.py``'s ``_flash_pallas_call`` (same
    rules: causal ``q_pos >= k_pos`` counted from 0, finite -1e30 mask,
    ``o / max(l, 1e-30)``, causal tiles above the diagonal skipped),
    without its padding of L. CUDA tensors launch
    ``csrc/flash_attention.cu`` by :func:`flash_plan_for` (``plan``
    overrides it: the C entry point still checks it); CPU tensors run
    :func:`flash_attention_fwd_reference`. Any head width D is taken: up
    to :data:`FLASH_MAX_D` on the tuned path, where on the card q, k and v
    are zero-padded to the next multiple of :data:`FLASH_D_MULTIPLE` (zero
    columns add nothing to q·k nor to the columns kept), the kernel scales
    by the true D, and o is sliced back; wider heads unpadded, up to
    :data:`FLASH_WIDE_RES_MAX_D` on the resident path
    (:func:`flash_resident_launch_plan`), up to :data:`FLASH_STREAMED_MAX_D`
    on the streamed path (:func:`flash_streamed_launch_plan`), up to
    :data:`FLASH_WIDE_STREAMED_MAX_D` on the wide streamed path
    (:func:`flash_wide_streamed_launch_plan`), up to
    :data:`FLASH_CLUSTER_MAX_D` on the cluster path
    (:func:`flash_cluster_launch_plan`), above it on the passes path
    (:func:`flash_wide_launch_plan`), picked by D alone."""
    _check_flash_inputs(q, k, v)
    device = q.device
    if device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal)
    if device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {device}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if b * h == 0 or lq == 0:
        return torch.empty_like(q)
    if d > FLASH_MAX_D:
        return _flash_attention_wide(q, k, v, causal, plan)
    d_pad = _cdiv(d, FLASH_D_MULTIPLE) * FLASH_D_MULTIPLE
    if d_pad != d:
        q, k, v = (torch.nn.functional.pad(t, (0, d_pad - d)) for t in (q, k, v))
    out = torch.empty_like(q)
    if plan is None:
        plan = flash_plan_for(q, k, causal)
    if plan.q_tiles > FLASH_MAX_Q_TILES or plan.blocks > 2**31 - 1:
        raise ValueError(f"flash attention shape {tuple(q.shape)} is past the grid's limits")
    # the kernel reads 16-byte vectors: a contiguous view at an odd offset is copied
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    lib = _configured("flash_attention", _FLASH_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.pio_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, lq, lk, d_pad, d, int(bool(causal)), plan.bq, plan.threads,
            plan.smem, plan.blocks, stream,
        )
    with _flash_launch_lock:
        flash_attention_fwd.launches += 1
        flash_attention_fwd.launches_by_path[plan.path] += 1
    _raise_on_error(lib, "flash_attention", code)
    return out if d_pad == d else out[..., :d].contiguous()


def _flash_attention_wide(q, k, v, causal, plan) -> torch.Tensor:
    """The paths of :func:`flash_attention_fwd` above :data:`FLASH_MAX_D`
    (CUDA tensors): one launch of the entry the plan's path names
    (``pio_flash_attention_resident``, ``pio_flash_attention_streamed``,
    ``pio_flash_attention_wide_streamed``, ``pio_flash_attention_cluster``
    or, for the passes path, ``pio_flash_attention_wide``), counted on the
    wrapper."""
    b, h, lq, d = q.shape
    device = q.device
    out = torch.empty_like(q)
    if plan is None:
        plan = flash_plan_for(q, k, causal)
    if plan.path not in ("resident", "streamed", "wide_streamed", "cluster", "passes"):
        raise ValueError(f"a {plan.path} plan does not take a head of width {d}")
    if plan.blocks > 2**31 - 1:
        raise ValueError(f"flash attention shape {tuple(q.shape)} is past the grid's limits")
    lib = _configured("flash_attention", _FLASH_ARGTYPES)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, k.shape[2],
            d, int(bool(causal)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan.path == "passes":
            code = lib.pio_flash_attention_wide(*args, plan.threads, plan.blocks, stream)
        elif plan.path == "cluster":
            code = lib.pio_flash_attention_cluster(*args, plan.threads, plan.cluster,
                                                   *plan.slices, plan.smem, plan.blocks, stream)
        else:
            entry = getattr(lib, f"pio_flash_attention_{plan.path}")
            code = entry(*args, plan.threads, plan.smem, plan.blocks, stream)
    with _flash_launch_lock:
        flash_attention_fwd.launches += 1
        flash_attention_fwd.launches_by_path[plan.path] += 1
    _raise_on_error(lib, f"flash_attention_{plan.path}", code)
    return out



#: kernel launches since the count was last reset (CUDA tensors only), in
#: all and by the plan's path
flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_path = dict.fromkeys(FLASH_PATHS, 0)


def kernel_launches() -> dict:
    """The launches of every kernel wrapper in this process so far (CUDA
    tensors only), by kernel: what a child process of the console
    reports, since its counts are its own."""
    return {"topk_streaming": top_k_streaming.launches,
            "gramian_fused": gramian_fused.launches,
            "spd_solve": spd_solve.launches,
            "flash_attention": flash_attention_fwd.launches}
