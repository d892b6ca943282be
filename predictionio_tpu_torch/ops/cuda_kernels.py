"""Wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

Counterpart of ``predictionio_tpu/ops/pallas_kernels.py`` for the kernels
ported so far: the streaming top-k (``top_k_streaming``,
``top_k_for_users_streaming``). A wrapper validates its inputs, then:

- on CPU tensors it runs the plain version (the CPU tests hold that
  against the JAX kernel in interpret mode);
- on CUDA tensors it launches the kernel on the current stream, or
  raises — there is no fallback;
- it counts its launches in a plain int attribute (``.launches``), so a
  run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..kernels import build

NEG_INF = float("-inf")

#: items per stage-1 block of ``csrc/topk_streaming.cu`` (kTileItems)
TOPK_TILE_ITEMS = 256
#: the kernel's ceiling on k (kMaxK: stage-2 shared memory); above it the
#: wrapper raises. pad_pow2 of any num <= 2048 stays under it.
TOPK_MAX_K = 2048
#: the kernel's item indices are int32 and padding indices sit above
#: 2**31 - 1 - TOPK_MAX_K, so the catalog is bounded well below that
TOPK_MAX_ITEMS = 1 << 30
#: stage 1 tiles queries by 8 on grid.y (at most 65,535 blocks)
TOPK_MAX_BATCH = 8 * 65535


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


def top_k_streaming(
    query_vectors: torch.Tensor,  # [B, R] float32
    item_factors: torch.Tensor,  # [N, R] float32
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,  # [B, E] int32, -1 padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k gather-dot: (scores ``[B, k]`` f32, item indices
    ``[B, k]`` i32) without materializing ``[B, N]`` scores on the card.

    The counterpart of ``pallas_kernels.top_k_streaming`` (same sentinel
    contract: a slot with fewer than k valid candidates holds -inf and
    index -1, which callers must treat as absent). CUDA tensors launch
    ``csrc/topk_streaming.cu``; CPU tensors run
    :func:`top_k_streaming_reference`. Raises for k past
    :data:`TOPK_MAX_K` (after clamping to N)."""
    _check_topk_inputs(query_vectors, item_factors, k, exclude_idx)
    b, r = query_vectors.shape
    n_items = item_factors.shape[0]
    k_eff = min(k, n_items)
    # the kernel's limits hold on every device, so a CPU run refuses what
    # the card would
    if k_eff > TOPK_MAX_K:
        raise ValueError(
            f"k = {k_eff} exceeds the streaming kernel's ceiling "
            f"{TOPK_MAX_K} (stage-2 shared memory)"
        )
    if n_items > TOPK_MAX_ITEMS:
        raise ValueError(f"catalog of {n_items} items exceeds {TOPK_MAX_ITEMS}")
    if b > TOPK_MAX_BATCH:
        raise ValueError(f"batch of {b} queries exceeds {TOPK_MAX_BATCH}")
    if r == 0:
        raise ValueError("the streaming kernel needs rank >= 1")
    device = query_vectors.device
    if device.type == "cpu":
        return top_k_streaming_reference(
            query_vectors, item_factors, k, exclude_idx
        )
    if device.type != "cuda":
        raise ValueError(f"top_k_streaming runs on cuda or cpu, not {device}")
    if b == 0 or k_eff == 0:  # nothing to score: every slot is a sentinel
        return _pad_k(
            torch.empty((b, 0), device=device),
            torch.empty((b, 0), device=device, dtype=torch.int32), k,
        )
    e = 0 if exclude_idx is None else exclude_idx.shape[1]
    kt = min(k_eff, TOPK_TILE_ITEMS)
    n_tiles = -(-n_items // TOPK_TILE_ITEMS)
    cand_s = torch.empty((b, n_tiles, kt), dtype=torch.float32, device=device)
    cand_i = torch.empty((b, n_tiles, kt), dtype=torch.int32, device=device)
    out_s = torch.empty((b, k_eff), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k_eff), dtype=torch.int32, device=device)
    lib = _topk_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.pio_topk_streaming(
            query_vectors.data_ptr(), item_factors.data_ptr(),
            exclude_idx.data_ptr() if e else None,
            b, n_items, r, e, k_eff, kt, n_tiles,
            cand_s.data_ptr(), cand_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), stream,
        )
    top_k_streaming.launches += 1
    if code != 0:
        msg = lib.pio_cuda_error_string(code).decode(errors="replace")
        raise build.KernelLaunchError(f"topk_streaming launch failed: {msg}")
    return _pad_k(out_s, out_i, k)


#: kernel launches since the count was last reset (CUDA tensors only)
top_k_streaming.launches = 0


def _topk_library() -> ctypes.CDLL:
    lib = build.load_library("topk_streaming")
    if not getattr(lib, "_pio_configured", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pio_topk_streaming.argtypes = [
            p, p, p, i, i, i, i, i, i, i, p, p, p, p, p,
        ]
        lib.pio_topk_streaming.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
        lib._pio_configured = True
    return lib


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
