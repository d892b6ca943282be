"""Serving-side scoring: the fused score+select entries of the
recommendation, similar-product and e-commerce templates.

Counterpart of ``predictionio_tpu/ops/scoring.py``. One entry per query
kind dispatches on :func:`resolve_topk_path`:

- ``"streaming"``: the hand-written CUDA kernel
  (:func:`.cuda_kernels.top_k_streaming`) — the ``[B, N]`` score matrix
  never reaches device memory. On a CUDA device every top-k takes it;
- ``"dense"``: one ``torch.matmul`` plus a stable sort, normalized to the
  same sentinel contract — the counterpart of the XLA leg, kept for the
  CPU only.

Sentinel contract (both paths): a slot with fewer than k valid candidates
holds score -inf and index -1; callers must treat -1 as absent and never
index with it. Equal scores keep the lowest item index first.

Exclusions reach both paths as ``[B, E]`` int32 index lists, -1 padded
(:func:`exclusion_matrix`): a dense ``[B, N]`` mask, where a caller has
one, is turned into lists first (:func:`mask_to_exclusion_lists`), so the
kernel takes filters as large as the catalog. The unfused entries of the
JAX package (:func:`top_k_for_users`, :func:`top_k_for_vectors`,
:func:`top_k_similar_items`), which score the whole ``[B, I]`` product
there, take the same path here; where ``lax.top_k`` returns an excluded
item's index beside its -inf score, they return (-inf, -1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..quant.ragged import ragged_gather
from .cuda_kernels import NEG_INF, top_k_streaming, top_k_streaming_reference

__all__ = [
    "NEG_INF",
    "dense_topk_with_sentinels",
    "estimate_topk_hbm_bytes",
    "exclusion_matrix",
    "mask_to_exclusion_lists",
    "pad_pow2",
    "results_to_host",
    "resolve_topk_path",
    "standardize",
    "summed_rows",
    "top_k_for_users",
    "top_k_for_users_fused",
    "top_k_for_vectors",
    "top_k_fused_vectors",
    "top_k_similar_items",
    "top_k_similar_items_fused",
    "unit_rows",
    "use_streaming_topk",
]

def use_streaming_topk(mode: str, device: torch.device) -> bool:
    """Shared streaming-top-k selection rule for serving templates.

    On a CUDA device the kernel is the path: "auto" and "always" stream,
    and "never" raises, since the port runs no dense product on the card
    in place of the kernel. On the CPU, "always" streams (the wrapper
    then runs its plain version) and "auto"/"never" take the dense leg.
    Raises on an unknown mode so a config typo fails at validation time,
    not mid-serving."""
    if mode not in ("auto", "always", "never"):
        raise ValueError(
            f"streaming_top_k must be 'auto', 'always' or 'never', "
            f"got {mode!r}"
        )
    if torch.device(device).type == "cuda":
        if mode == "never":
            raise ValueError(
                "streaming_top_k='never' selects the dense leg, which runs "
                "only on the CPU; on a CUDA device every top-k goes through "
                "the streaming kernel (use 'auto' or 'always')"
            )
        return True
    return mode == "always"


def pad_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo).

    Serving shape-bucketing: micro-batches arrive at every size from 1
    to batch_max; padding batch and k to powers of two keeps the set of
    shapes (and of scratch sizes the kernel sees) at O(log)."""
    n = max(int(n), lo)
    return 1 << (n - 1).bit_length()


def dense_topk_with_sentinels(
    query_vectors: torch.Tensor,
    item_factors: torch.Tensor,
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense leg of the fused top-k (the CPU's): ``torch.matmul``
    scores plus a stable descending sort, with the streaming kernel's
    contract (-inf / -1 on invalid slots, k padded past the catalog,
    lowest index first on ties). Counterpart of
    ``xla_topk_with_sentinels``; the arithmetic is the kernel's plain
    version, so the two legs cannot drift."""
    return top_k_streaming_reference(
        query_vectors, item_factors, k, exclude_idx
    )


def resolve_topk_path(mode: str, device: torch.device) -> str:
    """The resolved serve-side top-k path — "streaming" (CUDA kernel) or
    "dense" (matmul + sort). The ONE decision home: the fused entries
    dispatch on it and the template records it (``/status.json`` →
    ``topkPath``), so the reported path cannot drift from the executed
    one."""
    return (
        "streaming" if use_streaming_topk(mode, device) else "dense"
    )


def _fused_dispatch(query_vectors, item_factors, k, exclude_idx, mode):
    if resolve_topk_path(mode, item_factors.device) == "streaming":
        return top_k_streaming(query_vectors, item_factors, k, exclude_idx)
    return dense_topk_with_sentinels(
        query_vectors, item_factors, k, exclude_idx
    )


def top_k_fused_vectors(
    query_vectors: torch.Tensor,  # [B, R]
    item_factors: torch.Tensor,  # [I, R]
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,  # [B, E] int32, -1 padded
    mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused score+select for raw query vectors. ``mode`` is the
    template-level ``streaming_top_k`` knob ("auto" | "always" |
    "never")."""
    return _fused_dispatch(
        query_vectors.contiguous(), item_factors, k, exclude_idx, mode
    )


def top_k_for_users_fused(
    user_factors: torch.Tensor,  # [U, R]
    item_factors: torch.Tensor,  # [I, R]
    user_idx: torch.Tensor,  # [B] int
    k: int,
    exclude_idx: Optional[torch.Tensor] = None,
    mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k items for known users (the recommendation template's
    serving entry): the user-row gather stays on the device and rides
    :func:`ragged_gather` — duplicate users in a batch read their factor
    row once; bit-identical to ``user_factors[user_idx]``."""
    return _fused_dispatch(
        ragged_gather(user_factors, user_idx),
        item_factors, k, exclude_idx, mode,
    )


def exclusion_matrix(lists: Sequence[Sequence[int]], rows: Optional[int] = None) -> np.ndarray:
    """Per-query exclusion lists as one ``[rows, E]`` int32 array, -1
    padded (rows past ``len(lists)`` exclude nothing). ``E`` is
    ``pad_pow2(longest list, lo=16)``, as the JAX streaming branch pads
    it, so the kernel sees O(log) widths."""
    rows = len(lists) if rows is None else rows
    width = pad_pow2(max((len(x) for x in lists), default=0), lo=16)
    out = np.full((rows, width), -1, dtype=np.int32)
    for r, lst in enumerate(lists):
        out[r, : len(lst)] = lst
    return out


def mask_to_exclusion_lists(mask: torch.Tensor) -> torch.Tensor:
    """A ``[B, N]`` bool mask (True = exclude) as ``[B, E]`` int32 index
    lists on the mask's device, -1 padded, each row's ids ascending, ``E``
    padded as in :func:`exclusion_matrix`."""
    b = mask.shape[0]
    rows, cols = torch.nonzero(mask, as_tuple=True)
    counts = torch.bincount(rows, minlength=b)
    width = pad_pow2(int(counts.max()) if rows.numel() else 0, lo=16)
    out = torch.full((b, width), -1, dtype=torch.int32, device=mask.device)
    if rows.numel():
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(rows.numel(), device=mask.device) - starts[rows]
        out[rows, pos] = cols.to(torch.int32)
    return out


def summed_rows(table: torch.Tensor, groups: Sequence[Sequence[int]], rows: int) -> torch.Tensor:
    """``[rows, R]`` on ``table``'s device: row r is the sum of
    ``table``'s rows ``groups[r]`` (rows past ``len(groups)`` are zero),
    one gather and one ``index_add_``."""
    flat = np.array([i for g in groups for i in g], dtype=np.int64)
    owner = np.repeat(np.arange(len(groups)), [len(g) for g in groups])
    out = torch.zeros((rows, table.shape[1]), dtype=table.dtype, device=table.device)
    return out.index_add_(0, torch.from_numpy(owner).to(table.device),
                          table[torch.from_numpy(flat).to(table.device)])


def results_to_host(scores: torch.Tensor, idx: torch.Tensor, b: int, k: int):
    """The first ``b`` rows and ``k`` slots of a top-k result as Python
    lists (scores, ids), in one device→host copy: the int32 ids ride as
    float32 bit patterns beside the scores."""
    packed = torch.cat([scores[:b, :k], idx[:b, :k].view(torch.float32)], dim=1).cpu()
    return packed[:, :k].tolist(), packed[:, k:].view(torch.int32).tolist()


def top_k_for_vectors(
    query_vectors: torch.Tensor,  # [B, R]
    item_factors: torch.Tensor,  # [I, R]
    k: int,
    exclude_mask: Optional[torch.Tensor] = None,  # [B, I] bool, True = exclude
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items for raw query vectors under a dense exclusion mask.
    The JAX package scores the whole ``[B, I]`` product and takes
    ``lax.top_k``; here the mask's True positions become exclusion lists
    (:func:`mask_to_exclusion_lists`), which the streaming kernel takes on
    a CUDA device and :func:`dense_topk_with_sentinels` on the CPU. The
    result keeps the sentinel contract: an excluded slot is (-inf, -1)."""
    excl = None if exclude_mask is None else mask_to_exclusion_lists(
        exclude_mask.to(device=item_factors.device, dtype=torch.bool))
    return top_k_fused_vectors(query_vectors, item_factors, k, excl)


def top_k_for_users(
    user_factors: torch.Tensor,  # [U, R]
    item_factors: torch.Tensor,  # [I, R]
    user_idx: torch.Tensor,  # [B] int
    k: int,
    exclude_mask: Optional[torch.Tensor] = None,  # [B, I] bool, True = exclude
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items for a batch of known users under a dense exclusion
    mask (the JAX package's unfused entry, ``_score_topk`` over
    ``user_factors[user_idx]``): the rows are gathered on the tables'
    device, the mask becomes exclusion lists, and the streaming kernel
    takes them on a CUDA device, :func:`dense_topk_with_sentinels` on the
    CPU. An excluded slot is (-inf, -1), where ``lax.top_k`` returns the
    excluded item's index beside -inf."""
    idx = torch.as_tensor(user_idx, device=item_factors.device)
    return top_k_for_vectors(ragged_gather(user_factors, idx), item_factors, k,
                             exclude_mask)


def unit_rows(table: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length, ``f / max(||f||, 1e-12)`` (the JAX
    package's cosine normalisation)."""
    norms = torch.linalg.vector_norm(table, dim=1, keepdim=True)
    return (table / torch.clamp_min(norms, 1e-12)).contiguous()


def top_k_similar_items_fused(
    item_factors: torch.Tensor,  # [I, R]
    item_idx: torch.Tensor,  # [B] int
    k: int,
    exclude_self: bool = True,
    mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cosine-similar items: the catalog is normalised on its
    device, :func:`ragged_gather` picks the query rows, and each query's
    own index rides the exclusion list (``[B, 1]``). A sub-k slot is
    (-inf, -1)."""
    unit = unit_rows(item_factors)
    idx = item_idx.to(device=unit.device, dtype=torch.int32)
    excl = idx[:, None].contiguous() if exclude_self else None
    return _fused_dispatch(ragged_gather(unit, idx), unit, k, excl, mode)


def top_k_similar_items(
    item_factors: torch.Tensor,  # [I, R]
    item_idx: torch.Tensor,  # [B] int
    k: int,
    exclude_self: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine-similar items, the JAX package's unfused entry: the catalog
    normalised (``f / max(||f||, 1e-12)``), each query's own row scored
    against it and, with ``exclude_self``, its own index excluded. On a
    CUDA device the streaming kernel, on the CPU the dense leg
    (:func:`top_k_similar_items_fused` with ``mode="auto"``). The excluded
    self, where it would fill a slot (k >= I), is (-inf, -1); ``lax.top_k``
    returns its index beside -inf."""
    return top_k_similar_items_fused(item_factors, torch.as_tensor(item_idx), k,
                                     exclude_self=exclude_self, mode="auto")


def standardize(scores: torch.Tensor) -> torch.Tensor:
    """Z-scores, ``(s - mean) / max(std, 1e-12)`` with the population
    std (the ensemble combine step of the JAX package)."""
    std = torch.std(scores, unbiased=False)
    return (scores - scores.mean()) / torch.clamp_min(std, 1e-12)


def estimate_topk_hbm_bytes(
    b: int, n_items: int, rank: int, k: int, streaming: bool
) -> float:
    """Device-memory traffic model for one batched top-k dispatch.

    Dense path: read both factor inputs once, WRITE the [B, I] score
    matrix, re-read it for the selection, write [B, k] results (scores
    f32 + indices i32). Streaming path: scores stay on chip, so only the
    factors and the results move."""
    factors = float(b) * rank * 4.0 + float(n_items) * rank * 4.0
    results = float(b) * k * 8.0
    if streaming:
        return factors + results
    score_matrix = float(b) * n_items * 4.0
    return factors + 2.0 * score_matrix + results
