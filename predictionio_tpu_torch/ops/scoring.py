"""Serving-side scoring: the fused score+select entries of the
recommendation template.

Counterpart of ``predictionio_tpu/ops/scoring.py`` (the serving subset;
the similar-items entries wait for their template). One entry per query
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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..quant.ragged import ragged_gather
from .cuda_kernels import NEG_INF, top_k_streaming, top_k_streaming_reference

__all__ = [
    "NEG_INF",
    "dense_topk_with_sentinels",
    "estimate_topk_hbm_bytes",
    "pad_pow2",
    "resolve_topk_path",
    "top_k_for_users_fused",
    "top_k_fused_vectors",
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
