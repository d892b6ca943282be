"""Compute plane of the port: serving-side scoring and the wrappers of
the hand-written CUDA kernels (``ops/cuda_kernels.py``). The scoring
entries are exported here as the JAX package's ``ops`` exports them."""

from .scoring import (
    standardize,
    top_k_for_users,
    top_k_for_users_fused,
    top_k_for_vectors,
    top_k_fused_vectors,
    top_k_similar_items,
    top_k_similar_items_fused,
)

__all__ = [
    "standardize",
    "top_k_for_users",
    "top_k_for_users_fused",
    "top_k_for_vectors",
    "top_k_fused_vectors",
    "top_k_similar_items",
    "top_k_similar_items_fused",
]
