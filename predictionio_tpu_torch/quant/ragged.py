"""Ragged/deduplicated gather — ``table[ids]`` touching each unique
referenced row once.

Counterpart of ``predictionio_tpu/quant/ragged.py``. A serving batch
names the same user many times under load; the gather reads each unique
row once and replays duplicates through the inverse map. The result is
bit-identical to ``table[ids]`` (the same rows, reassembled), pinned in
``tests/test_torch_scoring.py``.
"""

from __future__ import annotations

import torch


def ragged_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` reading each unique row once.

    ``ids`` may be any integer shape (a serving batch ``[B]``, a block
    ``[B, K]``); the result is ``ids.shape + table.shape[1:]``. Empty
    ids give an empty result. Unlike the JAX version, whose static
    shapes pad the unique set, ``torch.unique`` returns exactly the
    unique rows (on the card it waits for its count)."""
    flat = ids.reshape(-1)
    if flat.numel() == 0:
        return table.new_empty(tuple(ids.shape) + tuple(table.shape[1:]))
    uniq, inverse = torch.unique(flat, return_inverse=True)
    rows = table[uniq.long()]
    return rows[inverse].reshape(tuple(ids.shape) + tuple(table.shape[1:]))
