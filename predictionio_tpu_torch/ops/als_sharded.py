"""Sharded ALS, the levers only.

Counterpart of ``predictionio_tpu/ops/als_sharded.py``. The sharded
trainer is not ported yet (ROADMAP.md, queue 1: sharded ALS on
``torch.distributed``); what is here resolves the shard count the same
way, so a run asked for shards through the environment is refused
exactly where the JAX package would shard it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

#: env override of the ``shards`` tri-state (``pio train --shards`` sets it)
SHARDS_ENV = "PIO_TRAIN_SHARDS"


def resolve_shards(
    shards: Optional[int] = None,
    env: Optional[Dict[str, str]] = None,
) -> int:
    """The shard count a train run executes: an explicit value wins, else
    :data:`SHARDS_ENV`, else 1. An invalid value raises ``ValueError``;
    nothing is clamped."""
    if shards is not None:
        n = int(shards)
        if n < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        return n
    e = env if env is not None else os.environ
    raw = e.get(SHARDS_ENV)
    if raw:
        try:
            n = int(raw)
        except ValueError:
            raise ValueError(f"{SHARDS_ENV} must be an integer, got {raw!r}")
        if n < 1:
            raise ValueError(f"{SHARDS_ENV} must be >= 1, got {raw!r}")
        return n
    return 1
