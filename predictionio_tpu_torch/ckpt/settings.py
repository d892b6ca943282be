"""Checkpoint cadence resolution: explicit > workflow run > env > 0.

Counterpart of ``predictionio_tpu/ckpt/settings.py``, trimmed to the
cadence: the engine params carry the explicit value, the workflow run
(``WorkflowParams.checkpoint_every``) a per-run override, and
``PIO_CKPT_EVERY`` the fleet default. An invalid value fails when it is
resolved, never as a silently ignored flag.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

#: checkpoint cadence in iterations (0 = off)
EVERY_ENV = "PIO_CKPT_EVERY"
#: resume from the newest checkpoint ("1") or train fresh ("0"); ``pio
#: train --resume/--no-resume`` sets it. Nothing reads it until
#: checkpointed training is ported (a cadence > 0 is refused before then)
RESUME_ENV = "PIO_CKPT_RESUME"


def _env_int(env: Mapping[str, str], name: str) -> Optional[int]:
    raw = env.get(name)
    if raw is None or raw.strip() == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer — unset it or pass a "
            "whole number of iterations"
        ) from None


def resolve_every(
    explicit: Optional[int] = None,
    workflow: Optional[int] = None,
    env: Optional[Mapping[str, str]] = None,
) -> int:
    """Checkpoint cadence: engine params > workflow run > env > 0."""
    env = os.environ if env is None else env
    for source, value in (
        ("checkpoint_every", explicit),
        ("--checkpoint-every", workflow),
        (EVERY_ENV, _env_int(env, EVERY_ENV)),
    ):
        if value is not None:
            if value < 0:
                raise ValueError(
                    f"{source}={value} must be >= 0 (0 disables "
                    "checkpointing)"
                )
            return int(value)
    return 0
