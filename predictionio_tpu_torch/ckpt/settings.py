"""Checkpoint lever resolution: explicit > workflow run > env > default.

Copy of ``predictionio_tpu/ckpt/settings.py``: the engine params carry
the explicit value, the workflow run (``pio train --checkpoint-every`` /
``--resume``) a per-run override, and the ``PIO_CKPT_*`` envs the fleet
default. An invalid value fails when it is resolved, never as a silently
ignored flag.

Envs:

- ``PIO_CKPT_EVERY``      checkpoint cadence in iterations (0 = off)
- ``PIO_CKPT_RESUME``     0 = clear existing checkpoints, train fresh
- ``PIO_CKPT_KEEP_LAST``  GC: newest committed steps kept (default 3)
- ``PIO_CKPT_KEEP_EVERY`` GC: also keep steps divisible by J (0 = off)
- ``PIO_CKPT_QUEUE``      writer queue depth (default 2)
- ``PIO_CKPT_DIR``        the run's checkpoint root (kept on success,
  unlike the directory ``run_train`` derives)
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

EVERY_ENV = "PIO_CKPT_EVERY"
RESUME_ENV = "PIO_CKPT_RESUME"
KEEP_LAST_ENV = "PIO_CKPT_KEEP_LAST"
KEEP_EVERY_ENV = "PIO_CKPT_KEEP_EVERY"
QUEUE_ENV = "PIO_CKPT_QUEUE"
DIR_ENV = "PIO_CKPT_DIR"


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


def resolve_resume(
    explicit: Optional[bool] = None,
    env: Optional[Mapping[str, str]] = None,
) -> bool:
    """Resume toggle: explicit (``--resume``/``--no-resume``) > env >
    True. Default ON — a rerun after a crash picks up the latest valid
    checkpoint; the config-identity refusal guards against resuming
    foreign state."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ if env is None else env
    raw = env.get(RESUME_ENV)
    if raw is None or raw.strip() == "":
        return True
    return raw.strip() not in ("0", "false", "no", "off")


def resolve_retention(
    keep_last: Optional[int] = None,
    keep_every: Optional[int] = None,
    env: Optional[Mapping[str, str]] = None,
) -> tuple:
    """GC policy: explicit > env > (3, 0)."""
    env = os.environ if env is None else env
    if keep_last is None:
        keep_last = _env_int(env, KEEP_LAST_ENV)
    if keep_every is None:
        keep_every = _env_int(env, KEEP_EVERY_ENV)
    return (3 if keep_last is None else keep_last,
            0 if keep_every is None else keep_every)


def resolve_queue_depth(
    explicit: Optional[int] = None,
    env: Optional[Mapping[str, str]] = None,
) -> int:
    env = os.environ if env is None else env
    value = explicit if explicit is not None else _env_int(env, QUEUE_ENV)
    return 2 if value is None else value
