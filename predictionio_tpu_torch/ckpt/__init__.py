"""Checkpointing of the port.

- :mod:`.settings` resolves the levers: the cadence (engine params >
  ``pio train --checkpoint-every`` > ``PIO_CKPT_EVERY`` > off), resume
  (``--resume/--no-resume`` > ``PIO_CKPT_RESUME`` > on), retention and
  the writer's queue depth.
- :mod:`.store` is the manifest-last checkpoint store (SHA-256 per file,
  the loud skip of a corrupt step, :class:`CheckpointMismatch`,
  retention), :mod:`.writer` its bounded background writer, and
  :mod:`.cli` ``pio ckpt ls|verify|gc`` over it.

The single-device ALS trainer checkpoints through
``workflow.checkpoint.CheckpointManager`` (``ops.als.als_train``). The
store's producer, the sharded trainer, is not ported yet (ROADMAP.md,
queue 1 item 11), so ``pio ckpt`` reads stores that another process
(the JAX package's sharded trainer) wrote.
"""

from .settings import (  # noqa: F401
    DIR_ENV,
    EVERY_ENV,
    KEEP_EVERY_ENV,
    KEEP_LAST_ENV,
    QUEUE_ENV,
    RESUME_ENV,
    resolve_every,
    resolve_queue_depth,
    resolve_resume,
    resolve_retention,
)
from .store import (  # noqa: F401
    MANIFEST,
    CheckpointCorrupt,
    CheckpointError,
    CheckpointMismatch,
    CheckpointStore,
    LoadedCheckpoint,
    sha256_bytes,
)
from .writer import CheckpointWriter  # noqa: F401
