"""Checkpointing of the port: the cadence lever only (see
:mod:`.settings`). Checkpointed training itself is not ported yet
(ROADMAP.md, queue 1: checkpoint resume in the port's trainer)."""

from .settings import EVERY_ENV, RESUME_ENV, resolve_every  # noqa: F401
