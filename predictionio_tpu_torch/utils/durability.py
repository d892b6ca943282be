"""Crash-safe whole-file writes.

Trimmed copy of ``predictionio_tpu/utils/durability.py``: write to a
temporary sibling, flush and fsync it *before* ``os.replace``, then
fsync the parent directory so the new directory entry is durable too.
Skipping the first fsync is the classic torn-file bug: the rename can be
journaled before the file's data blocks, so a power loss leaves a
durable name pointing at truncated bytes.
"""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync a directory so newly created or renamed entries are durable
    (no-op where directories cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe whole-file replace: after a crash at any point, ``path``
    holds either the complete old bytes or the complete new bytes."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))
