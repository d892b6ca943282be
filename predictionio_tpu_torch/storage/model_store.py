"""Model blob stores.

Copy of ``predictionio_tpu/storage/model_store.py``: an engine
instance's trained models are one blob keyed by the instance id; the
workflow produces the bytes (a pickled model list) and the store only
moves them, zlib-compressed.
"""

from __future__ import annotations

import abc
import dataclasses
import os
import sqlite3
import threading
import urllib.parse
import zlib
from typing import Optional


def _fsync_dir(path: str) -> None:
    """fsync a directory so a renamed entry is durable (no-op where
    directories cannot be opened)."""
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


@dataclasses.dataclass(frozen=True)
class Model:
    """``Models.scala``: id (= engine instance id) + opaque bytes."""

    id: str
    models: bytes


class ModelStore(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, id: str) -> None: ...


class LocalFSModelStore(ModelStore):
    """One file per model id (``localfs/LocalFSModels.scala``)."""

    def __init__(self, base_dir: str):
        self._base = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _path(self, id: str) -> str:
        # percent-encode so distinct ids never collide on one file name
        safe = urllib.parse.quote(id, safe="")
        return os.path.join(self._base, f"pio_model_{safe}.bin")

    def insert(self, model: Model) -> None:
        # fsync before the rename, then the directory: otherwise a power
        # loss can leave a durable name over a torn blob
        tmp = self._path(model.id) + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(zlib.compress(model.models))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path(model.id))
        _fsync_dir(self._base)

    def get(self, id: str) -> Optional[Model]:
        try:
            with open(self._path(id), "rb") as fh:
                return Model(id, zlib.decompress(fh.read()))
        except FileNotFoundError:
            return None

    def delete(self, id: str) -> None:
        try:
            os.remove(self._path(id))
        except FileNotFoundError:
            pass


class SqliteModelStore(ModelStore):
    """Blob table in SQLite (same table as the JAX package's)."""

    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS pio_models "
                "(id TEXT PRIMARY KEY, models BLOB NOT NULL)"
            )
            self._conn.commit()

    def insert(self, model: Model) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO pio_models VALUES (?, ?)",
                (model.id, zlib.compress(model.models)),
            )
            self._conn.commit()

    def get(self, id: str) -> Optional[Model]:
        with self._lock:
            row = self._conn.execute(
                "SELECT models FROM pio_models WHERE id = ?", (id,)
            ).fetchone()
        return Model(id, zlib.decompress(row[0])) if row else None

    def delete(self, id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM pio_models WHERE id = ?", (id,))
            self._conn.commit()
