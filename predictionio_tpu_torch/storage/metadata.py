"""Engine-instance metadata on SQLite.

Trimmed copy of ``predictionio_tpu/storage/metadata.py``: the
``EngineInstance`` record, its status constants, ``new_engine_instance``
and the engine-instance table of ``MetadataStore`` — what deploying
needs. Apps, access keys, manifests, rollout plans and evaluation
instances wait for their slices. The table layout is the JAX package's,
so both packages can share one metadata file.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional

UTC = _dt.timezone.utc

# EngineInstance status values (CreateWorkflow.scala:245-253,
# CoreWorkflow.scala:77, Console.scala:742-780).
STATUS_INIT = "INIT"
STATUS_TRAINING = "TRAINING"
STATUS_COMPLETED = "COMPLETED"
STATUS_EVALUATING = "EVALUATING"
STATUS_EVALCOMPLETED = "EVALCOMPLETED"


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def _to_ms(when: _dt.datetime) -> int:
    """Epoch milliseconds; naive datetimes are taken as UTC."""
    if when.tzinfo is None:
        when = when.replace(tzinfo=UTC)
    return int(when.timestamp() * 1000)


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=UTC)


@dataclasses.dataclass(frozen=True)
class EngineInstance:
    """Full record of one train/deploy run (``EngineInstances.scala:21-47``)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


_SCHEMA = """
CREATE TABLE IF NOT EXISTS pio_engine_instances (
  id TEXT PRIMARY KEY, status TEXT NOT NULL,
  start_time_ms INTEGER NOT NULL, end_time_ms INTEGER NOT NULL,
  engine_id TEXT NOT NULL, engine_version TEXT NOT NULL,
  engine_variant TEXT NOT NULL, engine_factory TEXT NOT NULL,
  batch TEXT NOT NULL DEFAULT '', env TEXT NOT NULL DEFAULT '{}',
  data_source_params TEXT NOT NULL DEFAULT '',
  preparator_params TEXT NOT NULL DEFAULT '',
  algorithms_params TEXT NOT NULL DEFAULT '',
  serving_params TEXT NOT NULL DEFAULT '');
CREATE TABLE IF NOT EXISTS pio_sequences (
  name TEXT PRIMARY KEY, value INTEGER NOT NULL);
"""


class MetadataStore:
    """The engine-instance DAO over one SQLite database (WAL, so a
    training process and a query server can share the file)."""

    def __init__(self, path: str = ":memory:"):
        self._path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False, timeout=30.0)
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA busy_timeout=30000")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def gen_next(self, name: str) -> int:
        with self._lock:
            self._conn.execute(
                "INSERT INTO pio_sequences (name, value) VALUES (?, 0) "
                "ON CONFLICT(name) DO NOTHING",
                (name,),
            )
            self._conn.execute(
                "UPDATE pio_sequences SET value = value + 1 WHERE name = ?",
                (name,),
            )
            (value,) = self._conn.execute(
                "SELECT value FROM pio_sequences WHERE name = ?", (name,)
            ).fetchone()
            self._conn.commit()
            return int(value)

    def engine_instance_insert(self, inst: EngineInstance) -> str:
        iid = inst.id or f"EI-{self.gen_next('engine_instances'):08d}"
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO pio_engine_instances "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    iid,
                    inst.status,
                    _to_ms(inst.start_time),
                    _to_ms(inst.end_time),
                    inst.engine_id,
                    inst.engine_version,
                    inst.engine_variant,
                    inst.engine_factory,
                    inst.batch,
                    json.dumps(inst.env),
                    inst.data_source_params,
                    inst.preparator_params,
                    inst.algorithms_params,
                    inst.serving_params,
                ),
            )
            self._conn.commit()
        return iid

    @staticmethod
    def _row_to_engine_instance(row) -> EngineInstance:
        return EngineInstance(
            id=row[0],
            status=row[1],
            start_time=_from_ms(row[2]),
            end_time=_from_ms(row[3]),
            engine_id=row[4],
            engine_version=row[5],
            engine_variant=row[6],
            engine_factory=row[7],
            batch=row[8],
            env=json.loads(row[9]),
            data_source_params=row[10],
            preparator_params=row[11],
            algorithms_params=row[12],
            serving_params=row[13],
        )

    def engine_instance_get(self, id: str) -> Optional[EngineInstance]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_engine_instances WHERE id = ?", (id,)
            ).fetchone()
        return self._row_to_engine_instance(row) if row else None

    def engine_instance_get_all(self) -> List[EngineInstance]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM pio_engine_instances ORDER BY start_time_ms"
            ).fetchall()
        return [self._row_to_engine_instance(r) for r in rows]

    def engine_instance_get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """``getLatestCompleted`` — deploy picks this (``Console.scala:742``)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_engine_instances WHERE status = ? AND "
                "engine_id = ? AND engine_version = ? AND engine_variant = ? "
                "ORDER BY start_time_ms DESC LIMIT 1",
                (STATUS_COMPLETED, engine_id, engine_version, engine_variant),
            ).fetchone()
        return self._row_to_engine_instance(row) if row else None

    def engine_instance_update(self, inst: EngineInstance) -> bool:
        self.engine_instance_insert(inst)
        return True

    def engine_instance_delete(self, id: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM pio_engine_instances WHERE id = ?", (id,)
            )
            self._conn.commit()
            return cur.rowcount > 0


def new_engine_instance(
    engine_id: str,
    engine_version: str,
    engine_variant: str,
    engine_factory: str,
    batch: str = "",
    env: Optional[Dict[str, str]] = None,
    data_source_params: str = "",
    preparator_params: str = "",
    algorithms_params: str = "",
    serving_params: str = "",
) -> EngineInstance:
    now = utcnow()
    return EngineInstance(
        id="",
        status=STATUS_INIT,
        start_time=now,
        end_time=now,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=batch,
        env=env or {},
        data_source_params=data_source_params,
        preparator_params=preparator_params,
        algorithms_params=algorithms_params,
        serving_params=serving_params,
    )
