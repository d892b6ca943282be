"""Apps, access keys, engine manifests, engine and evaluation instances
on SQLite.

Trimmed copy of ``predictionio_tpu/storage/metadata.py``: the ``App``
and ``AccessKey`` records with their DAOs (what the Event Server
authenticates against), the ``EngineManifest`` record of a registered
engine project (``manifest_update``/``manifest_get``), the
``EngineInstance`` record, its status constants, ``new_engine_instance``
and the engine-instance table (what training and deploying need), and
the ``EvaluationInstance`` record of a ``pio eval`` run with its table
(``evaluation_instance_*``), and the ``RolloutPlan`` record of a staged
deploy with its stage constants and table (``rollout_plan_*``). The
table layout is the JAX package's, so both packages can share one
metadata file.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
import secrets
import sqlite3
import threading
from typing import Dict, List, Optional, Sequence

UTC = _dt.timezone.utc

# EngineInstance status values (CreateWorkflow.scala:245-253,
# CoreWorkflow.scala:77, Console.scala:742-780).
STATUS_INIT = "INIT"
STATUS_TRAINING = "TRAINING"
STATUS_COMPLETED = "COMPLETED"
STATUS_EVALUATING = "EVALUATING"
STATUS_EVALCOMPLETED = "EVALCOMPLETED"

# RolloutPlan stages: SHADOW and CANARY are in flight (a restarted query
# server resumes them); the other three are terminal.
ROLLOUT_SHADOW = "SHADOW"
ROLLOUT_CANARY = "CANARY"
ROLLOUT_LIVE = "LIVE"
ROLLOUT_ROLLED_BACK = "ROLLED_BACK"
ROLLOUT_ABORTED = "ABORTED"
ROLLOUT_ACTIVE_STAGES = (ROLLOUT_SHADOW, ROLLOUT_CANARY)
ROLLOUT_TERMINAL_STAGES = (ROLLOUT_LIVE, ROLLOUT_ROLLED_BACK, ROLLOUT_ABORTED)


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
class App:
    """``Apps.scala:15-30``."""

    id: int
    name: str
    description: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    """``AccessKeys.scala:17-22``; empty ``events`` allows all event names."""

    key: str
    appid: int
    events: Sequence[str] = ()


@dataclasses.dataclass(frozen=True)
class EngineManifest:
    """``EngineManifests.scala:20-35``."""

    id: str
    version: str
    name: str
    description: Optional[str] = None
    files: Sequence[str] = ()
    engine_factory: str = ""


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


@dataclasses.dataclass(frozen=True)
class RolloutPlan:
    """Durable record of one staged deploy. ``salt`` and ``percent`` are
    the whole routing function, so a restarted server resumes the same
    sticky split; ``gates`` holds the resolved ``GateConfig`` values and
    ``history`` one ``{"stage", "atMs", "reason"}`` entry a transition."""

    id: str
    stage: str
    engine_id: str
    engine_version: str
    engine_variant: str
    baseline_instance_id: str
    candidate_instance_id: str
    percent: float
    salt: str
    created_time: _dt.datetime
    updated_time: _dt.datetime
    gates: Dict[str, float] = dataclasses.field(default_factory=dict)
    history: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class EvaluationInstance:
    """Record of one evaluation run (``EvaluationInstances.scala:21-49``)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


_SCHEMA = """
CREATE TABLE IF NOT EXISTS pio_apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL,
  description TEXT);
CREATE TABLE IF NOT EXISTS pio_access_keys (
  key TEXT PRIMARY KEY, appid INTEGER NOT NULL, events TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS pio_engine_manifests (
  id TEXT NOT NULL, version TEXT NOT NULL, name TEXT NOT NULL,
  description TEXT, files TEXT NOT NULL, engine_factory TEXT NOT NULL,
  PRIMARY KEY (id, version));
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
CREATE TABLE IF NOT EXISTS pio_evaluation_instances (
  id TEXT PRIMARY KEY, status TEXT NOT NULL,
  start_time_ms INTEGER NOT NULL, end_time_ms INTEGER NOT NULL,
  evaluation_class TEXT NOT NULL DEFAULT '',
  engine_params_generator_class TEXT NOT NULL DEFAULT '',
  batch TEXT NOT NULL DEFAULT '', env TEXT NOT NULL DEFAULT '{}',
  evaluator_results TEXT NOT NULL DEFAULT '',
  evaluator_results_html TEXT NOT NULL DEFAULT '',
  evaluator_results_json TEXT NOT NULL DEFAULT '');
CREATE TABLE IF NOT EXISTS pio_sequences (
  name TEXT PRIMARY KEY, value INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS pio_rollout_plans (
  id TEXT PRIMARY KEY, stage TEXT NOT NULL,
  engine_id TEXT NOT NULL, engine_version TEXT NOT NULL,
  engine_variant TEXT NOT NULL,
  baseline_instance_id TEXT NOT NULL,
  candidate_instance_id TEXT NOT NULL,
  percent REAL NOT NULL, salt TEXT NOT NULL,
  created_ms INTEGER NOT NULL, updated_ms INTEGER NOT NULL,
  gates TEXT NOT NULL DEFAULT '{}',
  history TEXT NOT NULL DEFAULT '[]');
"""


class MetadataStore:
    """The app, access-key, manifest, engine-instance, rollout-plan and
    evaluation-instance DAOs over one SQLite database (WAL, so a training process, an Event Server and a query
    server can share the file)."""

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

    def sequence_advance_to(self, name: str, value: int) -> None:
        """Make ``gen_next(name)`` never issue a value <= ``value``: the
        replay of a logged ``gen_next`` (``storage/changefeed.py``), so
        re-applying a log suffix cannot advance the counter twice."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO pio_sequences (name, value) VALUES (?, ?) "
                "ON CONFLICT(name) DO UPDATE SET value = "
                "max(pio_sequences.value, excluded.value)",
                (name, int(value)),
            )
            self._conn.commit()

    # -- apps (Apps.scala DAO) --------------------------------------------
    def app_insert(self, app: App) -> Optional[int]:
        """Insert an app (``id`` 0 takes the next free id); None when the
        id or name is taken."""
        with self._lock:
            try:
                cur = self._conn.execute(
                    "INSERT INTO pio_apps (id, name, description) VALUES (?,?,?)",
                    (app.id if app.id else None, app.name, app.description),
                )
                self._conn.commit()
                return int(cur.lastrowid)
            except sqlite3.IntegrityError:
                return None

    def app_get(self, app_id: int) -> Optional[App]:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, name, description FROM pio_apps WHERE id = ?",
                (app_id,),
            ).fetchone()
        return App(*row) if row else None

    def app_get_by_name(self, name: str) -> Optional[App]:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, name, description FROM pio_apps WHERE name = ?",
                (name,),
            ).fetchone()
        return App(*row) if row else None

    def app_get_all(self) -> List[App]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, name, description FROM pio_apps ORDER BY id"
            ).fetchall()
        return [App(*r) for r in rows]

    def app_update(self, app: App) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE pio_apps SET name = ?, description = ? WHERE id = ?",
                (app.name, app.description, app.id),
            )
            self._conn.commit()
            return cur.rowcount > 0

    def app_delete(self, app_id: int) -> bool:
        with self._lock:
            cur = self._conn.execute("DELETE FROM pio_apps WHERE id = ?", (app_id,))
            self._conn.commit()
            return cur.rowcount > 0

    # -- access keys ------------------------------------------------------
    def access_key_insert(self, ak: AccessKey) -> Optional[str]:
        """Insert a key (an empty ``key`` is minted); None when taken."""
        key = ak.key or secrets.token_urlsafe(48)
        with self._lock:
            try:
                self._conn.execute(
                    "INSERT INTO pio_access_keys (key, appid, events) VALUES (?,?,?)",
                    (key, ak.appid, json.dumps(list(ak.events))),
                )
                self._conn.commit()
                return key
            except sqlite3.IntegrityError:
                return None

    def access_key_get(self, key: str) -> Optional[AccessKey]:
        with self._lock:
            row = self._conn.execute(
                "SELECT key, appid, events FROM pio_access_keys WHERE key = ?",
                (key,),
            ).fetchone()
        return AccessKey(row[0], row[1], tuple(json.loads(row[2]))) if row else None

    def access_key_get_by_app(self, app_id: int) -> List[AccessKey]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, appid, events FROM pio_access_keys WHERE appid = ?",
                (app_id,),
            ).fetchall()
        return [AccessKey(r[0], r[1], tuple(json.loads(r[2]))) for r in rows]

    def access_key_delete(self, key: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM pio_access_keys WHERE key = ?", (key,)
            )
            self._conn.commit()
            return cur.rowcount > 0

    # -- engine manifests -------------------------------------------------
    def manifest_update(self, m: EngineManifest, upsert: bool = True) -> bool:
        """Update a manifest; with ``upsert=False``, only overwrite an
        existing (id, version) row (``EngineManifests.update``)."""
        with self._lock:
            if not upsert:
                exists = self._conn.execute(
                    "SELECT 1 FROM pio_engine_manifests WHERE id=? AND version=?",
                    (m.id, m.version),
                ).fetchone()
                if not exists:
                    return False
            self._conn.execute(
                "INSERT OR REPLACE INTO pio_engine_manifests VALUES (?,?,?,?,?,?)",
                (m.id, m.version, m.name, m.description,
                 json.dumps(list(m.files)), m.engine_factory),
            )
            self._conn.commit()
            return True

    def manifest_get(self, id: str, version: str) -> Optional[EngineManifest]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_engine_manifests WHERE id=? AND version=?",
                (id, version),
            ).fetchone()
        if not row:
            return None
        return EngineManifest(
            id=row[0], version=row[1], name=row[2], description=row[3],
            files=tuple(json.loads(row[4])), engine_factory=row[5],
        )

    # -- engine instances -------------------------------------------------
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

    # -- rollout plans ------------------------------------------------------
    def rollout_plan_upsert(self, plan: RolloutPlan) -> str:
        """Insert or replace one plan; a blank id is minted ``RO-<hex>``
        (random, not sequential: ordering comes from ``updated_ms``)."""
        pid = plan.id or f"RO-{secrets.token_hex(6)}"
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO pio_rollout_plans "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    pid,
                    plan.stage,
                    plan.engine_id,
                    plan.engine_version,
                    plan.engine_variant,
                    plan.baseline_instance_id,
                    plan.candidate_instance_id,
                    float(plan.percent),
                    plan.salt,
                    _to_ms(plan.created_time),
                    _to_ms(plan.updated_time),
                    json.dumps(plan.gates),
                    json.dumps(list(plan.history)),
                ),
            )
            self._conn.commit()
        return pid

    @staticmethod
    def _row_to_rollout_plan(row) -> RolloutPlan:
        return RolloutPlan(
            id=row[0],
            stage=row[1],
            engine_id=row[2],
            engine_version=row[3],
            engine_variant=row[4],
            baseline_instance_id=row[5],
            candidate_instance_id=row[6],
            percent=row[7],
            salt=row[8],
            created_time=_from_ms(row[9]),
            updated_time=_from_ms(row[10]),
            gates=json.loads(row[11]),
            history=json.loads(row[12]),
        )

    def rollout_plan_get(self, id: str) -> Optional[RolloutPlan]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_rollout_plans WHERE id = ?", (id,)
            ).fetchone()
        return self._row_to_rollout_plan(row) if row else None

    def rollout_plan_get_all(self) -> List[RolloutPlan]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM pio_rollout_plans ORDER BY updated_ms DESC, id DESC"
            ).fetchall()
        return [self._row_to_rollout_plan(r) for r in rows]

    def rollout_plan_get_latest(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[RolloutPlan]:
        """The most recently updated plan of one engine tuple, any stage
        (how a restarted server learns a candidate was rolled back)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_rollout_plans WHERE "
                "engine_id = ? AND engine_version = ? AND engine_variant = ? "
                "ORDER BY updated_ms DESC LIMIT 1",
                (engine_id, engine_version, engine_variant),
            ).fetchone()
        return self._row_to_rollout_plan(row) if row else None

    def rollout_plan_get_active(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[RolloutPlan]:
        """The in-flight (SHADOW or CANARY) plan of one engine tuple: what
        a restarted query server resumes."""
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_rollout_plans WHERE stage IN (?, ?) AND "
                "engine_id = ? AND engine_version = ? AND engine_variant = ? "
                "ORDER BY updated_ms DESC LIMIT 1",
                (ROLLOUT_SHADOW, ROLLOUT_CANARY, engine_id, engine_version,
                 engine_variant),
            ).fetchone()
        return self._row_to_rollout_plan(row) if row else None

    # -- evaluation instances ---------------------------------------------
    def evaluation_instance_insert(self, inst: EvaluationInstance) -> str:
        iid = inst.id or f"EVI-{self.gen_next('evaluation_instances'):08d}"
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO pio_evaluation_instances "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (
                    iid,
                    inst.status,
                    _to_ms(inst.start_time),
                    _to_ms(inst.end_time),
                    inst.evaluation_class,
                    inst.engine_params_generator_class,
                    inst.batch,
                    json.dumps(inst.env),
                    inst.evaluator_results,
                    inst.evaluator_results_html,
                    inst.evaluator_results_json,
                ),
            )
            self._conn.commit()
        return iid

    @staticmethod
    def _row_to_evaluation_instance(row) -> EvaluationInstance:
        return EvaluationInstance(
            id=row[0],
            status=row[1],
            start_time=_from_ms(row[2]),
            end_time=_from_ms(row[3]),
            evaluation_class=row[4],
            engine_params_generator_class=row[5],
            batch=row[6],
            env=json.loads(row[7]),
            evaluator_results=row[8],
            evaluator_results_html=row[9],
            evaluator_results_json=row[10],
        )

    def evaluation_instance_get(self, id: str) -> Optional[EvaluationInstance]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM pio_evaluation_instances WHERE id = ?", (id,)
            ).fetchone()
        return self._row_to_evaluation_instance(row) if row else None

    def evaluation_instance_get_completed(self) -> List[EvaluationInstance]:
        """Completed evaluations, newest first (``Dashboard.scala``)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM pio_evaluation_instances WHERE status = ? "
                "ORDER BY start_time_ms DESC",
                (STATUS_EVALCOMPLETED,),
            ).fetchall()
        return [self._row_to_evaluation_instance(r) for r in rows]

    def evaluation_instance_update(self, inst: EvaluationInstance) -> bool:
        self.evaluation_instance_insert(inst)
        return True


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
