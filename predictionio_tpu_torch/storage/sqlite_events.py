"""SQLite-backed event store.

Copy of the JAX package's ``storage/sqlite_events.py``. The local backend
for :class:`~predictionio_tpu_torch.storage.events.EventStore`,
playing the role of the reference's HBase events backend
(``data/src/main/scala/io/prediction/data/storage/hbase/HBLEvents.scala`` /
``HBPEvents.scala``): one table per app (``events_<appId>``, the analogue of
the HBase table-per-app layout in ``HBEventsUtil.scala:54-66``), an event-time
index for range scans (the analogue of the scan builder's time-range push-down,
``HBEventsUtil.scala:280-404``), and composite event ids that embed the entity
hash, event-time millis, and a uuid — the reference's row-key scheme
(``HBEventsUtil.scala:75-123``) kept as an *id format* rather than a physical
sort order.

A bulk columnar scan path (:meth:`SqliteEventStore.scan_columnar`) returns
numpy arrays directly, feeding the training pipeline without per-event Python
object overhead — the infeed analogue of ``newAPIHadoopRDD`` region scans
(``HBPEvents.scala:58-98``).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import os
import sqlite3
import threading
from typing import Iterator, Optional, Sequence

from .data_map import DataMap
from .event import UTC, Event, to_millis as _ms, validate_event
from .events import EventFilter, EventStore

_SCHEMA = """
CREATE TABLE IF NOT EXISTS "{table}" (
  event_id TEXT PRIMARY KEY,
  event TEXT NOT NULL,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  target_entity_type TEXT,
  target_entity_id TEXT,
  properties TEXT NOT NULL,
  event_time_ms INTEGER NOT NULL,
  event_time_offset_s INTEGER NOT NULL DEFAULT 0,
  tags TEXT NOT NULL DEFAULT '[]',
  pr_id TEXT,
  creation_time_ms INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS "idx_{table}_time" ON "{table}" (event_time_ms);
CREATE INDEX IF NOT EXISTS "idx_{table}_entity"
  ON "{table}" (entity_type, entity_id, event_time_ms);
"""


def _from_ms(ms: int, offset_s: int) -> _dt.datetime:
    tz = _dt.timezone(_dt.timedelta(seconds=offset_s)) if offset_s else UTC
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=tz)


def make_event_id(event: Event) -> str:
    """Composite id: md5(entityType-entityId)[:16] ∥ millis ∥ uuid-low.

    Same information content as the reference row key
    (``HBEventsUtil.scala:90-102``): dedup by (entity, time, uniquifier) and
    self-describing enough to locate the owning entity from the id alone.
    """
    md5 = hashlib.md5(
        f"{event.entity_type}-{event.entity_id}".encode()
    ).hexdigest()[:16]
    millis = _ms(event.event_time) & 0xFFFFFFFFFFFFFFFF
    # raw urandom instead of uuid4: same 64 bits of uniquifier entropy
    # without UUID-object construction (bulk-ingest hot path)
    uuid_low = int.from_bytes(os.urandom(8), "big")
    return f"{md5}{millis:016x}{uuid_low:016x}"


class SqliteEventStore(EventStore):
    """Event store over a single SQLite database file (or ``:memory:``)."""

    def __init__(self, path: str = ":memory:", namespace: str = "pio_event"):
        self._path = path
        self._namespace = namespace
        self._lock = threading.RLock()
        if path != ":memory:":
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")

    def _table(self, app_id: int) -> str:
        # Analogue of "<namespace>:events_<appId>" (HBEventsUtil.scala:54).
        return f"{self._namespace}_events_{int(app_id)}"

    def _ensure_table(self, app_id: int) -> str:
        table = self._table(app_id)
        with self._lock:
            self._conn.executescript(_SCHEMA.format(table=table))
        return table

    # -- lifecycle --------------------------------------------------------
    def init(self, app_id: int) -> bool:
        self._ensure_table(app_id)
        return True

    def remove(self, app_id: int) -> bool:
        table = self._table(app_id)
        with self._lock:
            self._conn.execute(f'DROP TABLE IF EXISTS "{table}"')
            self._conn.commit()
        return True

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- point ops --------------------------------------------------------
    @staticmethod
    def _event_row(event: Event, event_id: str) -> tuple:
        offset = event.event_time.utcoffset() or _dt.timedelta(0)
        return (
            event_id,
            event.event,
            event.entity_type,
            event.entity_id,
            event.target_entity_type,
            event.target_entity_id,
            json.dumps(event.properties.to_dict()),
            _ms(event.event_time),
            int(offset.total_seconds()),
            json.dumps(list(event.tags)),
            event.pr_id,
            _ms(event.creation_time),
        )

    def insert(self, event: Event, app_id: int) -> str:
        validate_event(event)
        table = self._ensure_table(app_id)
        event_id = event.event_id or make_event_id(event)
        with self._lock:
            self._conn.execute(
                f'INSERT OR REPLACE INTO "{table}" VALUES (?,?,?,?,?,?,?,?,?,?,?,?)',
                self._event_row(event, event_id),
            )
            self._conn.commit()
        return event_id

    def write(self, events: Sequence[Event], app_id: int) -> None:
        """Bulk load in one transaction (the ``PEvents.write`` fast path)."""
        table = self._ensure_table(app_id)
        rows = []
        for e in events:
            validate_event(e)
            rows.append(self._event_row(e, e.event_id or make_event_id(e)))
        with self._lock:
            self._conn.executemany(
                f'INSERT OR REPLACE INTO "{table}" VALUES (?,?,?,?,?,?,?,?,?,?,?,?)',
                rows,
            )
            self._conn.commit()

    def _row_to_event(self, row) -> Event:
        return Event(
            event_id=row[0],
            event=row[1],
            entity_type=row[2],
            entity_id=row[3],
            target_entity_type=row[4],
            target_entity_id=row[5],
            properties=DataMap(json.loads(row[6])),
            event_time=_from_ms(row[7], row[8]),
            tags=tuple(json.loads(row[9])),
            pr_id=row[10],
            creation_time=_from_ms(row[11], 0),
        )

    def get(self, event_id: str, app_id: int) -> Optional[Event]:
        table = self._ensure_table(app_id)
        with self._lock:
            cur = self._conn.execute(
                f'SELECT * FROM "{table}" WHERE event_id = ?', (event_id,)
            )
            row = cur.fetchone()
        return self._row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int) -> bool:
        table = self._ensure_table(app_id)
        with self._lock:
            cur = self._conn.execute(
                f'DELETE FROM "{table}" WHERE event_id = ?', (event_id,)
            )
            self._conn.commit()
            return cur.rowcount > 0

    # -- bulk scan --------------------------------------------------------
    def _build_query(self, table: str, f: EventFilter, columns: str = "*"):
        clauses, params = [], []
        if f.start_time is not None:
            clauses.append("event_time_ms >= ?")
            params.append(_ms(f.start_time))
        if f.until_time is not None:
            clauses.append("event_time_ms < ?")
            params.append(_ms(f.until_time))
        if f.entity_type is not None:
            clauses.append("entity_type = ?")
            params.append(f.entity_type)
        if f.entity_id is not None:
            clauses.append("entity_id = ?")
            params.append(f.entity_id)
        if f.event_names is not None:
            marks = ",".join("?" * len(f.event_names))
            clauses.append(f"event IN ({marks})")
            params.extend(f.event_names)
        if f.has_target_entity_type is True:
            clauses.append("target_entity_type IS NOT NULL")
        if f.has_target_entity_type is False:
            clauses.append("target_entity_type IS NULL")
        if f.target_entity_type is not None:
            clauses.append("target_entity_type = ?")
            params.append(f.target_entity_type)
        if f.has_target_entity_id is True:
            clauses.append("target_entity_id IS NOT NULL")
        if f.has_target_entity_id is False:
            clauses.append("target_entity_id IS NULL")
        if f.target_entity_id is not None:
            clauses.append("target_entity_id = ?")
            params.append(f.target_entity_id)
        where = f"WHERE {' AND '.join(clauses)}" if clauses else ""
        order = "DESC" if f.reversed else "ASC"
        sql = (
            f'SELECT {columns} FROM "{table}" {where} '
            f"ORDER BY event_time_ms {order}, event_id {order}"
        )
        if f.limit is not None and f.limit >= 0:
            sql += " LIMIT ?"
            params.append(f.limit)
        return sql, params

    def find(
        self, app_id: int, filter: Optional[EventFilter] = None
    ) -> Iterator[Event]:
        table = self._ensure_table(app_id)
        f = filter or EventFilter()
        sql, params = self._build_query(table, f)

        def stream() -> Iterator[Event]:
            # Stream in batches so million-event scans never materialize the
            # whole table; the lock is held only per batch.
            with self._lock:
                cursor = self._conn.execute(sql, params)
            while True:
                with self._lock:
                    rows = cursor.fetchmany(1000)
                if not rows:
                    return
                for r in rows:
                    yield self._row_to_event(r)

        return stream()

    def scan_columnar(self, app_id: int, filter: Optional[EventFilter] = None):
        """Bulk scan returning column dict of python lists / numpy arrays.

        The training-path fast lane: entity ids, target ids, event names and a
        float property column are materialized without building per-event
        objects, ready for BiMap indexing + device infeed.
        """
        import numpy as np

        table = self._ensure_table(app_id)
        f = filter or EventFilter()
        sql, params = self._build_query(
            table,
            f,
            columns="event, entity_type, entity_id, target_entity_type, "
            "target_entity_id, properties, event_time_ms",
        )
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        return self._rows_to_cols(rows)

    @staticmethod
    def _rows_to_cols(rows) -> dict:
        import numpy as np

        return {
            "event": [r[0] for r in rows],
            "entity_type": [r[1] for r in rows],
            "entity_id": [r[2] for r in rows],
            "target_entity_type": [r[3] for r in rows],
            "target_entity_id": [r[4] for r in rows],
            "properties": [json.loads(r[5]) for r in rows],
            "event_time_ms": np.asarray([r[6] for r in rows], dtype=np.int64),
        }

    def scan_columnar_iter(
        self,
        app_id: int,
        filter: Optional[EventFilter] = None,
        chunk_rows: int = 1_000_000,
    ):
        """Chunked columnar scan (``EventStore.scan_columnar_iter`` fast
        path): one cursor, ``fetchmany`` batches, no per-event objects."""
        table = self._ensure_table(app_id)
        f = filter or EventFilter()
        sql, params = self._build_query(
            table,
            f,
            columns="event, entity_type, entity_id, target_entity_type, "
            "target_entity_id, properties, event_time_ms",
        )
        with self._lock:
            cursor = self._conn.execute(sql, params)
        while True:
            with self._lock:
                rows = cursor.fetchmany(chunk_rows)
            if not rows:
                return
            yield self._rows_to_cols(rows)
