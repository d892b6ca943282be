"""Changefeed: sequence-numbered mutation recording and idempotent replay.

Trimmed copy of ``predictionio_tpu/storage/changefeed.py`` for a single
primary. The storage server routes every mutating op through a
:class:`Changefeed`: the op is applied to the backing store and appended
to the durable :class:`~.oplog.OpLog` under one lock, so the log is a
total order of the store's mutations. The assigned sequence number rides
back to the client in the ``X-PIO-Seq`` response header.

Logged ops are **resolved**: every event carries its final ``eventId``
(minted ids are random, so a replay must ship them), metadata inserts
carry their assigned ids, and ``gen_next`` ships the value it produced
(replayed as an advance-to-at-least). :func:`apply_op` is therefore safe
to re-run over any suffix of the log; the ops are the JAX package's, so
either package replays the other's log.

The store apply happens before the log append, inside the lock: a crash
in between leaves the op applied but absent from the feed, and the
client was never acked. Partition ownership checks (``WrongPartition``)
and the router's epoch filter belong to a partitioned store and the
serving fleet (ROADMAP.md queue 1 items 12 and 13).
"""

from __future__ import annotations

import base64
import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

from .event import Event
from .model_store import Model
from .oplog import OpLog
from .sqlite_events import make_event_id
from .wire import decode, encode

#: response header carrying the seq assigned to a mutating op
SEQ_HEADER = "X-PIO-Seq"
#: request header: the minimum applied seq a replica read requires
MIN_SEQ_HEADER = "X-PIO-Min-Seq"

#: MetadataStore methods that mutate (the complement of the read RPCs):
#: an explicit list, so replicating a future method is a decision
METADATA_MUTATING_METHODS = frozenset({
    "gen_next",
    "app_insert",
    "app_update",
    "app_delete",
    "access_key_insert",
    "access_key_delete",
    "manifest_update",
    "engine_instance_insert",
    "engine_instance_update",
    "engine_instance_delete",
    "evaluation_instance_insert",
    "evaluation_instance_update",
    "rollout_plan_upsert",
})


def _resolve_events(events: Sequence[Event]) -> List[Event]:
    """Mint ids for events that lack one (the stores' own mint), so the
    logged op replays to identical records."""
    return [e if e.event_id is not None
            else dataclasses.replace(e, event_id=make_event_id(e)) for e in events]


class Changefeed:
    """Primary-side recorder: apply, then log, under one total-order lock."""

    def __init__(self, oplog: OpLog, events, metadata, models):
        self.oplog = oplog
        self._events = events
        self._metadata = metadata
        self._models = models
        # two concurrent upserts of one key must reach the log in the
        # order they reached the store; reads never take this lock
        self._lock = threading.Lock()

    @property
    def last_seq(self) -> int:
        return self.oplog.last_seq

    # -- events -----------------------------------------------------------
    def insert_event(self, event: Event, app_id: int) -> Tuple[str, int]:
        with self._lock:
            event_id = self._events.insert(event, app_id)
            d = event.to_json_dict()
            d["eventId"] = event_id
            seq = self.oplog.append({"kind": "event_insert", "app": int(app_id), "event": d})
            return event_id, seq

    def write_events(self, events: Sequence[Event], app_id: int, fresh: bool) -> int:
        """Bulk write, keeping the store's fast paths: runs of id-less
        events (fresh once minted) take ``write_new``, caller-given ids
        the upsert ``insert``."""
        events = list(events)
        resolved = _resolve_events(events)
        with self._lock:
            if fresh:
                self._events.write_new(resolved, app_id)
            else:
                run: List[Event] = []
                for orig, res in zip(events, resolved):
                    if orig.event_id is None:
                        run.append(res)
                        continue
                    if run:
                        self._events.write_new(run, app_id)
                        run = []
                    self._events.insert(orig, app_id)
                if run:
                    self._events.write_new(run, app_id)
            return self.oplog.append({"kind": "event_write", "app": int(app_id),
                                      "events": [e.to_json_dict() for e in resolved]})

    def delete_event(self, event_id: str, app_id: int) -> Tuple[bool, Optional[int]]:
        with self._lock:
            if not self._events.delete(event_id, app_id):
                return False, None  # no state change, nothing to ship
            seq = self.oplog.append({"kind": "event_delete", "app": int(app_id),
                                     "eventId": event_id})
            return True, seq

    def init_app(self, app_id: int) -> Tuple[bool, int]:
        with self._lock:
            ok = self._events.init(app_id)
            return ok, self.oplog.append({"kind": "event_init", "app": int(app_id)})

    def remove_app(self, app_id: int) -> Tuple[bool, int]:
        with self._lock:
            ok = self._events.remove(app_id)
            return ok, self.oplog.append({"kind": "event_remove", "app": int(app_id)})

    # -- metadata ---------------------------------------------------------
    def metadata_rpc(self, method: str, args: list):
        """Run one metadata RPC, logging a mutation's resolved op.
        Returns ``(result, seq or None)``: None for a read, and for a
        call that changed nothing (failed insert, no-row update)."""
        if method not in METADATA_MUTATING_METHODS:
            return getattr(self._metadata, method)(*args), None
        with self._lock:
            if method == "gen_next":
                value = self._metadata.gen_next(args[0])
                seq = self.oplog.append({"kind": "meta_seq", "name": args[0], "value": value})
                return value, seq
            result = getattr(self._metadata, method)(*args)
            logged = self._resolve_meta_args(method, args, result)
            if logged is None:
                return result, None
            seq = self.oplog.append({"kind": "meta", "method": method,
                                     "args": [encode(a) for a in logged]})
            return result, seq

    @staticmethod
    def _resolve_meta_args(method: str, args: list, result):
        """The args to log with store-assigned ids substituted in; None
        when the call was a no-op."""
        if method in ("app_insert", "access_key_insert"):
            if result is None:
                return None  # IntegrityError path: no state change
            field = "id" if method == "app_insert" else "key"
            return [dataclasses.replace(args[0], **{field: result})] + args[1:]
        if method in ("engine_instance_insert", "evaluation_instance_insert",
                      "rollout_plan_upsert"):
            return [dataclasses.replace(args[0], id=result)] + args[1:]
        if result is False:
            return None  # update/delete that matched no row
        return args

    # -- models -----------------------------------------------------------
    def put_model(self, model: Model) -> int:
        with self._lock:
            self._models.insert(model)
            return self.oplog.append({"kind": "model_put", "id": model.id,
                                      "data": base64.b64encode(model.models).decode("ascii")})

    def delete_model(self, model_id: str) -> int:
        with self._lock:
            self._models.delete(model_id)
            return self.oplog.append({"kind": "model_delete", "id": model_id})


def apply_op(op: dict, events, metadata, models) -> None:
    """Replay one logged op against local stores. Idempotent: every op is
    an upsert, delete or advance keyed on an id the op carries."""
    kind = op.get("kind")
    if kind == "event_insert":
        events.insert(Event.from_json_dict(op["event"]), op["app"])
    elif kind == "event_write":
        events.write([Event.from_json_dict(d) for d in op["events"]], op["app"])
    elif kind == "event_delete":
        events.delete(op["eventId"], op["app"])
    elif kind == "event_init":
        events.init(op["app"])
    elif kind == "event_remove":
        events.remove(op["app"])
    elif kind == "meta_seq":
        metadata.sequence_advance_to(op["name"], int(op["value"]))
    elif kind == "meta":
        method = op["method"]
        if method not in METADATA_MUTATING_METHODS:
            raise ValueError(f"refusing to replay non-mutating RPC {method!r}")
        getattr(metadata, method)(*[decode(a) for a in op["args"]])
    elif kind == "model_put":
        models.insert(Model(id=op["id"], models=base64.b64decode(op["data"])))
    elif kind == "model_delete":
        models.delete(op["id"])
    else:
        raise ValueError(f"unknown changefeed op kind {kind!r}")
