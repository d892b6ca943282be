"""Native (C++) event store backend.

Trimmed copy of the JAX package's ``storage/native_events.py``: each app
gets one append-only log file managed by the ``eventlog`` native library
(``native/eventlog.cc``, ``native/ratings.cc``) — fixed numeric record
headers scanned with mmap at memory bandwidth, hashed predicate
push-down for entity/event/target/time filters, tombstone deletes, and
the training infeed's ratings scan in C++ (:meth:`NativeEventStore.
scan_ratings`). This plays the role of the reference's HBase backend
(``data/src/main/scala/io/prediction/data/storage/hbase/HBLEvents.scala``,
``HBPEvents.scala``): the native scan is the regionserver-side filter
push-down, the JSON payload decode in Python is the client-side
``Result``→``Event`` codec (``HBEventsUtil.scala:138-273``).

Not ported: the JAX package's per-writer segment files (``writer_id``,
``PIO_NATIVE_WRITER_ID``); every writer appends to the app's one log
under the library's lock (ROADMAP.md).

Hash prefilters may (with ~2^-64 probability) pass a colliding record; every
decoded event is re-checked against the exact :class:`EventFilter`, so query
results are always exact.

Durability contract: appends are acknowledged once in the OS page cache and
fdatasync'd on a cadence (every ``_SYNC_EVERY`` appends, after each bulk
``write()`` batch, and on ``close()``) — a power failure can drop the last
few acked single-event inserts, slightly weaker than the SQLite backend's
per-transaction durability (torn tails are truncated on reopen, so the log
stays *consistent* either way). Tombstone suppression matches on the
64-bit FNV-1a id hash only: two *distinct* event ids colliding could let a
delete/upsert of one suppress the other during scans. At ~2^-64 per id
pair this is accepted; callers needing exactness across deletes should use
the SQLite backend.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import mmap
import os
import shutil
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..native import load_library
from .bimap import _fnv1a64_batch
from .event import Event, to_millis as _ms, validate_event
from .events import EventFilter, EventStore
from .sqlite_events import make_event_id

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1

#: fdatasync the log after this many un-synced appends (see module
#: docstring's durability contract).
_SYNC_EVERY = 256

_LOG = "events.log"


def _lib() -> ctypes.CDLL:
    lib = load_library("eventlog")  # sources come from native.LIBRARIES
    if not getattr(lib, "_pio_configured", False):
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        lib.evlog_open.restype = vp
        lib.evlog_open.argtypes = [ctypes.c_char_p]
        lib.evlog_close.restype = None
        lib.evlog_close.argtypes = [vp]
        lib.evlog_count.restype = i64
        lib.evlog_count.argtypes = [vp]
        lib.evlog_sync.restype = ctypes.c_int
        lib.evlog_sync.argtypes = [vp]
        lib.evlog_fnv1a64.restype = u64
        lib.evlog_fnv1a64.argtypes = [ctypes.c_char_p, i64]
        lib.evlog_append.restype = i64
        lib.evlog_append.argtypes = [
            vp, ctypes.c_uint32, i64, i64, u64, u64, u64, u64, u64, u64,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.evlog_append_batch.restype = i64
        lib.evlog_append_batch.argtypes = [
            vp, i64, vp, vp,  # count, time arrays
            vp, vp, vp, vp, vp, vp,  # hashes
            ctypes.c_char_p, vp,  # payload blob + ends
        ]
        lib.evlog_scan.restype = i64
        lib.evlog_scan.argtypes = [
            vp, i64, i64, u64, u64, vp, ctypes.c_int32, u64, u64,
            ctypes.c_int32, vp, vp, vp, vp, i64,
        ]
        lib.evlog_get.restype = ctypes.c_int32
        lib.evlog_get.argtypes = [vp, u64, vp, vp]
        lib.evlog_ratings_scan.restype = vp
        lib.evlog_ratings_scan.argtypes = [
            vp, vp, vp, vp, ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p,
            vp, vp,
        ]
        for fn in ("evlog_ratings_n_users", "evlog_ratings_n_items",
                   "evlog_ratings_user_pool_bytes",
                   "evlog_ratings_item_pool_bytes"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [vp]
        lib.evlog_ratings_fill.restype = None
        lib.evlog_ratings_fill.argtypes = [vp, vp, vp, vp]
        for fn in ("evlog_ratings_user_pool_fill", "evlog_ratings_item_pool_fill"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [vp, vp, vp]
        lib.evlog_ratings_free.restype = None
        lib.evlog_ratings_free.argtypes = [vp]
        lib._pio_configured = True
    return lib


def _fnv(text: str) -> int:
    data = text.encode("utf-8")
    return int(_lib().evlog_fnv1a64(data, len(data)))


class NativeScanUnsupported(ValueError):
    """The native ratings scan declines this workload (value rules that
    read more than one property); the caller falls back to the generic —
    always exact — scan path. Distinct from plain ValueError, which
    signals bad data and must propagate."""


class NativeEventStore(EventStore):
    """Event store over per-app native append-only logs
    (``<root>/app_<id>/events.log``)."""

    def __init__(self, root: str):
        self._root = root
        self._lib = _lib()
        self._handles: Dict[int, int] = {}
        self._unsynced: Dict[int, int] = {}
        self._lock = threading.RLock()
        os.makedirs(root, exist_ok=True)

    def _note_append(self, app_id: int, h: int) -> None:
        """Durability cadence: fdatasync after every ``_SYNC_EVERY``
        appends (the batch paths sync explicitly as well)."""
        with self._lock:
            n = self._unsynced.get(app_id, 0) + 1
            if n >= _SYNC_EVERY:
                self._lib.evlog_sync(h)
                n = 0
            self._unsynced[app_id] = n

    def sync(self, app_id: Optional[int] = None) -> None:
        """fdatasync one app's open log (or all open logs)."""
        with self._lock:
            for aid, h in list(self._handles.items()):
                if app_id is None or aid == app_id:
                    self._lib.evlog_sync(h)
                    self._unsynced[aid] = 0

    def _app_dir(self, app_id: int) -> str:
        return os.path.join(self._root, f"app_{int(app_id)}")

    def _log_path(self, app_id: int) -> str:
        return os.path.join(self._app_dir(app_id), _LOG)

    def _handle(self, app_id: int, create: bool = False) -> Optional[int]:
        with self._lock:
            h = self._handles.get(app_id)
            if h:
                return h
            path = self._log_path(app_id)
            if not os.path.exists(path) and not create:
                return None
            os.makedirs(os.path.dirname(path), exist_ok=True)
            h = self._lib.evlog_open(path.encode())
            if not h:
                raise OSError(f"evlog_open failed for {path}")
            self._handles[app_id] = h
            return h

    # -- lifecycle --------------------------------------------------------
    def init(self, app_id: int) -> bool:
        self._handle(app_id, create=True)
        return True

    def remove(self, app_id: int) -> bool:
        with self._lock:
            h = self._handles.pop(app_id, None)
            if h:
                self._lib.evlog_close(h)
            self._unsynced.pop(app_id, None)
            shutil.rmtree(self._app_dir(app_id), ignore_errors=True)
        return True

    def close(self) -> None:
        with self._lock:
            for h in self._handles.values():
                self._lib.evlog_sync(h)
                self._lib.evlog_close(h)
            self._handles.clear()
            self._unsynced.clear()

    def write(self, events, app_id: int) -> None:
        """Bulk write; the batch is fdatasync'd once at the end (the
        HBase ``flushCommits`` analogue; ``HBPEvents.scala:166-184``).

        Runs of events WITHOUT explicit ids take the native batch append —
        one lock acquisition + one ``write(2)`` for the whole run
        (``evlog_append_batch``). Events WITH explicit ids need the
        tombstone-first upsert and go through :meth:`insert`; runs are
        flushed in input order so append order is preserved exactly."""
        try:
            run: list = []
            for e in events:
                if e.event_id is None:
                    run.append(e)
                    continue
                if run:
                    self._write_batch(run, app_id)
                    run = []
                self.insert(e, app_id)
            if run:
                self._write_batch(run, app_id)
        finally:
            # sync even on a mid-batch failure: records appended before the
            # error are acked durably, keeping the "last few single
            # inserts" durability bound
            self.sync(app_id)

    def write_new(self, events, app_id: int) -> None:
        """Batch append for caller-guaranteed-fresh events: pre-assigned
        ids skip the tombstone-first upsert (the batch ingestion route's
        path — ids are minted for the response before the write)."""
        events = list(events)
        if events:
            self._write_batch(events, app_id)
        self.sync(app_id)

    def _write_batch(self, events, app_id: int) -> None:
        """One native batch append (one lock + one ``write(2)``) of fresh
        inserts: the event's own id when present (``write_new``'s
        freshness contract), else a minted one. Every string of the batch
        is hashed in one native call (salt 0 = ``evlog_fnv1a64``)."""
        n = len(events)
        times = np.empty(n, dtype=np.int64)
        ctimes = np.empty(n, dtype=np.int64)
        has_target = np.empty(n, dtype=bool)
        # per event [etype, entity_key, event, event_id], then per
        # target-bearing event [ttype, target_key]
        strings: list = []
        payloads: list = []
        for i, event in enumerate(events):
            validate_event(event)
            event_id = event.event_id or make_event_id(event)
            d = event.to_json_dict()
            d["eventId"] = event_id
            payloads.append(json.dumps(d).encode("utf-8"))
            times[i] = _ms(event.event_time)
            ctimes[i] = _ms(event.creation_time)
            has_target[i] = event.target_entity_type is not None
            strings += [
                event.entity_type,
                f"{event.entity_type}\x00{event.entity_id}",
                event.event,
                event_id,
            ]
        for event in events:
            if event.target_entity_type is not None:
                strings += [
                    event.target_entity_type,
                    f"{event.target_entity_type}\x00{event.target_entity_id}",
                ]
        hashes = _fnv1a64_batch(strings)
        base = hashes[: 4 * n].reshape(n, 4)
        etype_h, entity_h, event_h, id_h = (
            np.ascontiguousarray(base[:, j]) for j in range(4)
        )
        ttype_h = np.zeros(n, dtype=np.uint64)
        target_h = np.zeros(n, dtype=np.uint64)
        if has_target.any():
            tpairs = hashes[4 * n:].reshape(-1, 2)
            ttype_h[has_target] = tpairs[:, 0]
            target_h[has_target] = tpairs[:, 1]
        blob = b"".join(payloads)
        ends = np.cumsum([len(p) for p in payloads], dtype=np.int64)
        rc = self._lib.evlog_append_batch(
            self._handle(app_id, create=True), n,
            times.ctypes.data, ctimes.ctypes.data,
            etype_h.ctypes.data, entity_h.ctypes.data, event_h.ctypes.data,
            ttype_h.ctypes.data, target_h.ctypes.data, id_h.ctypes.data,
            blob, ends.ctypes.data,
        )
        if rc < 0:
            raise OSError(f"evlog_append_batch failed: errno {-rc}")

    # -- point ops --------------------------------------------------------
    def insert(self, event: Event, app_id: int) -> str:
        validate_event(event)
        event_id = event.event_id or make_event_id(event)
        h = self._handle(app_id, create=True)
        if event.event_id is not None:
            # Upsert semantics to match the SQLite backend's INSERT OR
            # REPLACE on event_id: a tombstone first kills any earlier record
            # with this id (scans are order-sensitive, so the fresh record
            # appended after it stays live). Harmless no-op for unseen ids.
            tomb = event_id.encode("utf-8")
            toff = self._lib.evlog_append(
                h, 1, _INT64_MIN, 0, 0, 0, 0, 0, 0, _fnv(event_id),
                tomb, len(tomb),
            )
            if toff < 0:
                # an unrecorded tombstone would leave duplicate live records
                raise OSError(f"evlog_append (upsert tombstone) failed: errno {-toff}")
        stored = dataclasses.replace(event, event_id=event_id)
        payload = json.dumps(stored.to_json_dict()).encode("utf-8")
        tt, ti = event.target_entity_type, event.target_entity_id
        off = self._lib.evlog_append(
            h, 0, _ms(event.event_time), _ms(event.creation_time),
            _fnv(event.entity_type),
            _fnv(f"{event.entity_type}\x00{event.entity_id}"),
            _fnv(event.event),
            _fnv(tt) if tt is not None else 0,
            _fnv(f"{tt}\x00{ti}") if tt is not None else 0,
            _fnv(event_id), payload, len(payload),
        )
        if off < 0:
            raise OSError(f"evlog_append failed: errno {-off}")
        self._note_append(app_id, h)
        return event_id

    def get(self, event_id: str, app_id: int) -> Optional[Event]:
        h = self._handle(app_id)
        if h is None:
            return None
        out_off = ctypes.c_int64()
        out_len = ctypes.c_int64()
        found = self._lib.evlog_get(
            h, _fnv(event_id), ctypes.byref(out_off), ctypes.byref(out_len)
        )
        if found != 1:
            return None  # absent, or the latest record is a tombstone
        event = self._decode_one(app_id, out_off.value, out_len.value)
        # exact-id check guards against id-hash collisions
        return event if event is not None and event.event_id == event_id else None

    def delete(self, event_id: str, app_id: int) -> bool:
        if self.get(event_id, app_id) is None:
            return False
        h = self._handle(app_id, create=True)
        payload = event_id.encode("utf-8")
        off = self._lib.evlog_append(
            h, 1, _INT64_MIN, 0, 0, 0, 0, 0, 0, _fnv(event_id),
            payload, len(payload),
        )
        if off >= 0:
            self._note_append(app_id, h)
        return off >= 0

    # -- bulk scan --------------------------------------------------------
    def _scan(
        self, app_id: int, f: EventFilter
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Index scan of the app's log: (offsets, lengths, event times) of
        the live records that pass the hashed prefilter, in (event_time,
        offset) order; None when the app has no log."""
        h = self._handle(app_id)
        if h is None:
            return None
        start = _ms(f.start_time) if f.start_time else _INT64_MIN
        until = _ms(f.until_time) if f.until_time else _INT64_MAX
        etype = _fnv(f.entity_type) if f.entity_type else 0
        entity = (
            _fnv(f"{f.entity_type}\x00{f.entity_id}")
            if f.entity_type and f.entity_id
            else 0
        )
        if f.event_names:
            ev_hashes = np.array([_fnv(n) for n in f.event_names], dtype=np.uint64)
            ev_ptr, ev_n = ev_hashes.ctypes.data, len(ev_hashes)
        else:
            ev_hashes, ev_ptr, ev_n = None, None, 0
        ttype = _fnv(f.target_entity_type) if f.target_entity_type else 0
        target = (
            _fnv(f"{f.target_entity_type}\x00{f.target_entity_id}")
            if f.target_entity_type and f.target_entity_id
            else 0
        )
        has_target = -1
        if f.has_target_entity_type is not None:
            has_target = 1 if f.has_target_entity_type else 0

        # Start with a bounded buffer; the n > cap retry below grows it to
        # the exact match count (one extra scan worst-case) instead of
        # allocating record-count-sized buffers for selective filters.
        cap = min(max(1024, int(self._lib.evlog_count(h))), 65536)
        while True:
            out_off = np.empty(cap, dtype=np.int64)
            out_len = np.empty(cap, dtype=np.int64)
            out_time = np.empty(cap, dtype=np.int64)
            out_id = np.empty(cap, dtype=np.uint64)
            n = self._lib.evlog_scan(
                h, start, until, etype, entity, ev_ptr, ev_n, ttype, target,
                has_target, out_off.ctypes.data, out_len.ctypes.data,
                out_time.ctypes.data, out_id.ctypes.data, cap,
            )
            if n < 0:
                raise OSError(f"evlog_scan failed: errno {-n}")
            if n <= cap:
                return out_off[:n], out_len[:n], out_time[:n]
            cap = int(n)

    def _decode_one(self, app_id: int, off: int, length: int) -> Optional[Event]:
        with open(self._log_path(app_id), "rb") as fh:
            fh.seek(off)
            data = fh.read(length)
        try:
            return Event.from_json_dict(json.loads(data))
        except (ValueError, TypeError, KeyError):
            return None

    def find(
        self, app_id: int, filter: Optional[EventFilter] = None
    ) -> Iterator[Event]:
        f = filter or EventFilter()
        scan = self._scan(app_id, f)
        if scan is None:
            return iter(())
        offs, lens, _times = scan
        return self._decode_iter(app_id, f, offs, lens)

    @staticmethod
    def _dict_matches(f: EventFilter, obj: dict) -> bool:
        """Exact re-check of the string predicates on the raw wire dict —
        the hash-collision guard of :meth:`find` without constructing Event
        objects (time bounds were already applied exactly by the native scan
        on the stored millis)."""
        if f.entity_type is not None and obj.get("entityType") != f.entity_type:
            return False
        if f.entity_id is not None and obj.get("entityId") != f.entity_id:
            return False
        if f.event_names is not None and obj.get("event") not in set(f.event_names):
            return False
        tt = obj.get("targetEntityType")
        if f.has_target_entity_type is not None and (
            f.has_target_entity_type != (tt is not None)
        ):
            return False
        if f.target_entity_type is not None and tt != f.target_entity_type:
            return False
        ti = obj.get("targetEntityId")
        if f.has_target_entity_id is not None and (
            f.has_target_entity_id != (ti is not None)
        ):
            return False
        if f.target_entity_id is not None and ti != f.target_entity_id:
            return False
        return True

    def scan_ratings(self, app_id: int, value_rules: dict):
        """Full DataSource inner loop in C++ (``native/ratings.cc``): one
        pass over the log producing dense index/value arrays plus the
        unique-id lists — per-event Python objects are never created.

        ``value_rules`` maps event name → property name (str) or fixed
        float, with at most one distinct property name across rules (the
        recommendation template needs one). Returns
        ``(users_i32, items_i32, vals_f32, user_ids, item_ids)`` in
        (event_time, offset) order — the index assignment of the generic
        chunked path over the same log. Raises
        :class:`NativeScanUnsupported` when the rules read more than one
        property name (callers fall back to the generic path) and
        ValueError when an event lacks its property."""
        prop_names = {r for r in value_rules.values() if isinstance(r, str)}
        if len(prop_names) > 1:
            raise NativeScanUnsupported(
                f"native ratings scan supports one property name, got "
                f"{sorted(prop_names)}"
            )
        prop_name = next(iter(prop_names), "")
        h = self._handle(app_id)
        if h is None:
            return (
                np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), [], [],
            )
        names = list(value_rules)
        hashes = np.asarray([_fnv(nm) for nm in names], dtype=np.uint64)
        is_prop = np.asarray(
            [1 if isinstance(value_rules[nm], str) else 0 for nm in names],
            dtype=np.int32,
        )
        fixed = np.asarray(
            [0.0 if isinstance(value_rules[nm], str) else float(value_rules[nm])
             for nm in names],
            dtype=np.float64,
        )
        names_buf = b"".join(nm.encode("utf-8") + b"\0" for nm in names)
        out_n = ctypes.c_int64(0)
        out_bad = ctypes.c_int64(0)
        res = self._lib.evlog_ratings_scan(
            h, hashes.ctypes.data, is_prop.ctypes.data, fixed.ctypes.data,
            len(names), names_buf, prop_name.encode("utf-8"),
            ctypes.byref(out_n), ctypes.byref(out_bad),
        )
        if not res:
            raise OSError("evlog_ratings_scan failed (mmap)")
        try:
            if out_bad.value:
                raise ValueError(
                    f"{out_bad.value} events missing required property "
                    f"{prop_name!r} (or malformed payloads)"
                )
            count = out_n.value
            users = np.empty(count, dtype=np.int32)
            items = np.empty(count, dtype=np.int32)
            vals = np.empty(count, dtype=np.float32)
            if count:
                self._lib.evlog_ratings_fill(
                    res, users.ctypes.data, items.ctypes.data, vals.ctypes.data
                )

            def pool(n_fn, bytes_fn, fill_fn):
                n_ids = n_fn(res)
                buf = np.empty(bytes_fn(res), dtype=np.uint8)
                ends = np.empty(n_ids, dtype=np.int64)
                if n_ids:
                    fill_fn(res, buf.ctypes.data, ends.ctypes.data)
                raw = buf.tobytes()
                out, start = [], 0
                for end in ends.tolist():
                    out.append(raw[start:end].decode("utf-8"))
                    start = end
                return out

            lib = self._lib
            user_ids = pool(lib.evlog_ratings_n_users,
                            lib.evlog_ratings_user_pool_bytes,
                            lib.evlog_ratings_user_pool_fill)
            item_ids = pool(lib.evlog_ratings_n_items,
                            lib.evlog_ratings_item_pool_bytes,
                            lib.evlog_ratings_item_pool_fill)
            return users, items, vals, user_ids, item_ids
        finally:
            self._lib.evlog_ratings_free(res)

    @staticmethod
    def _empty_cols() -> dict:
        return {
            "event": [], "entity_type": [], "entity_id": [],
            "target_entity_type": [], "target_entity_id": [],
            "properties": [], "event_time_ms": np.asarray([], dtype=np.int64),
        }

    def scan_columnar(self, app_id: int, filter: Optional[EventFilter] = None):
        """Bulk scan returning a column dict (training-path fast lane; same
        contract as :meth:`SqliteEventStore.scan_columnar`). Payloads are
        decoded straight from the mmap'd log into columns — no per-event
        ``Event``/``DataMap`` objects."""
        chunks = list(self.scan_columnar_iter(app_id, filter))
        if not chunks:
            return self._empty_cols()
        if len(chunks) == 1:
            return chunks[0]
        out = {
            k: [v for c in chunks for v in c[k]]
            for k in chunks[0]
            if k != "event_time_ms"
        }
        out["event_time_ms"] = np.concatenate([c["event_time_ms"] for c in chunks])
        return out

    def scan_columnar_iter(
        self,
        app_id: int,
        filter: Optional[EventFilter] = None,
        chunk_rows: int = 1_000_000,
    ):
        """Chunked columnar scan (``EventStore.scan_columnar_iter`` fast
        path): the native index scan resolves all offsets up front (numpy
        arrays, 24 B/event), then payload decode proceeds chunk by chunk
        from the mmap — bounded Python-object footprint regardless of app
        size (the region-split analogue, ``HBPEvents.scala:91-97``)."""
        f = filter or EventFilter()
        scan = self._scan(app_id, f)
        if scan is None or not len(scan[0]):
            return
        offs, lens, tms = scan
        if f.reversed:
            offs, lens, tms = offs[::-1], lens[::-1], tms[::-1]
        limit = f.limit if f.limit is not None and f.limit >= 0 else None
        emitted = 0
        with self._mmap(app_id) as mm:
            cols = self._empty_cols()
            times: list = []
            for off, length, tm in zip(offs.tolist(), lens.tolist(), tms.tolist()):
                obj = json.loads(mm[off : off + length])
                if not self._dict_matches(f, obj):
                    continue
                cols["event"].append(obj["event"])
                cols["entity_type"].append(obj["entityType"])
                cols["entity_id"].append(obj["entityId"])
                cols["target_entity_type"].append(obj.get("targetEntityType"))
                cols["target_entity_id"].append(obj.get("targetEntityId"))
                cols["properties"].append(obj.get("properties") or {})
                times.append(tm)
                emitted += 1
                full = len(times) >= chunk_rows
                done = limit is not None and emitted >= limit
                if full or done:
                    cols["event_time_ms"] = np.asarray(times, dtype=np.int64)
                    yield cols
                    if done:
                        return
                    cols = self._empty_cols()
                    times = []
            if times:
                cols["event_time_ms"] = np.asarray(times, dtype=np.int64)
                yield cols

    @contextlib.contextmanager
    def _mmap(self, app_id: int):
        """A read mmap of the app's log, closed with its file on exit."""
        with open(self._log_path(app_id), "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            with mmap.mmap(fh.fileno(), size, access=mmap.ACCESS_READ) as mm:
                yield mm

    def _decode_iter(
        self, app_id: int, f: EventFilter, offs: np.ndarray, lens: np.ndarray,
    ) -> Iterator[Event]:
        if f.reversed:
            offs, lens = offs[::-1], lens[::-1]
        limit = f.limit if f.limit is not None and f.limit >= 0 else None
        emitted = 0
        if len(offs) == 0:
            return
        with self._mmap(app_id) as mm:
            for off, length in zip(offs.tolist(), lens.tolist()):
                event = Event.from_json_dict(json.loads(mm[off : off + length]))
                # exact re-check (hash-collision guard)
                if not f.matches(event):
                    continue
                yield event
                emitted += 1
                if limit is not None and emitted >= limit:
                    return
