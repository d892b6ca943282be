"""Event Server: REST ingestion API.

Trimmed copy of the JAX package's ``api/event_server.py``, the reference
Event Server (``data/src/main/scala/io/prediction/data/api/EventAPI.scala``):

- ``GET /``                      → ``{"status": "alive"}``            (``EventAPI.scala:168-175``)
- ``POST /events.json``          → 201 ``{"eventId": ...}``           (``EventAPI.scala:229-252``)
- ``POST /batches/events.json``  → per-event ``[{"status", ...}]``, one bad event
                                   does not reject the batch
- ``GET /events.json``           → filtered scan, default limit 20    (``EventAPI.scala:254-325``)
- ``GET /events/<id>.json``      → single event or 404                (``EventAPI.scala:177-200``)
- ``DELETE /events/<id>.json``   → ``{"message": "Found"/"Not Found"}`` (``EventAPI.scala:202-226``)
- ``GET /stats.json``            → hourly + lifetime counters (``stats`` only)
                                                                      (``EventAPI.scala:327-345``)
- ``GET /metrics``, ``/traces.json``, ``/health.json``, ``/blackbox.json``
                                 → counters and latency histogram, the span
                                   ring, the health plane, the flight recorder

``POST /events.json`` (and each element of the batch route) accepts an
optional client-supplied ``idempotencyKey``: duplicate POSTs with the same
key insert exactly one event (the key derives a deterministic ``eventId``
and dedup rides the stores' upsert-by-id path).

Every route authenticates via the ``accessKey`` query parameter resolved to an
``appId`` through the metadata store (``withAccessKey``,
``EventAPI.scala:149-164``); missing or unknown keys get
401 ``{"message": "Invalid accessKey."}``. Defaults: localhost:7070
(``EventServerConfig``, ``EventAPI.scala:422-425``).

Every request opens an admission span under the caller's
``X-PIO-Trace`` id (the query server's feedback delivery forwards its
request's id, so both servers' spans share one trace), recorded by the
server's ``Tracer("event-server")``; the server carries the ``event``
health plane. Every event the store accepted (and every 400) goes through
the :class:`~..obs.quality.IngestQualityMonitor`: per-app schema, range
and poison counters and the event-type mix against a per-app baseline
kept under ``quality_dir`` (``PIO_QUALITY_DIR``),
``pio_quality_event_mix_psi{app}``. Not ported here (ROADMAP.md, queue 1
item 12): the partitioned and migrating remote stores (their 503 shedding
and ``/replication.json``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..obs.metrics import MetricsRegistry
from ..obs.quality import IngestQualityMonitor
from ..obs.trace import TRACE_HEADER, Tracer
from ..storage.event import (
    Event,
    EventValidationError,
    format_event_time,
    idempotency_event_id,
    parse_event_time,
    utcnow,
    validate_event,
    with_event_id,
)
from ..storage.events import EventFilter, EventStore
from ..storage.metadata import MetadataStore
from ..storage.registry import StorageRegistry, get_registry
from ..storage.sqlite_events import make_event_id
from .http import BackgroundHTTPServer, JsonHTTPHandler

logger = logging.getLogger(__name__)

#: what a malformed event raises while it is parsed and validated (400)
_BAD_EVENT = (ValueError, KeyError, TypeError, AttributeError, EventValidationError)


# ---------------------------------------------------------------------------
# Stats bookkeeping (EventAPI.scala:60-112, 354-395)
# ---------------------------------------------------------------------------


class Stats:
    """Counters for one window: status codes and (entityType, targetEntityType,
    event) triples per app (``class Stats``, ``EventAPI.scala:81-112``)."""

    def __init__(self, start_time: _dt.datetime):
        self.start_time = start_time
        self.end_time: Optional[_dt.datetime] = None
        self.status_code_count: Dict[Tuple[int, int], int] = {}
        self.ete_count: Dict[Tuple[int, Tuple[str, Optional[str], str]], int] = {}

    def cutoff(self, end_time: _dt.datetime) -> None:
        self.end_time = end_time

    def update(self, app_id: int, status_code: int, event: Event) -> None:
        sk = (app_id, status_code)
        self.status_code_count[sk] = self.status_code_count.get(sk, 0) + 1
        ek = (app_id, (event.entity_type, event.target_entity_type, event.event))
        self.ete_count[ek] = self.ete_count.get(ek, 0) + 1

    def snapshot(self, app_id: int) -> dict:
        """``StatsSnapshot`` JSON shape (``EventAPI.scala:73-78``)."""
        return {
            "startTime": format_event_time(self.start_time),
            "endTime": format_event_time(self.end_time) if self.end_time else None,
            "basic": [
                {
                    "key": {
                        "entityType": ete[0],
                        "targetEntityType": ete[1],
                        "event": ete[2],
                    },
                    "value": count,
                }
                for (aid, ete), count in sorted(
                    self.ete_count.items(),
                    key=lambda kv: (kv[0][0], kv[0][1][0], kv[0][1][1] or "", kv[0][1][2]),
                )
                if aid == app_id
            ],
            "statusCode": [
                {"key": code, "value": count}
                for (aid, code), count in sorted(self.status_code_count.items())
                if aid == app_id
            ],
        }


def _current_hour(now: Optional[_dt.datetime] = None) -> _dt.datetime:
    now = now or utcnow()
    return now.replace(minute=0, second=0, microsecond=0)


class StatsTracker:
    """Hourly + lifetime windows with hour rollover
    (``StatsActor``, ``EventAPI.scala:354-395``); thread-safe in place of the
    actor mailbox."""

    def __init__(self):
        self._lock = threading.Lock()
        self.long_live = Stats(utcnow())
        self.hourly = Stats(_current_hour())
        self.prev_hourly = Stats(_current_hour() - _dt.timedelta(hours=1))
        self.prev_hourly.cutoff(self.hourly.start_time)

    def bookkeeping(self, app_id: int, status_code: int, event: Event) -> None:
        with self._lock:
            current = _current_hour()
            if current != self.hourly.start_time:
                self.prev_hourly = self.hourly
                self.prev_hourly.cutoff(current)
                self.hourly = Stats(current)
            self.hourly.update(app_id, status_code, event)
            self.long_live.update(app_id, status_code, event)

    def get(self, app_id: int) -> dict:
        """``GetStats`` reply shape (``EventAPI.scala:383-387``)."""
        with self._lock:
            return {
                "time": format_event_time(utcnow()),
                "currentHour": self.hourly.snapshot(app_id),
                "prevHour": self.prev_hourly.snapshot(app_id),
                "longLive": self.long_live.snapshot(app_id),
            }


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EventServerConfig:
    """``EventServerConfig`` (``EventAPI.scala:422-425``)."""

    ip: str = "localhost"
    port: int = 7070
    stats: bool = False
    #: directory of the ingest quality monitor's per-app event-mix
    #: baselines; None reads ``PIO_QUALITY_DIR`` (unset = in memory only)
    quality_dir: Optional[str] = None


class _HTTPError(Exception):
    def __init__(self, status: int, body: dict):
        self.status = status
        self.body = body


def _parse_bool(text: str) -> bool:
    return text.strip().lower() in ("true", "1", "yes")


def _apply_idempotency_key(obj: dict, app_id: int) -> None:
    """``idempotencyKey`` (optional, client-supplied, per event): a
    duplicate POST with the same key must insert exactly once. The key
    maps to a deterministic ``eventId``, so dedup rides the stores'
    upsert-by-id semantics. An explicit ``eventId`` wins (the client
    already controls identity)."""
    key = obj.pop("idempotencyKey", None)
    if key is None:
        return
    if not isinstance(key, str) or not key:
        raise EventValidationError("idempotencyKey must be a non-empty string")
    if not obj.get("eventId"):
        obj["eventId"] = idempotency_event_id(app_id, key)


def _parse_event(obj, app_id: int) -> Event:
    """One wire event → a validated :class:`Event` (raises ``_BAD_EVENT``)."""
    if not isinstance(obj, dict):
        raise EventValidationError("event must be a JSON object")
    _apply_idempotency_key(obj, app_id)
    event = Event.from_json_dict(obj)
    validate_event(event)
    return event


class _EventServiceHandler(JsonHTTPHandler):
    """One request = one route dispatch (``EventServiceActor.route``,
    ``EventAPI.scala:166-349``)."""

    server: "EventServer"

    def _auth(self, query: Dict[str, list]) -> int:
        """accessKey → appId (``withAccessKey``, ``EventAPI.scala:149-164``).
        Missing and invalid keys both yield 401."""
        keys = query.get("accessKey")
        ak = self.server.metadata.access_key_get(keys[0]) if keys else None
        if ak is None:
            raise _HTTPError(401, {"message": "Invalid accessKey."})
        return ak.appid

    @staticmethod
    def _route_label(method: str, path: str) -> str:
        """Collapse a request path to its route template — the bounded
        label the latency histogram is keyed on."""
        if path.startswith("/events/") and path.endswith(".json"):
            return f"{method} /events/<id>.json"
        if path in ("/", "/events.json", "/batches/events.json", "/stats.json"):
            return f"{method} {path}"
        return "other"

    # -- dispatch ---------------------------------------------------------
    def _route(self, method: str) -> None:
        parsed = urlparse(self.path)
        path = parsed.path
        query = parse_qs(parsed.query)
        # Drain the request body up front: on keep-alive connections an error
        # response sent before the body is read would desync the next request.
        self._body = self.read_body()
        if method == "GET" and self.serve_obs(path):
            return
        route = self._route_label(method, path)
        started = time.monotonic()
        try:
            # admission span: joins the caller's X-PIO-Trace
            with self.server.tracer.server_span(
                route, header_value=self.headers.get(TRACE_HEADER)
            ):
                self._dispatch(method, path, query)
        except _HTTPError as err:
            self.respond(err.status, err.body)
        except Exception as exc:  # route-level catch-all (rejectionHandler)
            logger.exception("Event server error on %s %s", method, path)
            self.respond(500, {"message": str(exc)})
        finally:
            self.server.metrics.histogram(
                "pio_http_request_seconds",
                "Event Server request latency by route",
                labelnames=("route",),
            ).observe(time.monotonic() - started, route=route)

    def _dispatch(self, method: str, path: str, query: Dict[str, list]) -> None:
        if path == "/" and method == "GET":
            self.respond(200, {"status": "alive"})
        elif path == "/events.json" and method == "POST":
            self._post_event(query)
        elif path == "/batches/events.json" and method == "POST":
            self._post_event_batch(query)
        elif path == "/events.json" and method == "GET":
            self._find_events(query)
        elif (
            path.startswith("/events/")
            and path.endswith(".json")
            and method in ("GET", "DELETE")
        ):
            event_id = path[len("/events/") : -len(".json")]
            app_id = self._auth(query)
            if method == "GET":
                self._get_event(event_id, app_id)
            else:
                self._delete_event(event_id, app_id)
        elif path == "/stats.json" and method == "GET":
            self._get_stats(query)
        else:
            self.respond(404, {"message": "Not Found"})

    def do_GET(self) -> None:  # noqa: N802
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def do_DELETE(self) -> None:  # noqa: N802
        self._route("DELETE")

    # -- routes -----------------------------------------------------------
    def _post_event(self, query: Dict[str, list]) -> None:
        """``EventAPI.scala:229-252``."""
        app_id = self._auth(query)
        try:
            event = _parse_event(json.loads(self._body.decode("utf-8")), app_id)
        except _BAD_EVENT as exc:
            # MalformedRequestContentRejection → 400 (EventAPI.scala:135-137)
            self.server._observe_quality(app_id)
            self.respond(400, {"message": str(exc)})
            return
        event_id = self.server.events.insert(event, app_id)
        # quality accounting only after the store accepted the event: a
        # storage failure must not feed the mix window or pin a baseline
        self.server._observe_quality(app_id, event)
        if self.server.stats_tracker is not None:
            self.server.stats_tracker.bookkeeping(app_id, 201, event)
        self.respond(201, {"eventId": event_id})

    def _post_event_batch(self, query: Dict[str, list]) -> None:
        """``POST /batches/events.json`` — bulk ingestion (the official
        SDKs' batch surface). Body is a JSON array of events; the response
        is a per-event array of ``{"status": 201, "eventId": ...}`` or
        ``{"status": 400, "message": ...}`` in input order — one bad event
        does not reject the batch. Events without an id get a fresh one
        and take the store's batched append (``write_new``); events with
        an id (or an ``idempotencyKey``) keep upsert semantics
        (``write``)."""
        app_id = self._auth(query)
        try:
            objs = json.loads(self._body.decode("utf-8"))
            if not isinstance(objs, list):
                raise ValueError("batch body must be a JSON array")
        except ValueError as exc:
            self.respond(400, {"message": str(exc)})
            return
        results: list = [None] * len(objs)
        fresh, upserts = [], []
        for pos, obj in enumerate(objs):
            try:
                event = _parse_event(obj, app_id)
            except _BAD_EVENT as exc:
                self.server._observe_quality(app_id)
                results[pos] = {"status": 400, "message": str(exc)}
                continue
            if event.event_id is None:
                event = with_event_id(event, make_event_id(event))
                fresh.append(event)
            else:
                upserts.append(event)
            results[pos] = {"status": 201, "eventId": event.event_id}
        if fresh:
            self.server.events.write_new(fresh, app_id)
        if upserts:
            self.server.events.write(upserts, app_id)
        # after the batched writes landed, as on the single route
        for event in fresh + upserts:
            self.server._observe_quality(app_id, event)
        if self.server.stats_tracker is not None:
            for event in fresh + upserts:
                self.server.stats_tracker.bookkeeping(app_id, 201, event)
        self.respond(200, results)

    def _find_events(self, query: Dict[str, list]) -> None:
        """``EventAPI.scala:254-325``; single ``event`` name, limit default 20."""
        app_id = self._auth(query)

        def q(name: str) -> Optional[str]:
            vals = query.get(name)
            return vals[0] if vals else None

        try:
            flt = EventFilter(
                start_time=parse_event_time(q("startTime")) if q("startTime") else None,
                until_time=parse_event_time(q("untilTime")) if q("untilTime") else None,
                entity_type=q("entityType"),
                entity_id=q("entityId"),
                event_names=[q("event")] if q("event") else None,
                target_entity_type=q("targetEntityType"),
                target_entity_id=q("targetEntityId"),
                limit=int(q("limit")) if q("limit") else 20,
                reversed=_parse_bool(q("reversed") or "false"),
            )
        except (ValueError, EventValidationError) as exc:
            self.respond(400, {"message": str(exc)})
            return
        events = list(self.server.events.find(app_id, flt))
        if events:
            self.respond(200, [e.to_json_dict() for e in events])
        else:
            self.respond(404, {"message": "Not Found"})

    def _get_event(self, event_id: str, app_id: int) -> None:
        event = self.server.events.get(event_id, app_id)
        if event is None:
            self.respond(404, {"message": "Not Found"})
        else:
            self.respond(200, event.to_json_dict())

    def _delete_event(self, event_id: str, app_id: int) -> None:
        if self.server.events.delete(event_id, app_id):
            self.respond(200, {"message": "Found"})
        else:
            self.respond(404, {"message": "Not Found"})

    def _get_stats(self, query: Dict[str, list]) -> None:
        app_id = self._auth(query)
        if self.server.stats_tracker is None:
            self.respond(
                404,
                {"message": "To see stats, launch Event Server with --stats argument."},
            )
            return
        self.respond(200, self.server.stats_tracker.get(app_id))


class EventServer(BackgroundHTTPServer):
    """Threaded HTTP server bound to the storage plane
    (``EventServer.createEventServer``, ``EventAPI.scala:427-445``)."""

    def __init__(self, config: EventServerConfig, events: EventStore,
                 metadata: MetadataStore):
        self.config = config
        self.events = events
        self.metadata = metadata
        self.stats_tracker: Optional[StatsTracker] = (
            StatsTracker() if config.stats else None
        )
        super().__init__(
            (config.ip, config.port), _EventServiceHandler, metrics=MetricsRegistry(),
            tracer=Tracer("event-server"), health_kind="event",
        )
        self.quality = IngestQualityMonitor(
            self.metrics, clock=self.metrics.clock,
            baseline_dir=config.quality_dir or os.environ.get("PIO_QUALITY_DIR"),
        )
        self._observer_errors = self.metrics.counter(
            "pio_observer_errors_total",
            "Swallowed observer/monitor exceptions by site",
            labelnames=("site",),
        )

    def _observe_quality(self, app_id: int, event: Optional[Event] = None) -> None:
        """Quality accounting (a rejected event when ``event`` is None).
        A monitor fault is counted on ``pio_observer_errors_total`` and
        never raised: after the store committed, a 500 would invite a
        client retry and a duplicate."""
        try:
            if event is None:
                self.quality.record_rejected(app_id)
            else:
                self.quality.record_event(app_id, event)
        except Exception:
            self._observer_errors.inc(1, site="ingest.quality")
            logger.debug("ingest quality accounting failed", exc_info=True)


def create_event_server(
    config: EventServerConfig = EventServerConfig(),
    registry: Optional[StorageRegistry] = None,
    block: bool = True,
) -> EventServer:
    """Wire the server to the storage registry (default: the process-wide
    one, from ``PIO_STORAGE_*``) and run it (``EventServer.createEventServer``,
    ``EventAPI.scala:427-445``).

    With ``block=False`` the server runs on a daemon thread and is returned
    for programmatic shutdown (``server.shutdown(); server.server_close()``).
    """
    registry = registry or get_registry()
    server = EventServer(
        config, events=registry.get_events(), metadata=registry.get_metadata()
    )
    logger.info(
        "Event Server listening on %s:%d (stats=%s)",
        config.ip, server.bound_port, config.stats,
    )
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
    else:
        server.start_background()
    return server
