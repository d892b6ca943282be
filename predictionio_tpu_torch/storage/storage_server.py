"""The storage primary: one process serving all three repositories over HTTP.

Trimmed copy of ``predictionio_tpu/storage/storage_server.py`` for a
single primary. It exposes a registry's event, metadata and model
stores over the small HTTP API that ``storage/remote.py`` consumes, and,
with a :class:`~.changefeed.Changefeed` attached
(``create_storage_server(oplog_dir=...)``, the ``pio storageserver``
default), sequence-numbers every mutation into the oplog that the
continuous loop's watcher tails. The wire is the JAX package's: either
package's client talks to either package's server.

Routes (JSON unless noted):

* ``POST /events/<app>``                 insert one event → ``{"eventId"}``
* ``POST /events/<app>/batch[?fresh=1]`` bulk write ``[event, ...]``
* ``GET|DELETE /events/<app>/<id>``      point get / delete
* ``POST /events/<app>/find``            filter dict → **ndjson** stream
* ``POST /events/<app>/scan_columnar``   filter dict → column lists
* ``POST /events/<app>/init|remove``     lifecycle
* ``POST /metadata/rpc``                 ``{"method", "args"}`` → ``{"result"}``
* ``PUT|GET|DELETE /models/<id>``        raw model bytes
* ``GET /``, ``/status.json``            role, seq, generation, stores
* ``GET /health``                        liveness
* ``GET /replicate/changes?since=&limit=``  changefeed records (410 on a gap)
* ``GET /replicate/checkpoint``          seq, generation, oldest seq
* ``GET /metrics``, ``/traces.json``, ``/health.json``, ``/blackbox.json``

Every mutating answer carries ``X-PIO-Seq``. A request whose
``X-PIO-Deadline-Ms`` budget is gone is answered 504 before any store
work; ``X-PIO-Trace`` joins the caller's trace. Replicas (``--replica-of``,
``POST /replicate/promote``, the ``X-PIO-Min-Seq`` wait) and partitioned
primaries are ROADMAP.md queue 1 item 12's remainder: a primary answers
``/replicate/promote`` with 409 and reads without waiting (a primary has
applied every seq it issued).
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import logging
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..api.http import BackgroundHTTPServer, JsonHTTPHandler
from ..obs.metrics import MetricsRegistry
from ..obs.trace import TRACE_HEADER, Tracer
from ..tools import not_ported
from ..utils.resilience import DEADLINE_HEADER, Deadline
from .changefeed import SEQ_HEADER
from .event import Event, to_millis
from .events import EventFilter
from .metadata import MetadataStore
from .model_store import Model
from .oplog import OpLogGap
from .wire import decode, encode

logger = logging.getLogger(__name__)

DEFAULT_PORT = 7079

#: MetadataStore methods callable over /metadata/rpc: an explicit list,
#: so a future method is reachable remotely only by decision
METADATA_RPC_METHODS = frozenset({
    "gen_next",
    "app_insert",
    "app_get",
    "app_get_by_name",
    "app_get_all",
    "app_update",
    "app_delete",
    "access_key_insert",
    "access_key_get",
    "access_key_get_by_app",
    "access_key_delete",
    "manifest_update",
    "manifest_get",
    "engine_instance_insert",
    "engine_instance_get",
    "engine_instance_get_all",
    "engine_instance_get_latest_completed",
    "engine_instance_update",
    "engine_instance_delete",
    "evaluation_instance_insert",
    "evaluation_instance_get",
    "evaluation_instance_get_completed",
    "evaluation_instance_update",
    "rollout_plan_upsert",
    "rollout_plan_get",
    "rollout_plan_get_all",
    "rollout_plan_get_active",
    "rollout_plan_get_latest",
})

#: the pure-read subset: safe to retry on a stale keep-alive connection
METADATA_READ_METHODS = frozenset({
    "app_get",
    "app_get_by_name",
    "app_get_all",
    "access_key_get",
    "access_key_get_by_app",
    "manifest_get",
    "engine_instance_get",
    "engine_instance_get_all",
    "engine_instance_get_latest_completed",
    "evaluation_instance_get",
    "evaluation_instance_get_completed",
    "rollout_plan_get",
    "rollout_plan_get_all",
    "rollout_plan_get_active",
    "rollout_plan_get_latest",
})

REPLICAS = "storage replicas (--replica-of, /replicate/promote, X-PIO-Min-Seq)"
PARTITIONED_PRIMARY = "a partitioned storage primary (partition_count > 1)"


def _parse_filter(obj: dict) -> EventFilter:
    kwargs = dict(obj)
    for key in ("start_time", "until_time"):
        if kwargs.get(key) is not None:
            kwargs[key] = _dt.datetime.fromisoformat(kwargs[key])
    return EventFilter(**kwargs)


class _StorageHandler(JsonHTTPHandler):
    server: "StorageServer"

    @contextlib.contextmanager
    def _obs_scope(self, method: str, op: str):
        """Admission span (joins the caller's ``X-PIO-Trace``) and the op
        latency histogram around one data-plane route; ``op`` is the
        route family, never an app or record id."""
        server = self.server
        started = server.metrics.clock()
        try:
            with server.tracer.server_span(f"{method} /{op}",
                                           header_value=self.headers.get(TRACE_HEADER),
                                           tags={"op": op}):
                yield
        finally:
            server.metrics.histogram(
                "pio_storage_op_seconds", "Storage server op latency by route family",
                labelnames=("method", "op"),
            ).observe(server.metrics.clock() - started, method=method, op=op)

    def _route(self, method: str) -> None:
        self._headers_sent = False  # per request (keep-alive reuse)
        path = urlparse(self.path).path.rstrip("/")
        parts = [p for p in path.split("/") if p]
        try:
            deadline = Deadline.from_header(self.headers.get(DEADLINE_HEADER))
            if deadline is not None and deadline.expired:
                # the caller gave up: spend no store work on the answer
                self.read_body()
                self.respond(504, {"message": "deadline exceeded"})
                return
            if not parts and method == "GET" or parts == ["status.json"] and method == "GET":
                self.respond(200, self.server.status_json())
            elif parts == ["health"]:
                self.respond(200, {"status": "alive"})
            elif method == "GET" and parts in (["metrics"], ["traces.json"],
                                               ["health.json"], ["blackbox.json"]):
                self.serve_obs("/" + parts[0])
            elif parts and parts[0] == "replicate":
                with self._obs_scope(method, "replicate"):
                    self._route_replicate(method, parts[1:])
            elif parts and parts[0] == "events":
                with self._obs_scope(method, "events"):
                    self._route_events(method, parts[1:])
            elif parts == ["metadata", "rpc"] and method == "POST":
                with self._obs_scope(method, "metadata"):
                    self._metadata_rpc()
            elif parts and parts[0] == "models" and len(parts) == 2:
                with self._obs_scope(method, "models"):
                    self._route_models(method, parts[1])
            else:
                self.read_body()
                self.respond(404, {"message": "Not found"})
        except (BrokenPipeError, ConnectionResetError) as exc:
            # the client dropped mid-stream (an abandoned scan)
            logger.debug("client dropped during %s %s: %s", method, path, exc)
            self.close_connection = True
        except Exception as exc:  # one bad request must not kill the server
            logger.exception("storage server error on %s %s", method, path)
            if self._headers_sent:
                # mid-stream: a second response would corrupt the chunked
                # framing, so the client fails loudly on the cut instead
                self.close_connection = True
                return
            try:
                self.respond(500, {"message": f"{type(exc).__name__}: {exc}"})
            except Exception:
                pass  # client hung up mid-response

    @staticmethod
    def _seq_headers(seq) -> Optional[dict]:
        return {SEQ_HEADER: seq} if seq is not None else None

    def _route_replicate(self, method: str, rest: list) -> None:
        cf = self.server.changefeed
        if rest == ["changes"] and method == "GET":
            if cf is None:
                self.respond(404, {"message": "changefeed disabled"})
                return
            q = parse_qs(urlparse(self.path).query)
            since = int(q.get("since", ["0"])[0])
            limit = min(max(1, int(q.get("limit", ["500"])[0])), 1000)
            try:
                entries, last_seq = cf.oplog.read_since(since, limit)
            except OpLogGap as exc:
                self.respond(410, {"message": str(exc), **cf.oplog.checkpoint()})
                return
            self.respond(200, {"changes": [{"seq": s, "op": o} for s, o in entries],
                               "lastSeq": last_seq, "generation": cf.oplog.generation,
                               "oldestSeq": cf.oplog.oldest_seq})
        elif rest == ["checkpoint"] and method == "GET":
            if cf is None:
                self.respond(404, {"message": "changefeed disabled"})
                return
            ck = cf.oplog.checkpoint()
            ck["stores"] = self.server.status_json()["stores"]
            self.respond(200, ck)
        elif rest == ["promote"] and method == "POST":
            self.read_body()
            self.respond(409, {"message": "not a replica"})
        else:
            self.read_body()
            self.respond(404, {"message": "Not found"})

    def do_GET(self) -> None:  # noqa: N802
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def do_PUT(self) -> None:  # noqa: N802
        self._route("PUT")

    def do_DELETE(self) -> None:  # noqa: N802
        self._route("DELETE")

    # -- events -----------------------------------------------------------
    def _route_events(self, method: str, parts: list) -> None:
        store = self.server.events
        if not parts:
            self.read_body()
            self.respond(404, {"message": "Missing app id"})
            return
        app_id = int(parts[0])
        rest = parts[1:]
        cf = self.server.changefeed
        if method == "POST" and not rest:
            event = Event.from_json_dict(json.loads(self.read_body()))
            if cf is not None:
                event_id, seq = cf.insert_event(event, app_id)
                self.respond(201, {"eventId": event_id}, headers=self._seq_headers(seq))
            else:
                self.respond(201, {"eventId": store.insert(event, app_id)})
        elif method == "POST" and rest == ["batch"]:
            fresh = parse_qs(urlparse(self.path).query).get("fresh")
            fresh = bool(fresh and fresh[0] == "1")
            events = [Event.from_json_dict(o) for o in json.loads(self.read_body())]
            seq = None
            if cf is not None:
                seq = cf.write_events(events, app_id, fresh)
            elif fresh:
                store.write_new(events, app_id)
            else:
                store.write(events, app_id)
            self.respond(200, {"count": len(events)}, headers=self._seq_headers(seq))
        elif method == "POST" and rest == ["find"]:
            flt = _parse_filter(json.loads(self.read_body() or b"{}"))
            self._stream_events(store.find(app_id, flt))
        elif method == "POST" and rest == ["scan_columnar"]:
            flt = _parse_filter(json.loads(self.read_body() or b"{}"))
            self._scan_columnar(store, app_id, flt)
        elif method == "POST" and rest in (["init"], ["remove"]):
            self.read_body()
            if cf is not None:
                ok, seq = (cf.init_app if rest == ["init"] else cf.remove_app)(app_id)
                self.respond(200, {"ok": ok}, headers=self._seq_headers(seq))
            else:
                fn = store.init if rest == ["init"] else store.remove
                self.respond(200, {"ok": fn(app_id)})
        elif method == "GET" and len(rest) == 1:
            event = store.get(rest[0], app_id)
            if event is None:
                self.respond(404, {"message": "Not found"})
            else:
                self.respond(200, event.to_json_dict())
        elif method == "DELETE" and len(rest) == 1:
            if cf is not None:
                found, seq = cf.delete_event(rest[0], app_id)
                self.respond(200, {"found": found}, headers=self._seq_headers(seq))
            else:
                self.respond(200, {"found": store.delete(rest[0], app_id)})
        else:
            self.read_body()
            self.respond(404, {"message": "Not found"})

    def _stream_events(self, events) -> None:
        """ndjson, chunked: the scan never materialises server-side."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self._headers_sent = True

        def chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

        buf = bytearray()
        for event in events:
            buf += json.dumps(event.to_json_dict()).encode() + b"\n"
            if len(buf) >= 64 * 1024:
                chunk(bytes(buf))
                buf.clear()
        if buf:
            chunk(bytes(buf))
        self.wfile.write(b"0\r\n\r\n")

    def _scan_columnar(self, store, app_id: int, flt: EventFilter) -> None:
        """The columnar fast path: the backing store's own columnar scan
        where it has one, else columns derived from ``find``."""
        if hasattr(store, "scan_columnar"):
            cols = dict(store.scan_columnar(app_id, flt))
            cols["event_time_ms"] = [int(v) for v in cols["event_time_ms"]]
        else:
            cols = {"event": [], "entity_type": [], "entity_id": [],
                    "target_entity_type": [], "target_entity_id": [],
                    "properties": [], "event_time_ms": []}
            for e in store.find(app_id, flt):
                cols["event"].append(e.event)
                cols["entity_type"].append(e.entity_type)
                cols["entity_id"].append(e.entity_id)
                cols["target_entity_type"].append(e.target_entity_type)
                cols["target_entity_id"].append(e.target_entity_id)
                cols["properties"].append(e.properties.to_dict())
                cols["event_time_ms"].append(to_millis(e.event_time))
        self.respond(200, cols)

    # -- metadata ---------------------------------------------------------
    def _metadata_rpc(self) -> None:
        req = json.loads(self.read_body())
        method = req.get("method", "")
        if method not in METADATA_RPC_METHODS:
            self.respond(400, {"message": f"Unknown RPC method {method!r}"})
            return
        args = [decode(a) for a in req.get("args", [])]
        cf = self.server.changefeed
        if cf is not None:
            result, seq = cf.metadata_rpc(method, args)
            self.respond(200, {"result": encode(result)}, headers=self._seq_headers(seq))
        else:
            result = getattr(self.server.metadata, method)(*args)
            self.respond(200, {"result": encode(result)})

    # -- models -----------------------------------------------------------
    def _route_models(self, method: str, model_id: str) -> None:
        store = self.server.models
        cf = self.server.changefeed
        if method == "PUT":
            model = Model(id=model_id, models=self.read_body())
            if cf is not None:
                self.respond(200, {"ok": True}, headers=self._seq_headers(cf.put_model(model)))
            else:
                store.insert(model)
                self.respond(200, {"ok": True})
        elif method == "GET":
            model = store.get(model_id)
            if model is None:
                self.respond(404, {"message": "Not found"})
            else:
                self.respond(200, model.models, content_type="application/octet-stream")
        elif method == "DELETE":
            if cf is not None:
                self.respond(200, {"ok": True},
                             headers=self._seq_headers(cf.delete_model(model_id)))
            else:
                store.delete(model_id)
                self.respond(200, {"ok": True})
        else:
            self.read_body()
            self.respond(404, {"message": "Not found"})


class StorageServer(BackgroundHTTPServer):
    """HTTP front for one set of backing stores; with ``changefeed``
    attached, a replication primary whose mutations are
    sequence-numbered and shipped through ``/replicate/*``."""

    def __init__(self, host: str, port: int, events, metadata: MetadataStore, models,
                 changefeed=None):
        super().__init__((host, port), _StorageHandler, metrics=MetricsRegistry(),
                         tracer=Tracer("storage-server"), health_kind="storage")
        self.events = events
        self.metadata = metadata
        self.models = models
        self.changefeed = changefeed
        self.start_time = _dt.datetime.now(tz=_dt.timezone.utc)
        # the log's append counter: a scraper's rate() over it is the
        # append rate
        self.metrics.gauge_callback(
            "pio_changefeed_seq",
            lambda: self.changefeed.last_seq if self.changefeed is not None else 0,
            "Last sequence number appended to the changefeed op log",
        )

    def status_json(self) -> dict:
        """``GET /`` and ``/status.json``: readiness with the role, the
        changefeed's seq and generation, and the backing store classes."""
        out = {
            "status": "alive",
            "role": "primary",
            "startTime": self.start_time.isoformat(timespec="milliseconds"),
            "stores": {"events": type(self.events).__name__,
                       "metadata": type(self.metadata).__name__,
                       "models": type(self.models).__name__},
        }
        if self.changefeed is not None:
            out["seq"] = self.changefeed.last_seq
            out["generation"] = self.changefeed.oplog.generation
        return out

    def server_close(self) -> None:
        super().server_close()
        if self.changefeed is not None:
            self.changefeed.oplog.sync()


def create_storage_server(host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                          registry: Optional[object] = None,
                          oplog_dir: Optional[str] = None, partition_index: int = 0,
                          partition_count: int = 1,
                          sync_every: Optional[int] = None) -> StorageServer:
    """A storage primary fronting ``registry`` (default: the process-wide
    registry). ``oplog_dir`` attaches a changefeed rooted there;
    ``sync_every`` sets the oplog's fsync cadence (1 = fsync before every
    ack). ``partition_count > 1`` raises (ROADMAP.md queue 1 item 12)."""
    if partition_count > 1 or partition_index:
        raise not_ported(PARTITIONED_PRIMARY, 12)
    if registry is None:
        from .registry import get_registry

        registry = get_registry()
    events = registry.get_events()
    metadata = registry.get_metadata()
    models = registry.get_models()
    changefeed = None
    if oplog_dir is not None:
        from .changefeed import Changefeed
        from .oplog import DEFAULT_SYNC_EVERY, OpLog

        changefeed = Changefeed(
            OpLog(oplog_dir, sync_every=sync_every if sync_every is not None
                  else DEFAULT_SYNC_EVERY),
            events, metadata, models)
    return StorageServer(host, port, events, metadata, models, changefeed)
