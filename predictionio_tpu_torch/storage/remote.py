"""Remote storage family (type ``remote``): the client of one storage primary.

Trimmed copy of ``predictionio_tpu/storage/remote.py`` for a single
endpoint: every store is a client of a storage server
(``storage/storage_server.py``, ``pio storageserver``), so several
processes (the Event Server, training, the query server, the console)
share one storage plane. Source settings::

    PIO_STORAGE_SOURCES_<NAME>_TYPE=remote
    PIO_STORAGE_SOURCES_<NAME>_URL=http://primary:7079
      (or _HOST, default 127.0.0.1, and _PORT, default 7079)

Connections are pooled per (thread, host:port) and reused when the last
response was read to its end; an idle pooled connection the server
closed gets one transparent retry on a fresh one for idempotent
requests, while a write first probes the pooled socket's liveness and
is never retried. Every request honours the ambient request
:class:`~..utils.resilience.Deadline` (its socket timeout capped, the
budget forwarded in ``X-PIO-Deadline-Ms``), forwards the ambient trace
id in ``X-PIO-Trace`` with a client span around it, and passes the
per-endpoint :class:`~..utils.resilience.CircuitBreaker` (``PIO_BREAKER_*``);
all wire I/O goes through the fault-injection point ``remote.send``.
Event scans stream as ndjson; ``scan_columnar`` ships column lists, so
``workflow.infeed.stream_ratings`` reads a remote store without an
event-by-event decode.

High-availability endpoint sets (``pio+ha://``, ``_NODES``), the
partitioned event store (``_PARTITIONS``) and failover are ROADMAP.md
queue 1 item 12's remainder: they raise.
"""

from __future__ import annotations

import http.client
import json
import select
import threading
import urllib.parse
from typing import Iterator, Optional

from ..obs.trace import TRACE_HEADER, current_context
from ..testing.faults import fault_point
from ..tools import not_ported
from ..utils.resilience import DEADLINE_HEADER, CircuitBreaker, CircuitOpen, current_deadline
from .event import Event
from .events import EventFilter, EventStore
from .model_store import Model, ModelStore
from .storage_server import DEFAULT_PORT, METADATA_READ_METHODS, METADATA_RPC_METHODS
from .wire import decode, encode

HA_SETS = "high-availability and partitioned storage endpoints (pio+ha://, _NODES, _PARTITIONS)"


class RemoteStorageError(Exception):
    """Transport or server-side failure with the server's message;
    ``code`` is the HTTP status, None for a transport error."""

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


# -- pooled keep-alive transport ---------------------------------------------


class _NetlocPool(threading.local):
    def __init__(self):
        self.conns: dict = {}


_pool = _NetlocPool()

# one breaker an endpoint, shared by every store and thread: a dead
# server costs the first few calls a connect timeout, then fast-fails
_breakers: dict = {}
_breakers_lock = threading.Lock()


def _get_breaker(netloc: str) -> CircuitBreaker:
    with _breakers_lock:
        breaker = _breakers.get(netloc)
        if breaker is None:
            breaker = CircuitBreaker.from_env(netloc)
            _breakers[netloc] = breaker
        return breaker


def reset_resilience() -> None:
    """Forget every breaker (a test hook: one test's dead endpoint must
    not fast-fail the next test's)."""
    with _breakers_lock:
        _breakers.clear()


def single_endpoint(url: str) -> str:
    """A base URL of one endpoint, its trailing slash dropped; a
    ``pio+ha://`` set or a ``;``-separated partitioned URL raises."""
    url = url.strip()
    if url.startswith("pio+ha://") or ";" in url:
        raise not_ported(f"{HA_SETS}: {url!r}", 12)
    return url.rstrip("/")


def _conn_is_dead(conn) -> bool:
    """Liveness probe for an idle pooled connection: with no request in
    flight the socket must have nothing to read, so readability means
    EOF or garbage."""
    sock = getattr(conn, "sock", None)
    if sock is None:
        return True
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        return bool(readable)
    except (OSError, ValueError):
        return True


def _return_conn(netloc: str, conn) -> None:
    old = _pool.conns.get(netloc)
    if old is not None and old is not conn:
        try:
            old.close()
        except Exception:
            pass
    _pool.conns[netloc] = conn


class _PooledResponse:
    """``http.client.HTTPResponse`` that returns its connection to the
    thread's pool when the body was read to its end."""

    def __init__(self, resp, conn, netloc: str):
        self._resp = resp
        self._conn = conn
        self._netloc = netloc

    def read(self, *a):
        return self._resp.read(*a)

    def getheader(self, name, default=None):
        return self._resp.getheader(name, default)

    def __iter__(self):
        return iter(self._resp)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        resp = self._resp
        if not resp.isclosed():
            # a caller that wanted only the status leaves a small body:
            # drain a bounded amount so the connection still pools
            try:
                resp.read(1 << 16)
            except Exception:
                conn.close()
                return
        if resp.isclosed() and not getattr(resp, "will_close", False):
            _return_conn(self._netloc, conn)
        else:
            conn.close()

    def __del__(self):  # dropped without close(): free the fd
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass


def _request(url: str, method: str = "GET", body: Optional[bytes] = None,
             timeout: float = 60.0, idempotent: Optional[bool] = None,
             headers: Optional[dict] = None):
    """One storage request. Under an ambient span context (a traced
    request is being served) the trace id goes out in ``X-PIO-Trace`` and
    a client span ``storage.<METHOD>`` covers the call up to the
    response headers."""
    ctx = current_context()
    if ctx is None:
        return _request_impl(url, method, body, timeout, idempotent, headers)
    headers = dict(headers or {})
    headers.setdefault(TRACE_HEADER, ctx.trace_id)
    with ctx.tracer.span(f"storage.{method}", tags={"url": url}, parent=ctx):
        return _request_impl(url, method, body, timeout, idempotent, headers)


def _request_impl(url: str, method: str, body: Optional[bytes], timeout: float,
                  idempotent: Optional[bool], headers: Optional[dict]):
    """``idempotent`` (default: GET and DELETE) allows the one-shot
    stale-connection retry; a non-idempotent request never retries (the
    server may have run it) and borrows a pooled connection only after
    the liveness probe."""
    parsed = urllib.parse.urlsplit(url)
    if parsed.scheme not in ("http", "https"):
        raise RemoteStorageError(f"unsupported URL scheme in {url!r}")
    conn_cls = (http.client.HTTPSConnection if parsed.scheme == "https"
                else http.client.HTTPConnection)
    default_port = 443 if parsed.scheme == "https" else DEFAULT_PORT
    if idempotent is None:
        idempotent = method in ("GET", "DELETE")
    netloc = f"{parsed.scheme}://{parsed.netloc}"
    path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
    headers = dict(headers or {})
    if body is not None:
        headers.setdefault("Content-Type", "application/json")
    deadline = current_deadline()
    breaker = _get_breaker(netloc)
    try:
        breaker.before_call()
    except CircuitOpen as exc:
        raise RemoteStorageError(f"{method} {url} not attempted: {exc}") from exc
    base_timeout = timeout
    for _attempt in (0, 1):
        # the budget re-checked for each attempt, the header the time left
        if deadline is not None:
            deadline.check(f"{method} {url}")
            timeout = deadline.cap_timeout(base_timeout)
            headers[DEADLINE_HEADER] = deadline.header_value()
        conn = _pool.conns.pop(netloc, None)
        if conn is not None and not idempotent and _conn_is_dead(conn):
            try:
                conn.close()
            except Exception:
                pass
            conn = None
        fresh = conn is None
        if fresh:
            conn = conn_cls(parsed.hostname, parsed.port or default_port, timeout=timeout)
        elif conn.sock is not None:
            try:
                conn.sock.settimeout(timeout)
            except OSError:  # the pooled socket already died
                conn.close()
                conn = conn_cls(parsed.hostname, parsed.port or default_port,
                                timeout=timeout)
                fresh = True
        try:
            fault_point("remote.send", method=method, url=url, fresh=fresh,
                        idempotent=idempotent)
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
        except Exception as exc:
            try:
                conn.close()
            except Exception:
                pass
            # retry only the stale keep-alive signature of an idempotent
            # request on a reused connection; a timeout or a fresh
            # connection's failure may have run server-side
            stale_reuse = (not fresh and idempotent and isinstance(
                exc, (BrokenPipeError, ConnectionResetError, http.client.RemoteDisconnected)))
            if not stale_reuse:
                breaker.record_failure()
                raise RemoteStorageError(f"{method} {url} unreachable: {exc}") from exc
            continue
        # any status proves the endpoint alive: an HTTP error is the
        # server talking, not the dependency down
        breaker.record_success()
        if resp.status >= 400:
            detail = resp.read().decode("utf-8", "replace")[:500]
            if resp.isclosed() and not getattr(resp, "will_close", False):
                _return_conn(netloc, conn)
            else:
                conn.close()
            raise RemoteStorageError(f"{method} {url} → HTTP {resp.status}: {detail}",
                                     code=resp.status)
        return _PooledResponse(resp, conn, netloc)
    raise AssertionError("unreachable")  # pragma: no cover


def _json(resp) -> dict:
    return json.loads(resp.read())


class RemoteEventStore(EventStore):
    """``EventStore`` over the storage server's ``/events`` routes."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        self._url = single_endpoint(base_url)
        self._timeout = timeout

    def _path(self, app_id: int, suffix: str = "") -> str:
        return f"{self._url}/events/{app_id}{suffix}"

    def init(self, app_id: int) -> bool:
        with _request(self._path(app_id, "/init"), "POST", b"{}", self._timeout,
                      idempotent=True) as r:
            return bool(_json(r)["ok"])

    def remove(self, app_id: int) -> bool:
        with _request(self._path(app_id, "/remove"), "POST", b"{}", self._timeout,
                      idempotent=True) as r:
            return bool(_json(r)["ok"])

    def insert(self, event: Event, app_id: int) -> str:
        # an event carrying its id is an upsert on the server: its POST
        # may take the stale-connection retry; an unkeyed one may not
        with _request(self._path(app_id), "POST", json.dumps(event.to_json_dict()).encode(),
                      self._timeout, idempotent=event.event_id is not None) as r:
            return _json(r)["eventId"]

    def get(self, event_id: str, app_id: int) -> Optional[Event]:
        try:
            with _request(self._path(app_id, f"/{event_id}"), timeout=self._timeout) as r:
                return Event.from_json_dict(_json(r))
        except RemoteStorageError as exc:
            if exc.code == 404:
                return None
            raise

    def delete(self, event_id: str, app_id: int) -> bool:
        with _request(self._path(app_id, f"/{event_id}"), "DELETE",
                      timeout=self._timeout) as r:
            return bool(_json(r)["found"])

    def find(self, app_id: int, filter: Optional[EventFilter] = None) -> Iterator[Event]:
        body = json.dumps(self._filter_dict(filter or EventFilter())).encode()
        # a pure read: the stale-connection retry is safe
        resp = _request(self._path(app_id, "/find"), "POST", body, self._timeout,
                        idempotent=True)

        def iterate() -> Iterator[Event]:
            with resp:
                for line in resp:  # http.client decodes the chunked framing
                    line = line.strip()
                    if line:
                        yield Event.from_json_dict(json.loads(line))

        return iterate()

    @staticmethod
    def _filter_dict(flt: EventFilter) -> dict:
        return {
            "start_time": flt.start_time.isoformat() if flt.start_time else None,
            "until_time": flt.until_time.isoformat() if flt.until_time else None,
            "entity_type": flt.entity_type,
            "entity_id": flt.entity_id,
            "event_names": list(flt.event_names) if flt.event_names else None,
            "target_entity_type": flt.target_entity_type,
            "target_entity_id": flt.target_entity_id,
            "has_target_entity_type": flt.has_target_entity_type,
            "has_target_entity_id": flt.has_target_entity_id,
            "limit": flt.limit,
            "reversed": flt.reversed,
        }

    def scan_columnar(self, app_id: int, filter: Optional[EventFilter] = None):
        """The columnar fast path over the wire (the contract of
        ``SqliteEventStore.scan_columnar``); the server takes its backing
        store's own columnar scan."""
        import numpy as np

        body = json.dumps(self._filter_dict(filter or EventFilter())).encode()
        with _request(self._path(app_id, "/scan_columnar"), "POST", body, self._timeout,
                      idempotent=True) as r:
            cols = _json(r)
        cols["event_time_ms"] = np.asarray(cols["event_time_ms"], dtype=np.int64)
        return cols

    def scan_columnar_iter(self, app_id: int, filter: Optional[EventFilter] = None,
                           chunk_rows: int = 1_000_000):
        """One ``scan_columnar`` round trip, yielded in chunks of at most
        ``chunk_rows`` rows (the ``EventStore.scan_columnar_iter``
        contract, without the base version's event-by-event decode)."""
        cols = self.scan_columnar(app_id, filter)
        n = len(cols["event"])
        for start in range(0, n, max(1, chunk_rows)):
            yield {k: v[start:start + chunk_rows] for k, v in cols.items()}

    def _write_batch(self, events, app_id: int, fresh: bool) -> None:
        body = json.dumps([e.to_json_dict() for e in events]).encode()
        with _request(self._path(app_id, "/batch?fresh=1" if fresh else "/batch"), "POST",
                      body, self._timeout):
            pass

    def write(self, events, app_id: int) -> None:
        self._write_batch(events, app_id, fresh=False)

    def write_new(self, events, app_id: int) -> None:
        """The freshness contract forwarded, so the backing store takes
        its guaranteed-new batch path."""
        self._write_batch(events, app_id, fresh=True)


class _RemoteRPC:
    """One metadata RPC bound to an endpoint. Reads may take the
    stale-connection retry; a mutation never does (a retried
    ``gen_next`` burns a value, a retried insert duplicates a row)."""

    def __init__(self, base_url: str, method: str, timeout: float):
        self._url = f"{single_endpoint(base_url)}/metadata/rpc"
        self._method, self._timeout = method, timeout
        self._read = method in METADATA_READ_METHODS

    def __call__(self, *args):
        body = json.dumps({"method": self._method, "args": [encode(a) for a in args]}).encode()
        with _request(self._url, "POST", body, self._timeout, idempotent=self._read) as r:
            return decode(_json(r)["result"])


class RemoteMetadataStore:
    """Duck-typed ``MetadataStore``: each method of the server's pinned
    RPC list becomes a bound callable."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        for method in METADATA_RPC_METHODS:
            setattr(self, method, _RemoteRPC(base_url, method, timeout))

    def close(self) -> None:
        pass


class RemoteModelStore(ModelStore):
    def __init__(self, base_url: str, timeout: float = 60.0):
        self._url = single_endpoint(base_url)
        self._timeout = timeout

    def insert(self, model: Model) -> None:
        # PUT by id is an upsert: a replay is safe
        with _request(f"{self._url}/models/{model.id}", "PUT", model.models, self._timeout,
                      idempotent=True, headers={"Content-Type": "application/octet-stream"}):
            pass

    def get(self, id: str) -> Optional[Model]:
        try:
            with _request(f"{self._url}/models/{id}", timeout=self._timeout) as r:
                return Model(id=id, models=r.read())
        except RemoteStorageError as exc:
            if exc.code == 404:
                return None
            raise

    def delete(self, id: str) -> None:
        with _request(f"{self._url}/models/{id}", "DELETE", timeout=self._timeout):
            pass


def base_url(conf: dict) -> str:
    """A source's settings → its base URL: ``URL`` verbatim, else
    ``http://HOST:PORT``; ``NODES`` and ``PARTITIONS`` raise."""
    for key in ("nodes", "partitions"):
        if conf.get(key):
            raise not_ported(f"{HA_SETS}: _{key.upper()}={conf[key]!r}", 12)
    if conf.get("url"):
        return single_endpoint(conf["url"])
    return f"http://{conf.get('host', '127.0.0.1')}:{int(conf.get('port', DEFAULT_PORT))}"


#: the ``remote`` family: repository kind → store class
FAMILY = {"events": RemoteEventStore, "metadata": RemoteMetadataStore,
          "models": RemoteModelStore}
