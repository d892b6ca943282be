"""Shared HTTP plumbing: JSON handlers on threaded stdlib servers.

Trimmed copy of ``predictionio_tpu/api/http.py``: JSON responses with
every status counted into the server's metrics registry, keep-alive with
Nagle off, and a server that runs in a background thread and can shut
itself down from a handler (``GET /stop``) or be hard-killed
(:meth:`BackgroundHTTPServer.kill`, every live connection severed). Every
server owns a :class:`~..obs.trace.Tracer`, and one given a
``health_kind`` carries a health plane (SLO engine, stall watchdog,
flight recorder); :meth:`JsonHTTPHandler.serve_obs` answers the
diagnostic routes they all share: ``GET /metrics``, ``/traces.json``,
``/health.json`` and ``/blackbox.json``.
"""

from __future__ import annotations

import json
import logging
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ..obs import expo
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer

logger = logging.getLogger(__name__)


class JsonHTTPHandler(BaseHTTPRequestHandler):
    """Request handler base for a :class:`BackgroundHTTPServer`: JSON
    responses, body draining, quiet logs."""

    protocol_version = "HTTP/1.1"
    # keep-alive small responses with Nagle on wait ~40 ms for the
    # peer's delayed ACK
    disable_nagle_algorithm = True
    #: extra labels of every ``pio_http_responses_total`` sample of this
    #: handler class (the label names are the schema; a request may set
    #: other values in ``self.response_labels``): the query server adds
    #: ``{"variant": "-"}``
    response_label_defaults: dict = {}

    def respond(
        self,
        status: int,
        payload: Any,
        content_type: str = "application/json",
        headers: Any = None,
    ) -> None:
        """Send a response: JSON payloads are dumped; ``bytes`` (and
        ``str`` for non-JSON content types) pass through. ``headers``
        adds extra response headers (``Retry-After`` on a shed 503)."""
        if isinstance(payload, bytes):
            body = payload
        elif isinstance(payload, str) and content_type != "application/json":
            body = payload.encode("utf-8")
        else:
            body = json.dumps(payload).encode("utf-8")
        labels = dict(self.response_label_defaults)
        labels.update(getattr(self, "response_labels", None) or {})
        labels["status"] = status
        self.server.metrics.counter(
            "pio_http_responses_total",
            "Responses by HTTP status",
            labelnames=tuple(sorted(labels)),
        ).inc(1, **labels)
        self.send_response(status)
        self.send_header("Content-Type", f"{content_type}; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, str(value))
        self.end_headers()
        self.wfile.write(body)

    def serve_obs(self, path: str) -> bool:
        """Answer ``GET /metrics`` (Prometheus text), ``/traces.json``
        (the span ring), ``/health.json`` (the health plane's SLO and
        stall summary) and ``/blackbox.json`` (the flight-recorder ring);
        False for any other path, and for the last two on a server that
        carries no health plane (they 404 through)."""
        server = self.server
        if path == "/metrics":
            self.respond(200, expo.render(server.metrics), content_type=expo.CONTENT_TYPE)
        elif path == "/traces.json":
            self.respond(200, {"service": server.tracer.service,
                               "spans": server.tracer.store.dump()})
        elif path == "/health.json" and server.health is not None:
            self.respond(200, server.health.health_json())
        elif path == "/blackbox.json" and server.health is not None:
            flight = server.health.flight
            self.respond(200, {"service": type(server).__name__,
                               "enabled": flight.enabled, "events": flight.dump()})
        else:
            return False
        return True

    def read_body(self) -> bytes:
        """Drain the request body — before any response on a keep-alive
        connection, or leftover bytes desync the next request."""
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s - %s", self.address_string(), fmt % args)


class BackgroundHTTPServer(ThreadingHTTPServer):
    """Threaded server with ephemeral-port introspection and background
    run. ``metrics`` is the registry ``GET /metrics`` renders, ``tracer``
    (default: one named after the class) the span ring of
    ``/traces.json``; ``health_kind`` ("query", "event", ...) attaches a
    :class:`~..obs.slo.HealthPlane` on the registry's clock, configured by
    ``health_config`` (a ``HealthConfig``; None = the environment's)."""

    daemon_threads = True
    # listen backlog: the stdlib's 5 resets connections when a burst of
    # clients connects at once; admission control (503) is the limit
    request_queue_size = 256

    def __init__(self, *args, metrics: MetricsRegistry, tracer: Optional[Tracer] = None,
                 health_kind: Optional[str] = None, health_config=None, **kwargs):
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else Tracer(type(self).__name__)
        self.metrics.gauge("pio_up", "1 while the server process is serving").set(1)
        self.health = None
        if health_kind is not None:
            from ..obs.slo import HealthPlane

            self.health = HealthPlane(self.metrics, health_kind, clock=self.metrics.clock,
                                      config=health_config)
        self._live_conns: set = set()
        self._conn_lock = threading.Lock()
        self._serving = False
        super().__init__(*args, **kwargs)
        if self.health is not None:
            # after the bind: a failed construction (port in use) leaves
            # no ticking thread behind
            self.health.start()

    def server_close(self) -> None:
        if self.health is not None:
            self.health.stop()
        super().server_close()

    # kill() severs keep-alive connections: shutdown() only stops the
    # accept loop, and handler threads on a persistent connection would
    # keep answering
    def get_request(self):
        request, client_address = super().get_request()
        with self._conn_lock:
            self._live_conns.add(request)
        return request, client_address

    def shutdown_request(self, request) -> None:
        with self._conn_lock:
            self._live_conns.discard(request)
        super().shutdown_request(request)

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._serving = True  # kill() must not shutdown() a loop never run
        super().serve_forever(poll_interval)

    def kill(self) -> None:
        """Hard stop: stop accepting and sever every live connection, the
        in-process analogue of killing the server's process (in-flight
        requests see a reset)."""
        if self._serving:
            # shutdown() waits on an event only serve_forever() sets
            self.shutdown()
        self.server_close()
        with self._conn_lock:
            conns, self._live_conns = list(self._live_conns), set()
        for request in conns:
            try:
                request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                request.close()
            except OSError:
                pass

    def handle_error(self, request, client_address) -> None:
        """Client disconnects mid-response are normal operation."""
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError, TimeoutError)):
            logger.debug("client %s dropped: %s", client_address, exc)
            return
        super().handle_error(request, client_address)

    @property
    def bound_port(self) -> int:
        return self.server_address[1]

    def start_background(self) -> threading.Thread:
        # tight poll so shutdown() returns in ~50 ms, not the stdlib's 500
        thread = threading.Thread(
            target=lambda: self.serve_forever(poll_interval=0.05), daemon=True
        )
        thread.start()
        return thread

    def stop_async(self) -> None:
        """Shut down from inside a handler thread (``GET /stop``)."""

        def stop() -> None:
            self.shutdown()
            self.server_close()

        threading.Thread(target=stop, daemon=True).start()
