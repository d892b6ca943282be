"""Shared HTTP plumbing: JSON handlers on threaded stdlib servers.

Trimmed copy of ``predictionio_tpu/api/http.py``: JSON responses with
every status counted into the server's metrics registry, ``GET
/metrics``, keep-alive with Nagle off, and a server that runs in a
background thread and can shut itself down from a handler (``GET
/stop``). Traces, the health plane and the hard-kill used by chaos drills
wait for later slices.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..obs import expo
from ..obs.metrics import MetricsRegistry

logger = logging.getLogger(__name__)


class JsonHTTPHandler(BaseHTTPRequestHandler):
    """Request handler base for a :class:`BackgroundHTTPServer`: JSON
    responses, body draining, quiet logs."""

    protocol_version = "HTTP/1.1"
    # keep-alive small responses with Nagle on wait ~40 ms for the
    # peer's delayed ACK
    disable_nagle_algorithm = True

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
        self.server.metrics.counter(
            "pio_http_responses_total",
            "Responses by HTTP status",
            labelnames=("status",),
        ).inc(1, status=status)
        self.send_response(status)
        self.send_header("Content-Type", f"{content_type}; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, str(value))
        self.end_headers()
        self.wfile.write(body)

    def serve_obs(self, path: str) -> bool:
        """Answer ``GET /metrics`` from the server's registry; False for
        any other path."""
        if path != "/metrics":
            return False
        self.respond(
            200, expo.render(self.server.metrics), content_type=expo.CONTENT_TYPE
        )
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
    run; ``metrics`` is the registry ``GET /metrics`` renders."""

    daemon_threads = True
    # listen backlog: the stdlib's 5 resets connections when a burst of
    # clients connects at once; admission control (503) is the limit
    request_queue_size = 256

    def __init__(self, *args, metrics: MetricsRegistry, **kwargs):
        self.metrics = metrics
        self.metrics.gauge("pio_up", "1 while the server process is serving").set(1)
        super().__init__(*args, **kwargs)

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
