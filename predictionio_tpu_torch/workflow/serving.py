"""Query server: REST deployment of trained engines, on the card.

Counterpart of ``predictionio_tpu/workflow/serving.py`` (rebuild of
``CreateServer.scala``), the core of it:

- ``POST /queries.json`` — decode the query, micro-batch it with its
  neighbours into one ``batch_predict`` per algorithm, combine through
  ``serve`` (``CreateServer.scala:458-577``);
- ``POST /reload`` (and the deprecated ``GET``) — hot-swap to the latest
  completed engine instance (``CreateServer.scala:300-321``);
- ``GET /status.json`` — engine, device, serving stats, breakers and the
  resolved top-k path (``topkPath``); ``GET /`` — the HTML status page
  (JSON with ``Accept: application/json``); ``GET /shard.json`` — the
  item partition this server holds; ``GET /stop``;
- ``GET /metrics``, ``/traces.json``, ``/health.json``, ``/blackbox.json``
  (``api/http.py``).

The request plane (JAX ``workflow/serving.py``): admission is bounded
(past ``max_queue`` queries in flight a new one is shed with ``503`` +
``Retry-After``); an ``X-PIO-Deadline-Ms`` budget is checked at admission
and again before the micro-batcher dispatch, and an expired query is
answered ``504 {"message", "stage"}``; every query runs under an
admission span that joins the caller's ``X-PIO-Trace`` (echoed on the
answer); with ``feedback`` each answer becomes a ``predict`` event
(``prId``, ``idempotencyKey``) POSTed to the Event Server on a two-worker
pool, and with ``log_url`` each failure is POSTed there, both through a
``RetryPolicy`` behind the ``event-server`` and ``error-log`` breakers (a
third guards ``/reload``); an open breaker leaves the server answering
from the tables on the card, ``degraded``. With ``shard_count > 1`` the
server holds item rows ``i % shard_count == shard_index`` only and
answers with their local top-k (``fleet/merge.py`` rebuilds the global
one). The deployment travels with each micro-batched item, so a reload
mid-batch is safe. The routes of rollouts and of the continuous loop
answer 404 naming their ROADMAP item (queue 1 items 6 and 9); the quality
plane is not ported (item 6).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import html
import http.client
import json
import logging
import os
import random
import string
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, List, Optional, Sequence
from urllib.parse import urlparse, urlsplit

from ..api.http import BackgroundHTTPServer, JsonHTTPHandler
from ..controller.engine import Engine, EngineParams
from ..device import DeviceLike, describe_device
from ..obs.flight import record as flight_record
from ..obs.metrics import MetricsRegistry
from ..obs.trace import TRACE_HEADER, SpanContext, Tracer, current_context
from ..ops.cuda_kernels import kernel_launches, top_k_streaming
from ..storage import StorageRegistry, utcnow
from ..storage.metadata import STATUS_COMPLETED, EngineInstance
from ..testing.faults import fault_point
from ..tools import not_ported
from ..utils.profiling import phases_from_env
from ..utils.resilience import (
    DEADLINE_HEADER,
    CircuitBreaker,
    CircuitOpen,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    deadline_scope,
)
from .batching import MicroBatcher
from .context import WorkflowContext
from .core_workflow import load_models

logger = logging.getLogger(__name__)

#: Default in-flight admission cap (``PIO_SERVING_MAX_QUEUE`` overrides).
DEFAULT_MAX_QUEUE = 128


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """``ServerConfig`` (``CreateServer.scala:71-98``) plus the device;
    query port default 8000 (``CreateServer.scala:76``)."""

    ip: str = "localhost"
    port: int = 8000
    engine_instance_id: Optional[str] = None  # None = latest COMPLETED
    engine_id: Optional[str] = None
    engine_version: Optional[str] = None
    engine_variant: str = "engine.json"
    #: post a ``predict`` event for each answer to the Event Server
    #: (``CreateServer.scala:505-565``)
    feedback: bool = False
    event_server_ip: str = "localhost"
    event_server_port: int = 7070
    access_key: Optional[str] = None
    batch: str = ""
    #: concurrent queries aggregate for <= batch_wait_ms (at most
    #: batch_max of them) into one batched device dispatch — the
    #: accelerator replacement for the reference's per-request predictBase
    batch_max: int = 512
    batch_wait_ms: float = 1.0
    #: batches in flight at once (one's results travel back while the
    #: next is dispatched)
    batch_pipeline_depth: int = 2
    #: max queries in flight before new arrivals shed with 503 +
    #: Retry-After; None = ``PIO_SERVING_MAX_QUEUE`` env (default
    #: ``DEFAULT_MAX_QUEUE``); 0 = unbounded
    max_queue: Optional[int] = None
    #: serving failures POST ``{engineInstance, message, query}`` here
    #: (``--log-url``, ``CreateServer.scala:409-420``); None = off
    log_url: Optional[str] = None
    #: the health plane's knobs, an ``obs.slo.HealthConfig``; None = the
    #: environment's (``PIO_ALERT_LEDGER``, ``PIO_FLIGHT_DIR``, ``PIO_SLO_TICK_S``)
    health: Optional[Any] = None
    #: sharded serving: with ``shard_count > 1`` this server holds item
    #: rows ``i % shard_count == shard_index`` only; every algorithm must
    #: implement ``shard_model``, or the deploy fails
    shard_index: int = 0
    shard_count: int = 1
    #: where the models' tables live: None = ``cuda:0`` (raises without
    #: CUDA); "cpu" only when asked for
    device: DeviceLike = None


def decode_query(algorithms: Sequence[Any], payload: Any) -> Any:
    """Decode a JSON query with the first algorithm's query class (plain
    dicts pass through, like json4s ``DefaultFormats``)."""
    for algo in algorithms:
        cls = algo.query_class()
        if cls is not None:
            if dataclasses.is_dataclass(cls):
                fields = {f.name for f in dataclasses.fields(cls)}
                return cls(**{k: v for k, v in payload.items() if k in fields})
            return cls(**payload)
    return payload


def encode_result(obj: Any) -> Any:
    """Prediction → JSON-compatible structure (``to_json_dict`` controls
    a result type's wire shape, ``CreateServer.scala:475-478``)."""
    if obj is None or type(obj) in (str, int, float, bool):
        return obj
    if hasattr(obj, "to_json_dict") and not isinstance(obj, type):
        return encode_result(obj.to_json_dict())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: encode_result(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: encode_result(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_result(v) for v in obj]
    if hasattr(obj, "tolist"):
        return obj.tolist()  # numpy arrays / tensors
    return obj


def _gen_pr_id() -> str:
    """64 alphanumeric characters (``CreateServer.scala:513``)."""
    alphabet = string.ascii_letters + string.digits
    return "".join(random.choice(alphabet) for _ in range(64))


def _get_pr_id(obj: Any) -> Optional[str]:
    """The ``WithPrId`` protocol: a ``pr_id`` attribute or a ``prId`` key."""
    if isinstance(obj, dict):
        return obj.get("prId")
    return getattr(obj, "pr_id", None)


def _has_pr_id(obj: Any) -> bool:
    return (isinstance(obj, dict) and "prId" in obj) or hasattr(obj, "pr_id")


class ServingStats:
    """Thread-safe serving counters backed by the metrics registry:
    request count and mean (the reference's status page), a log-scale
    latency histogram (``pio_serving_request_seconds``, p50/p95/p99) and
    every resilience outcome (``pio_serving_events_total{kind}``): shed
    admissions, expired deadlines, retries, feedback and error-log
    deliveries that failed or that an open breaker skipped."""

    _COUNTERS = (
        "shed",
        "deadline_expired",
        "retries",
        "feedback_sent",
        "feedback_failures",
        "feedback_skipped",
        "error_log_failures",
        "error_log_skipped",
    )

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics
        self._hist = self.metrics.histogram(
            "pio_serving_request_seconds", "End-to-end /queries.json latency"
        )
        self._events = self.metrics.counter(
            "pio_serving_events_total", "Serving resilience outcomes", labelnames=("kind",)
        )
        self._lock = threading.Lock()
        self.request_count = 0
        self.last_serving_sec = 0.0
        self.avg_serving_sec = 0.0
        self._counts = dict.fromkeys(self._COUNTERS, 0)

    def record_request(self, elapsed_s: float) -> None:
        with self._lock:
            self.last_serving_sec = elapsed_s
            self.avg_serving_sec = (
                self.avg_serving_sec * self.request_count + elapsed_s
            ) / (self.request_count + 1)
            self.request_count += 1
        self._hist.observe(elapsed_s)

    def inc(self, counter: str) -> None:
        if counter not in self._counts:
            raise ValueError(f"unknown serving counter {counter!r}")
        with self._lock:
            self._counts[counter] += 1
        self._events.inc(1, kind=counter)  # a closed set: a safe label

    def count(self, counter: str) -> int:
        with self._lock:
            return self._counts[counter]

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "requests": self.request_count,
                "lastServingMs": round(self.last_serving_sec * 1000, 3),
                "avgServingMs": round(self.avg_serving_sec * 1000, 3),
            }
            for name, value in self._counts.items():
                head, *rest = name.split("_")
                out[head + "".join(p.title() for p in rest)] = value
        for key, q in (("p50Ms", 0.50), ("p95Ms", 0.95), ("p99Ms", 0.99)):
            out[key] = round(self._hist.percentile(q) * 1000.0, 3)
        return out


@dataclasses.dataclass
class Deployment:
    """One live engine instance: algorithms + models on the device +
    serving combiner (``CreateServer.scala:184-248``)."""

    instance: EngineInstance
    engine_params: EngineParams
    algorithms: List[Any]
    models: List[Any]
    serving: Any


def prepare_deployment(
    engine: Engine,
    registry: StorageRegistry,
    config: ServerConfig,
    ctx: Optional[WorkflowContext] = None,
) -> Deployment:
    """Load the target engine instance and make its models live on
    ``ctx.device`` (``CreateServer.scala:184-248`` +
    ``Engine.prepareDeploy``): a manifest's model loads itself, and an
    instance that stored ``RETRAIN`` is trained again here, under this
    serving context — on ``ctx.device``, from the DataSource's store
    (the process-wide registry's, as in training), with the instance's
    stored params and so their seed; ``/reload`` does it again. With
    ``shard_count > 1`` each model is cut to its shard
    (:func:`_shard_models`). Then each algorithm's ``prepare_serving``
    moves its model's tables to the device once."""
    md = registry.get_metadata()
    if config.engine_instance_id:
        instance = md.engine_instance_get(config.engine_instance_id)
        if instance is None:
            raise KeyError(f"Engine instance {config.engine_instance_id} not found")
    else:
        instance = md.engine_instance_get_latest_completed(
            config.engine_id or "default",
            config.engine_version or "1",
            config.engine_variant,
        )
        if instance is None:
            raise RuntimeError(
                "No completed engine instance found; run train first "
                "(Console.scala:742-780)"
            )
    if instance.status != STATUS_COMPLETED:
        raise RuntimeError(
            f"Engine instance {instance.id} has status {instance.status}, "
            "not COMPLETED"
        )
    ctx = ctx or WorkflowContext(mode="Serving", batch=config.batch,
                                 device=config.device)
    engine_params = engine.engine_instance_to_engine_params(instance)
    persisted = load_models(registry, instance.id)
    live_models = engine.prepare_deploy(ctx, engine_params, instance.id, persisted)
    algorithms = engine._algorithms(engine_params)
    if config.shard_count > 1:
        live_models = _shard_models(algorithms, live_models, config)
    for algo, model in zip(algorithms, live_models):
        algo.prepare_serving(model, ctx)
    return Deployment(
        instance=instance,
        engine_params=engine_params,
        algorithms=algorithms,
        models=live_models,
        serving=engine._serving(engine_params),
    )


def _shard_models(algorithms: Sequence[Any], models: List[Any],
                  config: ServerConfig) -> List[Any]:
    """Each live model replaced by its ``shard_index``-of-``shard_count``
    partition (JAX ``workflow/serving.py:398-427``). A server that held
    the whole catalog on a sharded fleet would make the merged top-k
    wrong (items counted twice), so an algorithm without ``shard_model``
    fails the deploy, not the first query."""
    if not 0 <= config.shard_index < config.shard_count:
        raise ValueError(
            f"shard_index {config.shard_index} out of range for "
            f"shard_count {config.shard_count}"
        )
    sharded = []
    for algo, model in zip(algorithms, models):
        shard = getattr(algo, "shard_model", None)
        if shard is None:
            raise ValueError(
                f"{type(algo).__name__} does not implement shard_model; "
                "this engine cannot serve in sharded mode"
            )
        sharded.append(shard(model, config.shard_index, config.shard_count))
    return sharded


class QueryDecodeError(ValueError):
    """Query JSON does not fit the engine's query shape → 400
    (``CreateServer.scala:578-585``)."""


#: routes of modules that are not ported: path → (what, ROADMAP item)
_NOT_PORTED_ROUTES = {
    "/rollout/start": ("rollouts", 6),
    "/rollout/promote": ("rollouts", 6),
    "/rollout/abort": ("rollouts", 6),
    "/rollout.json": ("rollouts", 6),
    "/continuous/start": ("the continuous-learning loop", 9),
    "/continuous/pause": ("the continuous-learning loop", 9),
    "/continuous/trigger": ("the continuous-learning loop", 9),
    "/continuous.json": ("the continuous-learning loop", 9),
}


class _QueryHandler(JsonHTTPHandler):
    server: "QueryServer"

    def do_POST(self) -> None:  # noqa: N802
        raw = self.read_body()
        path = urlparse(self.path).path
        if path == "/queries.json":
            self._handle_queries(raw)
        elif path == "/reload":
            self._handle_reload()
        else:
            self._not_found(path)

    def _not_found(self, path: str) -> None:
        if path in _NOT_PORTED_ROUTES:
            what, item = _NOT_PORTED_ROUTES[path]
            self.respond(404, {"message": str(not_ported(f"`{path}` ({what})", item))})
        else:
            self.respond(404, {"message": "Not Found"})

    def _handle_queries(self, raw: bytes) -> None:
        try:
            payload = json.loads(raw.decode("utf-8")) if raw else {}
        except ValueError as exc:
            self.respond(400, {"message": str(exc)})
            return
        # bounded admission before any engine work: at the cap the answer
        # is an instant 503, not another thread on a saturated device
        if not self.server.admit():
            self.server.stats.inc("shed")
            self.respond(
                503,
                {"message": "server overloaded; shedding load"},
                headers={"Retry-After": self.server.retry_after_s()},
            )
            return
        deadline = Deadline.from_header(
            self.headers.get(DEADLINE_HEADER), clock=self.server.clock
        )
        span = None
        try:
            if deadline is not None:
                # a budget already gone spends no decode or supplement work
                deadline.check("admission")
            # the admission span joins the client's X-PIO-Trace (or roots
            # a fresh trace) and is ambient for the request, so the
            # batcher's spans and the feedback delivery join it
            with self.server.tracer.server_span(
                "POST /queries.json", header_value=self.headers.get(TRACE_HEADER)
            ) as span:
                result = self.server.handle_query(payload, deadline)
            self.respond(200, result, headers={TRACE_HEADER: span.trace_id})
        except DeadlineExceeded as exc:
            self.server.stats.inc("deadline_expired")
            self.respond(504, {"message": str(exc), "stage": exc.stage})
        except QueryDecodeError as exc:
            # the reference posts the bad-query branch to the log too
            # (CreateServer.scala:583-590)
            self.server.post_error_log(str(exc), payload, trace_ctx=span)
            self.respond(400, {"message": str(exc)})
        except Exception as exc:
            logger.exception("Query failed")
            self.server.post_error_log(str(exc), payload, trace_ctx=span)
            self.respond(500, {"message": str(exc)})
        finally:
            self.server.release()

    def _handle_reload(self) -> None:
        try:
            self.server.reload()
            self.respond(200, {"message": "Reloaded"})
        except Exception as exc:
            logger.exception("Reload failed")
            self.respond(500, {"message": str(exc)})

    def do_GET(self) -> None:  # noqa: N802
        path = urlparse(self.path).path
        if self.serve_obs(path):
            return
        if path == "/status.json" or (
            path == "/" and "application/json" in self.headers.get("Accept", "")
        ):
            self.respond(200, self.server.status_json())
        elif path == "/":
            self.respond(200, self.server.status_html(), content_type="text/html")
        elif path == "/shard.json":
            self.respond(200, self.server.shard_json())
        elif path == "/reload":
            # deprecated spelling, kept for CreateServer parity
            self._handle_reload()
        elif path == "/stop":
            self.respond(200, {"message": "Shutting down"})
            self.server.stop_async()
        else:
            self._not_found(path)


class QueryServer(BackgroundHTTPServer):
    """The serving process (``CreateServer.scala:250-628``). ``clock``,
    ``retry_policy`` and the three breakers are injectable (defaults: the
    monotonic clock, 3 attempts with 50 ms base backoff, ``PIO_BREAKER_*``)."""

    def __init__(
        self,
        config: ServerConfig,
        engine: Engine,
        registry: StorageRegistry,
        clock: Callable[[], float] = time.monotonic,
        retry_policy: Optional[RetryPolicy] = None,
        feedback_breaker: Optional[CircuitBreaker] = None,
        error_log_breaker: Optional[CircuitBreaker] = None,
        reload_breaker: Optional[CircuitBreaker] = None,
    ):
        self.config = config
        self.engine = engine
        self.registry = registry
        self.clock = clock
        self.ctx = WorkflowContext(mode="Serving", batch=config.batch,
                                   device=config.device)
        self._deploy_lock = threading.Lock()
        self.deployment = prepare_deployment(engine, registry, config, self.ctx)
        metrics = MetricsRegistry(clock=clock)
        self.stats = ServingStats(metrics)
        metrics.gauge_callback(
            "pio_topk_kernel_launches",
            lambda: top_k_streaming.launches,
            "Streaming top-k CUDA kernel launches in this process",
        )
        self._retry = retry_policy or RetryPolicy(
            attempts=3, base_delay_s=0.05, max_delay_s=1.0,
            on_retry=lambda _i: self.stats.inc("retries"),
        )
        self.feedback_breaker = feedback_breaker or CircuitBreaker.from_env(
            "event-server", clock=clock)
        self.error_log_breaker = error_log_breaker or CircuitBreaker.from_env(
            "error-log", clock=clock)
        self.reload_breaker = reload_breaker or CircuitBreaker.from_env(
            "reload", clock=clock)
        # breaker states and lifetime opens, pulled at scrape time
        for dep, breaker in self._breakers():
            metrics.gauge_callback(
                "pio_breaker_state", (lambda b=breaker: b.state_value),
                "Breaker state (0 closed, 1 half-open, 2 open)", labels={"dep": dep},
            )
            metrics.gauge_callback(
                "pio_breaker_opens", (lambda b=breaker: b.open_count),
                "Lifetime breaker open transitions", labels={"dep": dep},
            )
        # every swallowed observer exception is counted, never only logged
        self._observer_errors = metrics.counter(
            "pio_observer_errors_total",
            "Swallowed observer/monitor exceptions by site",
            labelnames=("site",),
        )
        if config.max_queue is not None:
            self._max_queue = config.max_queue
        else:
            self._max_queue = int(
                os.environ.get("PIO_SERVING_MAX_QUEUE", str(DEFAULT_MAX_QUEUE))
            )
        self._admission_lock = threading.Lock()
        self._inflight = 0
        # bounded delivery of feedback events and error-log posts
        self._feedback_pool = ThreadPoolExecutor(max_workers=2,
                                                 thread_name_prefix="feedback")
        tracer = Tracer("query-server", clock=clock)
        self._batcher = MicroBatcher(
            self._predict_batch,
            max_batch=config.batch_max,
            max_wait_ms=config.batch_wait_ms,
            name="predict-batch",
            pipeline_depth=config.batch_pipeline_depth,
            metrics=metrics,
            tracer=tracer,
            clock=clock,
        )
        self.server_start_time = utcnow()
        try:
            super().__init__((config.ip, config.port), _QueryHandler, metrics=metrics,
                             tracer=tracer, health_kind="query",
                             health_config=config.health)
        except OSError:
            self._batcher.close()
            self._feedback_pool.shutdown(wait=False)
            raise
        self._export_train_phases()

    def _breakers(self):
        return (("event-server", self.feedback_breaker),
                ("error-log", self.error_log_breaker),
                ("reload", self.reload_breaker))

    # -- admission (bounded queue → shed, never pile up) -------------------
    def admit(self) -> bool:
        if self._max_queue <= 0:  # 0 = unbounded
            return True
        with self._admission_lock:
            if self._inflight >= self._max_queue:
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        if self._max_queue <= 0:
            return
        with self._admission_lock:
            self._inflight = max(0, self._inflight - 1)

    def retry_after_s(self) -> int:
        """Retry-After for a shed request: about one worst-case batch
        drain, floored at 1 s (HTTP's resolution)."""
        return max(1, int(self.stats.avg_serving_sec * 2 + 0.999))

    @property
    def degraded(self) -> bool:
        """True while any dependency breaker is not closed: the server
        still answers from the tables on the card, but its feedback,
        error-log or reload plane is impaired."""
        return any(b.state != CircuitBreaker.CLOSED for _, b in self._breakers())

    # -- query path (CreateServer.scala:458-577) --------------------------
    def handle_query(self, payload: Any, deadline: Optional[Deadline] = None) -> Any:
        """One query end to end, tracked by the stall watchdog with its
        deadline's budget."""
        watchdog = self.health.watchdog if self.health is not None else None
        token = None
        if watchdog is not None:
            token = watchdog.enter(
                "serving.request",
                budget_s=deadline.remaining_s() if deadline is not None else None,
            )
        try:
            return self._handle_query_tracked(payload, deadline)
        finally:
            if watchdog is not None:
                watchdog.exit(token)

    def _handle_query_tracked(self, payload: Any, deadline: Optional[Deadline]) -> Any:
        started = time.monotonic()
        query_time = utcnow()
        with self._deploy_lock:
            dep = self.deployment
        with deadline_scope(deadline):
            try:
                query = decode_query(dep.algorithms, payload)
            except (TypeError, AttributeError, KeyError) as exc:
                raise QueryDecodeError(f"Invalid query: {exc}") from exc
            query = dep.serving.supplement(query)
            if deadline is not None:
                # an expired query never takes a slot on the card
                deadline.check("dispatch")
            fault_point("serving.predict", instance=dep.instance.id)
            try:
                predictions = self._batcher.submit(
                    (dep, query),
                    timeout=deadline.remaining_s() if deadline is not None else None,
                )
            except FutureTimeoutError:
                raise DeadlineExceeded(
                    "deadline exceeded waiting for batched dispatch", stage="batch-wait"
                ) from None
            prediction = dep.serving.serve(query, predictions)
        result = encode_result(prediction)
        if self.config.feedback:
            result = self._send_feedback(dep, query_time, query, prediction, result)
        self.stats.record_request(time.monotonic() - started)
        return result

    @staticmethod
    def _predict_one(dep: Deployment, query: Any) -> List[Any]:
        """One query through every algorithm (the per-query retry of a
        failed batch)."""
        return [
            algo.predict(model, query)
            for algo, model in zip(dep.algorithms, dep.models)
        ]

    @staticmethod
    def _predict_batch(items: Sequence[Any]) -> List[Any]:
        """Micro-batched items ``(deployment, query)`` → per-item list of
        per-algorithm predictions: one ``batch_predict`` per algorithm
        per deployment (a reload mid-batch can leave two generations in
        one batch). If a group's batch fails, it is retried query by
        query so only the queries that fail carry their exception."""
        out: List[Any] = [None] * len(items)
        groups: dict = {}
        for pos, (dep, query) in enumerate(items):
            groups.setdefault(id(dep), (dep, []))[1].append((pos, query))
        for dep, indexed in groups.values():
            try:
                per_algo = [
                    dict(algo.batch_predict(model, indexed))
                    for algo, model in zip(dep.algorithms, dep.models)
                ]
                for pos, _query in indexed:
                    out[pos] = [results[pos] for results in per_algo]
            except Exception:
                for pos, query in indexed:
                    try:
                        out[pos] = QueryServer._predict_one(dep, query)
                    except Exception as exc:
                        out[pos] = exc
        return out

    # -- feedback and the error log (CreateServer.scala:409-420, 505-565) --
    def _post_json(self, site: str, url: str, data: Any,
                   trace_ctx: Optional[SpanContext] = None) -> None:
        """One retried JSON POST to a sink; raises on the final failure,
        so the caller's breaker counts one failure per delivery, not per
        attempt. Retrying a write is safe: feedback events carry an
        ``idempotencyKey`` and the error log is append-only. Under a
        ``trace_ctx`` (the request's, captured before the thread hop) the
        delivery records a child span and forwards the trace id."""
        parts = urlsplit(url)
        target = parts.path + (f"?{parts.query}" if parts.query else "")
        body = json.dumps(data).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if trace_ctx is not None:
            headers[TRACE_HEADER] = trace_ctx.trace_id

        def attempt() -> None:
            fault_point(site, url=url)
            conn = http.client.HTTPConnection(parts.hostname, parts.port or 80, timeout=10)
            try:
                conn.request("POST", target or "/", body, headers)
                resp = conn.getresponse()
                resp.read()
            finally:
                conn.close()
            if resp.status not in (200, 201):
                raise RuntimeError(f"{site} POST -> HTTP {resp.status}")

        if trace_ctx is None:
            self._retry.call(attempt)
            return
        with self.tracer.span(site, parent=trace_ctx):
            self._retry.call(attempt)

    def post_error_log(self, message: str, payload: Any,
                       trace_ctx: Optional[SpanContext] = None) -> None:
        """Fire-and-forget POST of a serving failure to ``log_url`` on the
        bounded pool; a dead sink trips ``error_log_breaker`` so an error
        storm stops paying connect timeouts. Never fails the request."""
        url = self.config.log_url
        if not url:
            return
        data = {"engineInstance": self.deployment.instance.id,
                "message": message, "query": payload}
        if trace_ctx is None:
            trace_ctx = current_context()  # captured before the thread hop

        def send() -> None:
            try:
                self.error_log_breaker.call(self._post_json, "serving.error_log", url,
                                            data, trace_ctx=trace_ctx)
            except CircuitOpen:
                self.stats.inc("error_log_skipped")
            except Exception:
                self.stats.inc("error_log_failures")
                logger.debug("error-log POST to %s failed", url, exc_info=True)

        try:
            self._feedback_pool.submit(send)
        except RuntimeError:
            logger.debug("error-log skipped: the pool is closed")

    def _send_feedback(self, dep: Deployment, query_time: _dt.datetime, query: Any,
                       prediction: Any, result: Any) -> Any:
        """A ``predict`` event to the Event Server, delivered on the pool
        (``CreateServer.scala:505-565``). Its ``prId`` is also its
        ``idempotencyKey``, so a retried POST inserts one event. With no
        rollout in the port every event's variant is the baseline."""
        new_pr_id = _get_pr_id(prediction) or _gen_pr_id()
        data = {
            "event": "predict",
            "eventTime": query_time.isoformat(timespec="milliseconds"),
            "entityType": "pio_pr",
            "entityId": new_pr_id,
            "properties": {
                "engineInstanceId": dep.instance.id,
                "query": encode_result(query),
                "prediction": encode_result(prediction),
                "variant": "baseline",
            },
            "idempotencyKey": new_pr_id,
        }
        query_pr_id = _get_pr_id(query)
        if query_pr_id is not None:
            data["prId"] = query_pr_id
        url = (f"http://{self.config.event_server_ip}:{self.config.event_server_port}"
               f"/events.json?accessKey={self.config.access_key or ''}")
        self._feedback_pool.submit(self._deliver_feedback, url, data, current_context())
        # the generated prId goes into the answer only where the
        # prediction has a prId slot (CreateServer.scala:558-565)
        if _has_pr_id(prediction) and isinstance(result, dict):
            result = dict(result)
            result.pop("pr_id", None)
            result["prId"] = new_pr_id
        return result

    def _deliver_feedback(self, url: str, data: dict,
                          trace_ctx: Optional[SpanContext] = None) -> None:
        """Breaker-guarded, retried delivery (pool thread). While the Event
        Server is down the breaker opens and later events are skipped
        (counted, not attempted): queries keep their speed."""
        try:
            self.feedback_breaker.call(self._post_json, "serving.feedback", url, data,
                                       trace_ctx=trace_ctx)
            self.stats.inc("feedback_sent")
        except CircuitOpen:
            self.stats.inc("feedback_skipped")
        except Exception as exc:
            self.stats.inc("feedback_failures")
            logger.error("Feedback event failed: %s", exc)

    # -- lifecycle --------------------------------------------------------
    def server_close(self) -> None:
        self._batcher.close()  # fail queued requests fast, join thread
        self._feedback_pool.shutdown(wait=False)
        super().server_close()

    def reload(self) -> None:
        """Hot-swap to the latest completed instance of the deployed
        engine (``CreateServer.scala:300-321``): the new tables are
        staged on the device first, then the reference swaps. Failures
        ride ``reload_breaker``; the resident tables keep serving."""
        cur = self.deployment.instance
        cfg = dataclasses.replace(
            self.config,
            engine_instance_id=None,
            engine_id=cur.engine_id,
            engine_version=cur.engine_version,
            engine_variant=cur.engine_variant,
        )
        fresh = self.reload_breaker.call(
            prepare_deployment, self.engine, self.registry, cfg, self.ctx)
        with self._deploy_lock:
            old = self.deployment.instance.id
            self.deployment = fresh
        self._export_train_phases()
        flight_record("deploy", "serving.reload", fromInstance=old,
                      toInstance=fresh.instance.id)
        logger.info("Reloaded: engine instance %s -> %s", old, fresh.instance.id)

    def _export_train_phases(self) -> None:
        """The deployed instance's training phase timings as
        ``pio_train_phase_seconds{phase}`` (JAX ``serving.py:1394-1412``);
        the previous export is cleared first, so after a reload the
        series describe the instance deployed. A failure is counted on
        ``pio_observer_errors_total``, never raised."""
        gauge = self.metrics.gauge(
            "pio_train_phase_seconds",
            "Wall-clock of each training phase of the deployed instance",
            labelnames=("phase",),
        )
        try:
            phases = phases_from_env(self.deployment.instance.env)
            gauge.clear()
            for name, seconds in phases.items():
                gauge.set(seconds, phase=name)
        except Exception:
            self._observer_errors.inc(1, site="serving.train_phases")
            logger.debug("train-phase export failed", exc_info=True)

    # -- status (CreateServer.scala:421-456) ------------------------------
    def shard_json(self) -> dict:
        """``GET /shard.json``: which item partition this server holds
        and how many item rows each model keeps (None for a model with
        no ``item_factors``)."""
        with self._deploy_lock:
            dep = self.deployment
        return {
            "sharded": self.config.shard_count > 1,
            "shardIndex": self.config.shard_index,
            "shardCount": self.config.shard_count,
            "engineInstance": dep.instance.id,
            "models": [
                {"type": type(m).__name__,
                 "items": (len(m.item_factors)
                           if getattr(m, "item_factors", None) is not None else None)}
                for m in dep.models
            ],
        }

    def status_json(self) -> dict:
        with self._deploy_lock:
            dep = self.deployment
        degraded = self.degraded
        out = {
            "status": "degraded" if degraded else "alive",
            "degraded": degraded,
            "engineInstance": dep.instance.id,
            "engine": {
                "id": dep.instance.engine_id,
                "version": dep.instance.engine_version,
                "factory": dep.instance.engine_factory,
            },
            "device": describe_device(self.ctx.device),
            "startTime": str(self.server_start_time),
            "feedback": self.config.feedback,
            "maxQueue": self._max_queue,
            "stats": self.stats.snapshot(),
            "breakers": {
                "eventServer": self.feedback_breaker.snapshot(),
                "errorLog": self.error_log_breaker.snapshot(),
                "reload": self.reload_breaker.snapshot(),
            },
            "kernelLaunches": kernel_launches(),
        }
        if self.config.shard_count > 1:
            out["shard"] = {"index": self.config.shard_index,
                            "count": self.config.shard_count}
        # resolved top-k path per algorithm ("streaming" = the CUDA
        # kernel, "dense" = matmul + sort; absent until the first query)
        topk = {
            f"{idx}:{type(algo).__name__}": algo.topk_path
            for idx, algo in enumerate(dep.algorithms)
            if getattr(algo, "topk_path", None) is not None
        }
        if topk:
            out["topkPath"] = topk
        out["batching"] = self._batcher.stats
        phases = phases_from_env(dep.instance.env)
        if phases:
            out["trainPhases"] = phases
        return out

    def status_html(self) -> str:
        """``GET /``: the reference's status page (``index.scala.html``)."""
        with self._deploy_lock:
            dep = self.deployment
        stats = self.stats.snapshot()
        bs = self._batcher.stats
        rows = [
            ("Engine instance", dep.instance.id),
            ("Engine", f"{dep.instance.engine_id} {dep.instance.engine_version}"),
            ("Engine factory", dep.instance.engine_factory),
            ("Device", describe_device(self.ctx.device)),
            ("Start time", str(self.server_start_time)),
            ("Algorithms", ", ".join(type(a).__name__ for a in dep.algorithms)),
            ("Models", ", ".join(type(m).__name__ for m in dep.models)),
            ("Serving", type(dep.serving).__name__),
            ("Feedback enabled", str(self.config.feedback)),
            ("Request count", str(stats["requests"])),
            ("Average serving time", f"{stats['avgServingMs']:.3f} ms"),
            ("Last serving time", f"{stats['lastServingMs']:.3f} ms"),
            ("Degraded", str(self.degraded)),
            ("Shed requests", str(stats["shed"])),
            ("Expired deadlines", str(stats["deadlineExpired"])),
            ("Breakers", ", ".join(f"{name}={b.state}" for name, b in self._breakers())),
            ("Shard", f"{self.config.shard_index} of {self.config.shard_count}"),
            ("Micro-batching",
             f"{bs['batches']} batches, avg {bs['avg_batch']:.1f} queries/batch"),
        ]
        cells = "".join(
            f"<tr><th>{html.escape(k)}</th><td>{html.escape(v)}</td></tr>" for k, v in rows
        )
        return (
            "<!DOCTYPE html><html><head><title>"
            f"{html.escape(dep.instance.engine_id)} - predictionio_tpu_torch engine "
            "server</title></head><body>"
            "<h1>PredictionIO-TPU Engine Server (PyTorch/CUDA)</h1>"
            f"<table>{cells}</table>"
            "<p>POST JSON queries to <code>/queries.json</code>; "
            "<a href=\"/reload\">reload</a> latest model.</p>"
            "</body></html>"
        )


def create_query_server(
    engine: Engine,
    config: ServerConfig = ServerConfig(),
    registry: Optional[StorageRegistry] = None,
    block: bool = True,
) -> QueryServer:
    """Deploy an engine (``CreateServer.main``, ``CreateServer.scala:100-182``).
    With ``block=False`` the server answers from a background thread and
    the caller owns its shutdown (``shutdown()`` + ``server_close()``)."""
    from ..storage.registry import get_registry

    registry = registry or get_registry()
    server = QueryServer(config, engine, registry)
    logger.info(
        "Query server: engine instance %s on %s:%d (%s)",
        server.deployment.instance.id, config.ip, server.bound_port,
        describe_device(server.ctx.device),
    )
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
    else:
        server.start_background()
    return server
