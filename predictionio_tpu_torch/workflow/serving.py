"""Query server: REST deployment of trained engines, on the card.

Counterpart of ``predictionio_tpu/workflow/serving.py`` (rebuild of
``CreateServer.scala``), the core of it:

- ``POST /queries.json`` — decode the query, micro-batch it with its
  neighbours into one ``batch_predict`` per algorithm, combine through
  ``serve`` (``CreateServer.scala:458-577``);
- ``POST /reload`` (and the deprecated ``GET``) — hot-swap to the latest
  completed engine instance (``CreateServer.scala:300-321``);
- ``GET /status.json`` — engine, device, serving stats and the resolved
  top-k path (``topkPath``); ``GET /metrics``; ``GET /stop``.

Admission is bounded: past ``max_queue`` queries in flight a new one is
shed with ``503`` + ``Retry-After`` instead of piling up threads. The
deployment travels with each micro-batched item, so a reload mid-batch is
safe. Feedback events, rollouts, the continuous loop, the quality and
health planes, deadlines, breakers and sharded serving wait for later
slices.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

from ..api.http import BackgroundHTTPServer, JsonHTTPHandler
from ..controller.engine import Engine, EngineParams
from ..device import DeviceLike, describe_device
from ..obs.metrics import MetricsRegistry
from ..ops.cuda_kernels import top_k_streaming
from ..storage import StorageRegistry, utcnow
from ..storage.metadata import STATUS_COMPLETED, EngineInstance
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


class ServingStats:
    """Thread-safe serving counters backed by the metrics registry:
    request count and mean (the reference's status page), a log-scale
    latency histogram (``pio_serving_request_seconds``, p50/p95/p99) and
    the shed count (``pio_serving_events_total{kind="shed"}``)."""

    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics
        self._hist = self.metrics.histogram(
            "pio_serving_request_seconds", "End-to-end /queries.json latency"
        )
        self._events = self.metrics.counter(
            "pio_serving_events_total", "Serving outcomes", labelnames=("kind",)
        )
        self._lock = threading.Lock()
        self.request_count = 0
        self.last_serving_sec = 0.0
        self.avg_serving_sec = 0.0
        self.shed = 0

    def record_request(self, elapsed_s: float) -> None:
        with self._lock:
            self.last_serving_sec = elapsed_s
            self.avg_serving_sec = (
                self.avg_serving_sec * self.request_count + elapsed_s
            ) / (self.request_count + 1)
            self.request_count += 1
        self._hist.observe(elapsed_s)

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1
        self._events.inc(1, kind="shed")

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "requests": self.request_count,
                "lastServingMs": round(self.last_serving_sec * 1000, 3),
                "avgServingMs": round(self.avg_serving_sec * 1000, 3),
                "shed": self.shed,
            }
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
    stored params and so their seed; ``/reload`` does it again. Then each
    algorithm's ``prepare_serving`` moves its model's tables to the
    device once."""
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
    for algo, model in zip(algorithms, live_models):
        algo.prepare_serving(model, ctx)
    return Deployment(
        instance=instance,
        engine_params=engine_params,
        algorithms=algorithms,
        models=live_models,
        serving=engine._serving(engine_params),
    )


class QueryDecodeError(ValueError):
    """Query JSON does not fit the engine's query shape → 400
    (``CreateServer.scala:578-585``)."""


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
            self.server.stats.record_shed()
            self.respond(
                503,
                {"message": "server overloaded; shedding load"},
                headers={"Retry-After": self.server.retry_after_s()},
            )
            return
        try:
            result = self.server.handle_query(payload)
            self.respond(200, result)
        except QueryDecodeError as exc:
            self.respond(400, {"message": str(exc)})
        except Exception as exc:
            logger.exception("Query failed")
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
        if path in ("/", "/status.json"):
            self.respond(200, self.server.status_json())
        elif path == "/reload":
            # deprecated spelling, kept for CreateServer parity
            self._handle_reload()
        elif path == "/stop":
            self.respond(200, {"message": "Shutting down"})
            self.server.stop_async()
        else:
            self.respond(404, {"message": "Not Found"})


class QueryServer(BackgroundHTTPServer):
    """The serving process (``CreateServer.scala:250-628``)."""

    def __init__(
        self,
        config: ServerConfig,
        engine: Engine,
        registry: StorageRegistry,
    ):
        self.config = config
        self.engine = engine
        self.registry = registry
        self.ctx = WorkflowContext(mode="Serving", batch=config.batch,
                                   device=config.device)
        self._deploy_lock = threading.Lock()
        self.deployment = prepare_deployment(engine, registry, config, self.ctx)
        metrics = MetricsRegistry()
        self.stats = ServingStats(metrics)
        metrics.gauge_callback(
            "pio_topk_kernel_launches",
            lambda: top_k_streaming.launches,
            "Streaming top-k CUDA kernel launches in this process",
        )
        if config.max_queue is not None:
            self._max_queue = config.max_queue
        else:
            self._max_queue = int(
                os.environ.get("PIO_SERVING_MAX_QUEUE", str(DEFAULT_MAX_QUEUE))
            )
        self._admission_lock = threading.Lock()
        self._inflight = 0
        self._batcher = MicroBatcher(
            self._predict_batch,
            max_batch=config.batch_max,
            max_wait_ms=config.batch_wait_ms,
            name="predict-batch",
            pipeline_depth=config.batch_pipeline_depth,
            metrics=metrics,
        )
        self.server_start_time = utcnow()
        try:
            super().__init__((config.ip, config.port), _QueryHandler,
                             metrics=metrics)
        except OSError:
            self._batcher.close()
            raise

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

    # -- query path (CreateServer.scala:458-577) --------------------------
    def handle_query(self, payload: Any) -> Any:
        started = time.monotonic()
        with self._deploy_lock:
            dep = self.deployment
        try:
            query = decode_query(dep.algorithms, payload)
        except (TypeError, AttributeError, KeyError) as exc:
            raise QueryDecodeError(f"Invalid query: {exc}") from exc
        query = dep.serving.supplement(query)
        predictions = self._batcher.submit((dep, query))
        result = encode_result(dep.serving.serve(query, predictions))
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
    def _predict_batch(items: Sequence[Tuple[Deployment, Any]]) -> List[Any]:
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

    # -- lifecycle --------------------------------------------------------
    def server_close(self) -> None:
        self._batcher.close()  # fail queued requests fast, join thread
        super().server_close()

    def reload(self) -> None:
        """Hot-swap to the latest completed instance of the deployed
        engine (``CreateServer.scala:300-321``): the new tables are
        staged on the device first, then the reference swaps."""
        cur = self.deployment.instance
        cfg = dataclasses.replace(
            self.config,
            engine_instance_id=None,
            engine_id=cur.engine_id,
            engine_version=cur.engine_version,
            engine_variant=cur.engine_variant,
        )
        fresh = prepare_deployment(self.engine, self.registry, cfg, self.ctx)
        with self._deploy_lock:
            old = self.deployment.instance.id
            self.deployment = fresh
        logger.info("Reloaded: engine instance %s -> %s", old, fresh.instance.id)

    # -- status (CreateServer.scala:421-456) ------------------------------
    def status_json(self) -> dict:
        with self._deploy_lock:
            dep = self.deployment
        out = {
            "status": "alive",
            "engineInstance": dep.instance.id,
            "engine": {
                "id": dep.instance.engine_id,
                "version": dep.instance.engine_version,
                "factory": dep.instance.engine_factory,
            },
            "device": describe_device(self.ctx.device),
            "startTime": str(self.server_start_time),
            "maxQueue": self._max_queue,
            "stats": self.stats.snapshot(),
            "topkKernelLaunches": top_k_streaming.launches,
        }
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
        return out


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
