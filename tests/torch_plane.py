"""Shared helpers of the request-plane tests (``test_torch_*``): seeded ALS
tables, the JAX and the port query servers booted on the same factors
over temporary stores, a capturing HTTP sink, and a loopback client.

Every server binds port 0 and every wait is bounded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import pickle
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

RANK, N_USERS, N_ITEMS = 6, 40, 90


def seeded_tables(seed: int, n_users: int = N_USERS, n_items: int = N_ITEMS,
                  rank: int = RANK):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, rank)).astype(np.float32),
            rng.normal(size=(n_items, rank)).astype(np.float32))


def jax_model(seed: int, **shape):
    from predictionio_tpu.models.recommendation import ALSModel
    from predictionio_tpu.storage import BiMap

    uf, itf = seeded_tables(seed, **shape)
    return ALSModel(rank=uf.shape[1], user_factors=uf, item_factors=itf,
                    user_map=BiMap({f"u{i}": i for i in range(len(uf))}),
                    item_map=BiMap({f"i{i}": i for i in range(len(itf))}))


def port_model(seed: int, **shape):
    from predictionio_tpu_torch.models.recommendation import als_model_from_numpy

    uf, itf = seeded_tables(seed, **shape)
    return als_model_from_numpy(uf.shape[1], uf, itf, [f"u{i}" for i in range(len(uf))],
                                [f"i{i}" for i in range(len(itf))])


def request(port: int, method: str, path: str, body=None, headers=None, timeout=30):
    """One loopback request → (status, JSON or text body, headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = None if body is None else json.dumps(body)
        conn.request(method, path, payload,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type", "")
        parsed = json.loads(data) if ctype.startswith("application/json") else data.decode()
        return resp.status, parsed, dict(resp.getheaders())
    finally:
        conn.close()


def wait_until(predicate, timeout: float = 20.0, what: str = "condition"):
    """Poll ``predicate`` (every 10 ms) until it is truthy; fail after
    ``timeout`` seconds. Returns its last value."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value:
            return value
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)


def closed_port() -> int:
    """A loopback port nothing listens on (bound, then released)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Sink:
    """A loopback HTTP server that answers 201 to every POST and keeps
    each (path, headers, JSON body); :meth:`wait_for` blocks, bounded,
    until ``n`` have arrived."""

    def __init__(self):
        self.posts = []
        self._cond = threading.Condition()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with sink._cond:
                    sink.posts.append((self.path, dict(self.headers), json.loads(body)))
                    sink._cond.notify_all()
                out = b'{"eventId": "x"}'
                self.send_response(201)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=lambda: self.server.serve_forever(poll_interval=0.05), daemon=True)
        self._thread.start()

    def wait_for(self, n: int, timeout: float = 20.0) -> list:
        with self._cond:
            if not self._cond.wait_for(lambda: len(self.posts) >= n, timeout=timeout):
                raise AssertionError(f"sink got {len(self.posts)} posts, wanted {n}")
            return list(self.posts)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=5)


def close_server(server) -> None:
    server.shutdown()
    server.server_close()


@contextlib.contextmanager
def port_server(tmp_path, model, algo_params=None, registry=None, env=None,
                server_kwargs=None, **config):
    """The port's query server on ``device="cpu"`` over a fresh store
    holding ``model`` as the latest completed instance (``env`` added to
    the instance's env); ``server_kwargs`` go to ``QueryServer`` (clock,
    retry policy, breakers)."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.recommendation import (
        ALSAlgorithmParams,
        engine_factory,
    )
    from predictionio_tpu_torch.storage import StorageRegistry
    from predictionio_tpu_torch.workflow import QueryServer, ServerConfig, persist_instance

    registry = registry or StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "port")})
    params = algo_params or ALSAlgorithmParams(rank=model.rank)
    iid = persist_instance(registry, EngineParams(algorithm_params_list=[("als", params)]),
                           [model])
    if env:
        md = registry.get_metadata()
        inst = md.engine_instance_get(iid)
        md.engine_instance_update(dataclasses.replace(inst, env={**inst.env, **env}))
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0, device="cpu", **config),
                         engine_factory(), registry, **(server_kwargs or {}))
    server.start_background()
    try:
        yield server
    finally:
        close_server(server)


@contextlib.contextmanager
def jax_server(tmp_path, model, env=None, server_kwargs=None, **config):
    """The JAX package's query server (CPU) over a fresh store of its own
    holding ``model``, stored the way its ``run_train`` stores one."""
    from predictionio_tpu.controller.engine import EngineParams, serialize_engine_params
    from predictionio_tpu.models.recommendation import ALSAlgorithmParams, engine_factory
    from predictionio_tpu.storage import Model, StorageRegistry
    from predictionio_tpu.storage.metadata import STATUS_COMPLETED, new_engine_instance
    from predictionio_tpu.workflow.serving import QueryServer, ServerConfig

    registry = StorageRegistry(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    md = registry.get_metadata()
    ep = EngineParams(algorithm_params_list=[("als", ALSAlgorithmParams(rank=model.rank))])
    iid = md.engine_instance_insert(new_engine_instance(
        engine_id="default", engine_version="1", engine_variant="engine.json",
        engine_factory="", **serialize_engine_params(ep)))
    registry.get_models().insert(Model(id=iid, models=pickle.dumps([model])))
    inst = md.engine_instance_get(iid)
    md.engine_instance_update(dataclasses.replace(inst, status=STATUS_COMPLETED,
                                                  env={**inst.env, **(env or {})}))
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0, **config),
                         engine_factory(), registry, **(server_kwargs or {}))
    server.start_background()
    try:
        yield server
    finally:
        close_server(server)


def item_scores(answer: dict):
    return [(e["item"], float(e["score"])) for e in answer["itemScores"]]


def same_ranking(got: dict, want: dict, tol: float = 1e-5) -> bool:
    """Items equal but for ties, scores to ``tol`` (the serving contract)."""
    g, w = item_scores(got), item_scores(want)
    if len(g) != len(w):
        return False
    gs, ws = np.array([s for _, s in g]), np.array([s for _, s in w])
    close = np.isclose(gs, ws, rtol=tol, atol=tol)
    same = np.array([a == b for (a, _), (b, _) in zip(g, w)], dtype=bool)
    return bool(close.all() and (same | close).all())
