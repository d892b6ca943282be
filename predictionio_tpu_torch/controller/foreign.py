"""DASE components authored in another language, run as child processes.

Copy of ``predictionio_tpu/controller/foreign.py`` (the rebuild of the
reference's Java shim, ``controller/java/LJava*.scala``): a component
written in ANY language runs as a child process speaking line-delimited
JSON over stdin/stdout, and plugs into the port's Engine, workflow and
query server like a Python component. The C++ authoring helper
(``sdk/cpp/pio_engine.hpp``) and its worked example
(``examples/cpp_engine/``) are language-neutral and serve both packages.

Wire protocol (one JSON object per line, child must answer in order):

    → {"id": 1, "method": "read_training", "params": {...}}
    ← {"id": 1, "result": <training data JSON>}
    → {"id": 2, "method": "prepare", "params": {...}, "data": <td>}
    ← {"id": 2, "result": <prepared data JSON>}
    → {"id": 3, "method": "train", "params": {...}, "data": <pd>}
    ← {"id": 3, "result": <model JSON>}
    → {"id": 4, "method": "load", "model": <model JSON>}
    ← {"id": 4, "result": true}
    → {"id": 5, "method": "predict", "query": {...}}
    ← {"id": 5, "result": <prediction JSON>}

Any response may instead carry ``{"error": "message"}`` — it surfaces as a
Python exception on the calling side (one failed predict fails only that
query; the micro-batcher's per-item failure channel applies). The child's
stderr passes through to the parent's stderr. Each request has a
whole-line deadline (``timeout_s``); a child that dies is respawned by the
next request, and the algorithm pushes its model back with ``load``.

A foreign process is host code — data sourcing, business rules, glue.
The card's work stays in the port's own kernels: a foreign algorithm
that wants it returns data for a Python component to stage.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
from typing import Any, List, Optional, Sequence

from .dase import Algorithm, DataSource, Preparator
from .params import Params

__all__ = [
    "ForeignProcessError",
    "ForeignParams",
    "ForeignAlgorithm",
    "ForeignDataSource",
    "ForeignPreparator",
    "ForeignModel",
]


class ForeignProcessError(RuntimeError):
    """Child process died or broke the protocol; carries a stderr tail."""


class ForeignParams(Params):
    """Parameters for a foreign component.

    ``cmd``: argv of the child process (e.g. ``["./popularity"]``).
    ``cwd``: working directory (default: the engine dir at run time).
    ``params``: arbitrary JSON passed to the child with every
    read/prepare/train call (the component's own hyperparameters).
    ``timeout_s``: per-request timeout (train may take long; size it).
    """

    def __init__(self, cmd: Sequence[str], cwd: Optional[str] = None,
                 params: Optional[dict] = None, timeout_s: float = 600.0):
        self.cmd = list(cmd)
        self.cwd = cwd
        self.params = dict(params or {})
        self.timeout_s = float(timeout_s)


class _ForeignProcess:
    """One child process + request/response plumbing (thread-safe: the
    stdio pipe is a serial channel, so concurrent predict() calls from the
    micro-batcher's pipelined workers serialize on a lock)."""

    def __init__(self, cmd: List[str], cwd: Optional[str],
                 timeout_s: float):
        self._cmd = cmd
        self._cwd = cwd
        self._timeout_s = timeout_s
        self._proc: Optional[subprocess.Popen] = None
        self._buf = bytearray()  # bytes read past the last newline
        self._lock = threading.Lock()
        self._next_id = 0

    def _ensure(self) -> subprocess.Popen:
        if self._proc is None or self._proc.poll() is not None:
            try:
                # Binary pipes: line framing, decoding, and timeouts are
                # handled here (a text-mode readline would block without
                # a deadline and raise decode errors mid-protocol).
                self._proc = subprocess.Popen(
                    self._cmd,
                    cwd=self._cwd,
                    stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE,
                    # stderr passes through to the parent's stderr
                    bufsize=0,
                )
                self._buf = bytearray()
            except OSError as exc:
                raise ForeignProcessError(
                    f"cannot start foreign component {self._cmd!r}: {exc}"
                ) from exc
        return self._proc

    def request(self, method: str, timeout_s: Optional[float] = None,
                **fields) -> Any:
        """Send one request line, read one response line."""
        with self._lock:
            proc = self._ensure()
            self._next_id += 1
            req_id = self._next_id
            msg = json.dumps({"id": req_id, "method": method, **fields})
            try:
                assert proc.stdin is not None
                proc.stdin.write(msg.encode("utf-8") + b"\n")
                proc.stdin.flush()
            except (BrokenPipeError, OSError) as exc:
                raise self._died(f"write failed: {exc}")
            raw = self._read_line(
                proc,
                timeout_s if timeout_s is not None else self._timeout_s,
            )
            try:
                resp = json.loads(raw.decode("utf-8"))
            except ValueError:
                raise self._died(f"non-JSON response line: {raw[:200]!r}")
            if resp.get("id") != req_id:
                raise self._died(
                    f"response id {resp.get('id')!r} != request id {req_id}"
                )
            if "error" in resp:
                # component-level failure: the child is still healthy, so
                # this is an ordinary exception, not a process error
                raise RuntimeError(
                    f"foreign component {method} failed: {resp['error']}"
                )
            return resp.get("result")

    def _read_line(self, proc: subprocess.Popen, timeout_s: float) -> bytes:
        """Read one newline-terminated line with a WHOLE-LINE deadline —
        a child that writes a partial line and wedges must still trip the
        timeout, not block forever on the tail."""
        import select
        import time

        assert proc.stdout is not None
        fd = proc.stdout.fileno()
        deadline = time.monotonic() + timeout_s
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl])
                del self._buf[: nl + 1]
                return line
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.close(kill=True)
                raise ForeignProcessError(
                    f"foreign component timed out after {timeout_s}s "
                    f"({self._cmd!r})"
                )
            ready, _, _ = select.select([fd], [], [], remaining)
            if not ready:
                continue  # loop re-checks the deadline
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                raise self._died("child closed stdout")
            self._buf.extend(chunk)

    def _died(self, detail: str) -> ForeignProcessError:
        rc = self._proc.poll() if self._proc else None
        self.close(kill=True)
        return ForeignProcessError(
            f"foreign component {self._cmd!r} protocol failure "
            f"(exit code {rc}): {detail}"
        )

    def close(self, kill: bool = False) -> None:
        proc, self._proc = self._proc, None
        if proc is None:
            return
        try:
            if proc.stdin:
                proc.stdin.close()
            if kill:
                proc.kill()
            proc.wait(timeout=5.0)
        except Exception:
            try:
                proc.kill()
            except Exception:
                pass

    def __del__(self):
        self.close(kill=True)


def _resolve_cwd(p: ForeignParams) -> Optional[str]:
    if p.cwd:
        return p.cwd
    # engine dir convention: run_workflow/run_server chdir is not
    # guaranteed, so a relative cmd resolves against cwd at spawn
    return None


class ForeignDataSource(DataSource):
    """DataSource authored in another language (``read_training``)."""

    def __init__(self, params: ForeignParams):
        self.params = params
        self._proc = _ForeignProcess(
            params.cmd, _resolve_cwd(params), params.timeout_s
        )

    def read_training(self, ctx) -> Any:
        return self._proc.request("read_training", params=self.params.params)


class ForeignPreparator(Preparator):
    """Preparator authored in another language (``prepare``)."""

    def __init__(self, params: ForeignParams):
        self.params = params
        self._proc = _ForeignProcess(
            params.cmd, _resolve_cwd(params), params.timeout_s
        )

    def prepare(self, ctx, training_data: Any) -> Any:
        return self._proc.request(
            "prepare", params=self.params.params, data=training_data
        )


class ForeignModel:
    """A foreign-trained model: the child's model JSON plus how to respawn
    the child at deploy time. Pickles through the standard model store
    (the workflow's default persistence path)."""

    def __init__(self, model_json: Any, cmd: List[str],
                 cwd: Optional[str], timeout_s: float):
        self.model_json = model_json
        self.cmd = cmd
        self.cwd = cwd
        self.timeout_s = timeout_s


class ForeignAlgorithm(Algorithm):
    """Algorithm authored in another language (train + predict).

    One child process per algorithm instance; after ``train`` (or after
    model load at deploy) the child holds the model in memory and serves
    ``predict`` requests over the pipe. Under the serving micro-batcher
    the pipe serializes concurrent predicts — a foreign algorithm is a
    host-side component and is not expected to hit device-path QPS."""

    def __init__(self, params: ForeignParams):
        self.params = params
        self._proc = _ForeignProcess(
            params.cmd, _resolve_cwd(params), params.timeout_s
        )
        # Strong reference to the model currently loaded in the child:
        # identity via `is` (an id() cache would go stale when CPython
        # recycles a freed object's address).
        self._loaded_model: Optional[ForeignModel] = None

    def train(self, ctx, prepared_data: Any) -> ForeignModel:
        model_json = self._proc.request(
            "train", params=self.params.params, data=prepared_data
        )
        model = ForeignModel(
            model_json, self.params.cmd, self.params.cwd,
            self.params.timeout_s,
        )
        self._loaded_model = model  # train leaves the model loaded
        return model

    def _ensure_loaded(self, model: ForeignModel) -> None:
        """Push ``model`` into the child unless it holds it already (a
        respawned child holds nothing)."""
        if self._loaded_model is model:
            # fast path — but the child may have died since
            proc = self._proc._proc
            if proc is not None and proc.poll() is None:
                return
        self._proc.request("load", model=model.model_json)
        self._loaded_model = model

    def predict(self, model: ForeignModel, query: Any) -> Any:
        if not isinstance(model, ForeignModel):
            raise TypeError(
                f"ForeignAlgorithm got a {type(model).__name__} model; "
                "expected ForeignModel"
            )
        self._ensure_loaded(model)
        q = query if isinstance(query, dict) else getattr(
            query, "__dict__", query
        )
        return self._proc.request("predict", query=q)
