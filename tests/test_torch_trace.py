"""The port's request tracing (``obs/trace.py``) against the JAX package's.

``TestTracer``'s scripts (``tests/test_obs.py``) run through both
packages' ``Tracer`` on the same fake clocks: the recorded spans must be
equal but for their random span ids. Then the wiring: the micro-batcher
records its two spans under the submitter's trace; a query to the port's
query server with feedback on lands in one trace with the port's Event
Server's admission span, and the span tree matches the JAX query
server's for the same request; ``pio trace`` stitches both nodes.
"""

from __future__ import annotations

import re
import threading

import pytest

import predictionio_tpu.obs.trace as jax_trace
import predictionio_tpu_torch.obs.trace as port_trace
from predictionio_tpu_torch.api.event_server import EventServerConfig, create_event_server
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.top import collect_trace, render_trace, run_trace
from predictionio_tpu_torch.storage import StorageRegistry
from predictionio_tpu_torch.storage.metadata import AccessKey, App
from predictionio_tpu_torch.testing.clock import FakeClock
from predictionio_tpu_torch.tools import console
from predictionio_tpu_torch.workflow.batching import MicroBatcher

from torch_plane import (
    close_server,
    jax_model,
    jax_server,
    port_model,
    port_server,
    request,
    wait_until,
)


def _strip(spans):
    """Spans without their random ids; parents as positions in the list."""
    ids = {s["spanId"]: i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        s = dict(s)
        s["parentId"] = ids.get(s.pop("parentId"), s.get("parentId"))
        s.pop("spanId")
        out.append(s)
    return out


def spans_on_injected_clocks(mod):
    clock, wall = FakeClock(0.0), FakeClock(5000.0)
    tracer = mod.Tracer("svc", clock=clock, wall=wall)
    with tracer.server_span("root", header_value="abc123") as root:
        clock.advance(0.25)
        with tracer.span("child", tags={"k": "v"}) as child:
            clock.advance(0.5)
        assert child.trace_id == root.trace_id == "abc123"
        assert mod.current_context() is root
    assert mod.current_context() is None
    return tracer.store.dump()


def error_spans_tagged(mod):
    tracer = mod.Tracer("svc", clock=FakeClock(), wall=FakeClock())
    with pytest.raises(RuntimeError):
        with tracer.server_span("boom", header_value="e-1"):
            raise RuntimeError("x")
    return tracer.store.dump()


def explicit_parent_across_threads(mod):
    tracer = mod.Tracer("svc", clock=FakeClock(1.0), wall=FakeClock(2.0))
    def hop():
        with tracer.span("hop", parent=root):
            pass

    with tracer.server_span("root", header_value="t-1") as root:
        thread = threading.Thread(target=hop)
        thread.start()
        thread.join(timeout=10)
        with tracer.span("in-thread", parent=root):
            pass
        ctx = tracer.child_context(root)
        tracer.record("by-hand", ctx, root.span_id, start_wall=1.5, duration_s=0.25,
                      tags={"n": 1}, error="Boom")
    assert not thread.is_alive()
    return tracer.store.dump()


def ring_buffer_bounds(mod):
    store = mod.SpanStore(capacity=3)
    for i in range(10):
        store.add({"traceId": "t", "i": i})
    return store.dump() + [len(store), store.for_trace("t")[0]]


SCRIPTS = {f.__name__: f for f in (spans_on_injected_clocks, error_spans_tagged,
                                   explicit_parent_across_threads, ring_buffer_bounds)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tracer_matches_the_jax_package(name):
    want, got = SCRIPTS[name](jax_trace), SCRIPTS[name](port_trace)
    if name == "ring_buffer_bounds":
        assert got == want
        assert [s["i"] for s in got[:3]] == [7, 8, 9]
        return
    assert _strip(got) == _strip(want)
    if name == "spans_on_injected_clocks":
        child, root = got
        assert [child["name"], root["name"]] == ["child", "root"]
        assert child["parentId"] == root["spanId"] and root["kind"] == "server"
        assert root["durationMs"] == 750.0 and child["durationMs"] == 500.0
        assert child["tags"] == {"k": "v"} and root["startMs"] == 5000000.0
    if name == "error_spans_tagged":
        assert got[0]["error"] == "RuntimeError"


@pytest.mark.parametrize("header", [None, "", "  ok-id_1.2  ", 'ha"}\n{x', "x" * 200])
def test_header_sanitising_matches(header):
    assert port_trace.sanitize_trace_id(header) == jax_trace.sanitize_trace_id(header)
    tracer = port_trace.Tracer("svc", clock=FakeClock(), wall=FakeClock())
    with tracer.server_span("r", header_value=header) as ctx:
        pass
    want = jax_trace.sanitize_trace_id(header)
    if want is None:
        assert re.fullmatch(r"[0-9a-f]{16}", ctx.trace_id)  # a fresh id minted
    else:
        assert ctx.trace_id == want
    assert port_trace.TRACE_HEADER == jax_trace.TRACE_HEADER == "X-PIO-Trace"


def test_batcher_spans_ride_the_submitters_trace():
    clock = FakeClock(10.0)
    tracer = port_trace.Tracer("q", clock=clock, wall=FakeClock(100.0))

    def process(items):
        clock.advance(0.004)  # the batch's "device" time
        return [x * 2 for x in items]

    batcher = MicroBatcher(process, max_batch=4, max_wait_ms=0.0, metrics=MetricsRegistry(),
                           tracer=tracer, clock=clock)
    try:
        with tracer.server_span("POST /queries.json", header_value="bt-1") as root:
            assert batcher.submit(21, timeout=10) == 42
        assert batcher.submit(1, timeout=10) == 2  # no trace: no spans
    finally:
        batcher.close()
    spans = tracer.store.dump()
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"batch.queue-wait", "batch.device", "POST /queries.json"}
    for name in ("batch.queue-wait", "batch.device"):
        assert by_name[name]["traceId"] == "bt-1"
        assert by_name[name]["parentId"] == root.span_id
        assert by_name[name]["tags"] == {"batch_size": 1, "flush": "wait"}
    assert by_name["batch.device"]["durationMs"] == 4.0


@pytest.fixture()
def event_server(tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "events")})
    md = registry.get_metadata()
    app = md.app_insert(App(id=0, name="plane"))
    md.access_key_insert(AccessKey(key="k", appid=app))
    registry.get_events().init(app)
    server = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                 registry=registry, block=False)
    try:
        yield server
    finally:
        close_server(server)


def _tree(spans):
    """(service, name, parent's name) of each span, sorted."""
    names = {s["spanId"]: s["name"] for s in spans}
    return sorted((s["service"], s["name"], names.get(s["parentId"])) for s in spans)


def test_query_and_event_server_share_one_trace(tmp_path, event_server, capsys):
    feedback = dict(feedback=True, event_server_ip="127.0.0.1",
                    event_server_port=event_server.bound_port, access_key="k")
    tid = "plane-trace-0001"
    with port_server(tmp_path, port_model(3), **feedback) as server:
        status, _, headers = request(server.bound_port, "POST", "/queries.json",
                                     {"user": "u1", "num": 4}, {"X-PIO-Trace": tid})
        assert status == 200 and headers["X-PIO-Trace"] == tid
        port_spans = wait_until(lambda: [s for s in server.tracer.store.for_trace(tid)]
                                if len(server.tracer.store.for_trace(tid)) == 4 else None,
                                what="the feedback delivery's span")
        assert {s["name"] for s in wait_until(
            lambda: event_server.tracer.store.for_trace(tid))} == {"POST /events.json"}
        status, doc, _ = request(server.bound_port, "GET", "/traces.json")
        assert status == 200 and doc["service"] == "query-server"
        assert any(s["traceId"] == tid for s in doc["spans"])
        nodes = f"127.0.0.1:{server.bound_port},127.0.0.1:{event_server.bound_port}"
        stitched = collect_trace(tid, nodes)
        assert {s["service"] for s in stitched} == {"query-server", "event-server"}
        assert tid in render_trace(tid, stitched)
        capsys.readouterr()
        assert run_trace(tid, nodes) == 0
        assert console.main(["trace", tid, "--nodes", nodes, "--json"]) == 0
        assert len(__import__("json").loads(capsys.readouterr().out.splitlines()[-1])) == len(
            stitched)
        assert console.main(["trace", "nope", "--nodes", nodes]) == 1
        # the admission answer without a header roots a fresh trace
        _, _, headers = request(server.bound_port, "POST", "/queries.json",
                                {"user": "u1", "num": 4})
        assert re.fullmatch(r"[0-9a-f]{16}", headers["X-PIO-Trace"])
    with jax_server(tmp_path, jax_model(3), **feedback) as jax_srv:
        status, _, _ = request(jax_srv.bound_port, "POST", "/queries.json",
                               {"user": "u1", "num": 4}, {"X-PIO-Trace": tid + "-jax"})
        assert status == 200
        jax_spans = wait_until(lambda: jax_srv.tracer.store.for_trace(tid + "-jax")
                               if len(jax_srv.tracer.store.for_trace(tid + "-jax")) == 4
                               else None, what="the JAX server's feedback span")
    assert _tree(port_spans) == _tree(jax_spans) == [
        ("query-server", "POST /queries.json", None),
        ("query-server", "batch.device", "POST /queries.json"),
        ("query-server", "batch.queue-wait", "POST /queries.json"),
        ("query-server", "serving.feedback", "POST /queries.json"),
    ]
