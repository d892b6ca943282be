"""The port's health plane against the JAX package's.

1. **SLO engine** (``obs/slo.py``): the same metric series, on the same
   fake clocks, through both packages' ``SLOEngine`` give equal verdicts,
   burn rates, exported gauges and alert-ledger records.
2. **Flight recorder and stall watchdog** (``obs/flight.py``): the ring,
   the zero-cost disabled path, dumps both packages read, the watchdog's
   stalls on both; the SIGTERM dump chains to the handler it replaces
   and leaves ``flight-<pid>.jsonl`` and ``faulthandler-<pid>.txt`` from a
   spawned ``run_server``.
3. **Wiring and CLIs**: ``/health.json`` and ``/blackbox.json`` on the
   port's servers, the ticker's lifetime, and ``pio health`` / ``pio
   alerts`` / ``pio blackbox`` with their pinned exit codes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading

import pytest

import predictionio_tpu.obs.flight as jax_flight
import predictionio_tpu.obs.metrics as jax_metrics
import predictionio_tpu.obs.slo as jax_slo
import predictionio_tpu_torch.obs.flight as port_flight
import predictionio_tpu_torch.obs.metrics as port_metrics
import predictionio_tpu_torch.obs.slo as port_slo
from predictionio_tpu.obs.perfledger import append_record as jax_append
from predictionio_tpu_torch.api.event_server import EventServerConfig, create_event_server
from predictionio_tpu_torch.obs.perfledger import append_record
from predictionio_tpu_torch.storage import StorageRegistry
from predictionio_tpu_torch.testing.clock import FakeClock
from predictionio_tpu_torch.tools import console, health
from predictionio_tpu_torch.utils.resilience import CircuitBreaker

from torch_plane import close_server, port_model, port_server, request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_metrics, jax_slo, jax_flight),
            "port": (port_metrics, port_slo, port_flight)}


# -- 1. the SLO engine, both packages on one script -----------------------------
class _Plant:
    """One registry + engine + traffic pump on a fake clock (the JAX
    test's plant), built from one package's modules."""

    def __init__(self, pkg, objectives, ledger=None):
        metrics_mod, slo_mod, _ = PACKAGES[pkg]
        self.clock = FakeClock()
        self.metrics = metrics_mod.MetricsRegistry(clock=self.clock)
        self.resp = self.metrics.counter("pio_http_responses_total", labelnames=("status",))
        self.hist = self.metrics.histogram("pio_serving_request_seconds")
        self.engine = slo_mod.SLOEngine(self.metrics, objectives(slo_mod), clock=self.clock,
                                        wall=FakeClock(5e8), ledger_path=ledger, node="q")

    def pump(self, rounds, good=20, bad=0, latency=0.005, advance=60.0):
        summary = None
        for _ in range(rounds):
            for _ in range(good):
                self.resp.inc(1, status=200)
                self.hist.observe(latency)
            for _ in range(bad):
                self.resp.inc(1, status=500)
                self.hist.observe(latency)
            self.clock.advance(advance)
            summary = self.engine.evaluate()
        return summary

    def gauges(self):
        return {name: self.metrics.instrument(name).samples()
                for name in ("pio_slo_alert_state", "pio_slo_burn_rate", "pio_slo_alerts_total")}


def _availability(slo_mod, **kw):
    base = dict(target=0.999, burn_threshold=8.0, min_window_events=10,
                fast_window_s=300.0, slow_window_s=3600.0)
    base.update(kw)
    return (slo_mod.SLOObjective(name="availability", kind="ratio",
                                 metric="pio_http_responses_total", **base),)


def _latency(slo_mod):
    return (slo_mod.SLOObjective(name="latency", kind="ratio",
                                 metric="pio_serving_request_seconds",
                                 latency_threshold_s=0.128, target=0.99,
                                 burn_threshold=8.0, min_window_events=10),)


def clean_traffic(plant):
    return [plant.pump(8)]


def fires_only_when_both_windows_burn(plant):
    out = [plant.pump(6), plant.pump(1, good=997, bad=3)]
    return out + [plant.pump(2, good=10, bad=10)]


def clears_when_the_fast_window_drains(plant):
    plant.pump(6)
    return [plant.pump(2, good=10, bad=10), plant.pump(7, good=30)]


def thin_window_abstains(plant):
    plant.resp.inc(1, status=500)
    plant.resp.inc(1, status=200)
    plant.clock.advance(60)
    out = [plant.engine.evaluate()]
    plant.clock.advance(60)
    return out + [plant.engine.evaluate()]


def counter_reset_abstains(plant):
    plant.pump(6)
    plant.resp.clear()  # the process restarted: its counters begin again
    plant.resp.inc(1, status=200)
    plant.clock.advance(60)
    return [plant.engine.evaluate()]


def slow_answers_fire_latency(plant):
    return [plant.pump(6, latency=0.005), plant.pump(2, good=10, latency=0.3)]


SLO_SCRIPTS = {
    "clean_traffic": (clean_traffic, _availability),
    "fires_only_when_both_windows_burn": (fires_only_when_both_windows_burn, _availability),
    "clears_when_the_fast_window_drains": (clears_when_the_fast_window_drains, _availability),
    "thin_window_abstains": (thin_window_abstains, _availability),
    "counter_reset_abstains": (counter_reset_abstains, _availability),
    "slow_answers_fire_latency": (slow_answers_fire_latency, _latency),
}


def _run_slo(pkg, name, tmp_path):
    script, objectives = SLO_SCRIPTS[name]
    ledger = str(tmp_path / f"{pkg}-alerts.jsonl")
    plant = _Plant(pkg, objectives, ledger=ledger)
    summaries = script(plant)
    _, slo_mod, _ = PACKAGES[pkg]
    return summaries, plant.gauges(), slo_mod.load_alerts(ledger)


@pytest.mark.parametrize("name", sorted(SLO_SCRIPTS))
def test_slo_verdicts_match_the_jax_package(name, tmp_path):
    want = _run_slo("jax", name, tmp_path)
    got = _run_slo("port", name, tmp_path)
    assert got == want
    final = got[0][-1]["objectives"][0]
    if name in ("fires_only_when_both_windows_burn", "slow_answers_fire_latency"):
        assert final["state"] == "FIRING" and got[0][-1]["firing"] == 1
        assert [a["state"] for a in got[2]] == ["FIRING"]
    elif name == "clears_when_the_fast_window_drains":
        assert final["state"] == "OK" and final["cleared"] == 1
        assert [a["state"] for a in got[2]] == ["FIRING", "CLEARED"]
        assert all(a["schema"] == 1 and a["kind"] == "alert" and a["node"] == "q"
                   for a in got[2])
    elif name == "clean_traffic":
        assert final["state"] == "OK" and not final["abstaining"] and final["burnFast"] == 0.0
    else:
        assert final["abstaining"] and not got[2]


def test_gauge_objectives_and_data_loss_match():
    """The ``-1`` sentinel reads as absent and a firing alert holds on
    data loss — in both."""
    def script(pkg):
        metrics_mod, slo_mod, _ = PACKAGES[pkg]
        clock = FakeClock()
        metrics = metrics_mod.MetricsRegistry(clock=clock)
        psi = metrics.gauge("pio_quality_score_psi", labelnames=("variant",))
        objectives = [o for o in slo_mod.default_objectives("query") if o.name == "drift"]
        engine = slo_mod.SLOEngine(metrics, objectives, clock=clock, wall=FakeClock(1.0))
        out = []
        for value in (-1.0, 0.1, 0.6, -1.0, 0.05):
            psi.set(value, variant="baseline")
            clock.advance(60)
            out.append(engine.evaluate())
        return out + [metrics.instrument("pio_slo_alert_state").samples(), engine.firing()]

    got, want = script("port"), script("jax")
    assert got == want
    states = [(o["objectives"][0]["state"], o["objectives"][0]["abstaining"]) for o in got[:5]]
    assert states == [("OK", True), ("OK", False), ("FIRING", False), ("FIRING", True),
                      ("FIRING", False)]


def test_default_objectives_and_ledger_format_match(tmp_path):
    for kind in ("query", "event", "dashboard"):
        want = [dataclasses.asdict(o) for o in jax_slo.default_objectives(kind)]
        for o in want:
            assert o.pop("per_label") is None  # the storage server's, not ported
        assert [dataclasses.asdict(o) for o in port_slo.default_objectives(kind)] == want
    ledger = tmp_path / "alerts.jsonl"
    ledger.write_text(json.dumps({"schema": 1, "kind": "alert", "objective": "x",
                                  "state": "FIRING"}) + "\n{torn\n[1]\n")
    assert port_slo.load_alerts(str(ledger)) == jax_slo.load_alerts(str(ledger))
    assert len(port_slo.load_alerts(str(ledger))) == 1
    assert port_slo.load_alerts(str(tmp_path / "missing")) == []
    assert port_slo.ALERT_LEDGER_ENV == "PIO_ALERT_LEDGER"


def test_alert_ledger_from_the_environment(tmp_path, monkeypatch):
    """With no path given the engine appends to ``PIO_ALERT_LEDGER``
    through the port's ``append_record``; the JAX loader reads it."""
    ledger = str(tmp_path / "env-alerts.jsonl")
    monkeypatch.setenv("PIO_ALERT_LEDGER", ledger)
    plant = _Plant("port", _availability)
    plant.pump(6)
    plant.pump(2, good=10, bad=10)
    records = jax_slo.load_alerts(ledger)
    assert [r["state"] for r in records] == ["FIRING"]
    assert set(records[0]) == {"schema", "kind", "objective", "metric", "state", "burnFast",
                               "burnSlow", "burnThreshold", "node", "at"}


# -- 2. flight recorder and stall watchdog ---------------------------------------
class _CountingClock:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return 0.0


def test_flight_recorder_ring_and_dumps(tmp_path):
    clock = _CountingClock()
    off = port_flight.FlightRecorder(enabled=False, clock=clock)
    for _ in range(256):
        off.record("breaker", "breaker.x", state="open")
    assert clock.calls == 0 and len(off) == 0  # disabled: the clock never read
    ring = port_flight.FlightRecorder(capacity=8, enabled=True, clock=FakeClock())
    for i in range(32):
        ring.record("k", "s", i=i)
    assert len(ring) == 8 and ring.dump()[-1]["details"] == {"i": 31}
    from predictionio_tpu_torch.obs.trace import Tracer

    tracer = Tracer("t", clock=FakeClock())
    with tracer.server_span("x", header_value="trace42"):
        ring.record("k", "s")
    assert ring.dump()[-1]["trace"] == "trace42"
    # one dump format: each package reads the other's
    for writer, reader in ((port_flight, jax_flight), (jax_flight, port_flight)):
        path = str(tmp_path / f"{writer.__name__}.jsonl")
        writer.write_dump(path, ring.dump(), "test", at=5.0)
        doc = reader.load_dump(path)
        assert doc["header"]["reason"] == "test" and doc["header"]["events"] == 8
        assert doc["events"] == json.loads(json.dumps(ring.dump()))
    assert port_flight.load_dump(str(tmp_path / "missing.jsonl")) is None
    assert port_flight.FLIGHT_DIR_ENV == jax_flight.FLIGHT_DIR_ENV == "PIO_FLIGHT_DIR"


def test_breaker_transitions_land_in_the_process_recorder():
    recorder = port_flight.default_recorder()
    before = len(recorder.dump())
    clock = FakeClock()
    breaker = CircuitBreaker(name="health-test", failure_threshold=1, reset_timeout_s=5,
                             clock=clock)
    with pytest.raises(RuntimeError):
        breaker.call(lambda: (_ for _ in ()).throw(RuntimeError()))
    clock.advance(5)
    breaker.call(lambda: None)
    events = [(e["kind"], e["site"], e["details"]["state"]) for e in recorder.dump()[before:]]
    assert events == [("breaker", "breaker.health-test", "open"),
                      ("breaker", "breaker.health-test", "closed")]


def _watchdog_script(pkg, tmp_path):
    metrics_mod, _, flight_mod = PACKAGES[pkg]
    clock = FakeClock()
    metrics = metrics_mod.MetricsRegistry(clock=clock)
    flight = flight_mod.FlightRecorder(enabled=True, clock=clock, wall=FakeClock(7.0))
    watchdog = flight_mod.StallWatchdog(metrics, clock=clock, flight=flight,
                                        dump_dir=str(tmp_path / pkg))
    os.makedirs(tmp_path / pkg, exist_ok=True)
    out = []
    token = watchdog.enter("serving.request", budget_s=1.0)
    clock.advance(2.0)
    out.append(watchdog.check())
    clock.advance(10.0)
    out += [watchdog.check(), watchdog.check()]
    watchdog.exit(token)
    out.append(watchdog.check())
    watchdog.enter("serving.request", budget_s=None)
    clock.advance(39.0)
    out.append(watchdog.check())
    clock.advance(2.0)
    out.append(watchdog.check())
    watchdog.expect("continuous.tick", max_gap_s=30.0)
    clock.advance(31.0)
    out.append(watchdog.check())
    watchdog.unexpect("continuous.tick")
    summary = watchdog.summary()
    out.append({k: v for k, v in summary.items() if k != "lastDump"})
    out.append(os.path.basename(summary["lastDump"]))
    out.append(metrics.instrument("pio_stall_detected_total").samples())
    out.append([(e["kind"], e["site"]) for e in flight.dump()])
    return out


def test_stall_watchdog_matches_the_jax_package(tmp_path):
    got, want = _watchdog_script("port", tmp_path), _watchdog_script("jax", tmp_path)
    assert got == want
    assert got[1][0]["site"] == "serving.request" and got[1][0]["stallKind"] == "request"
    assert got[2] == [] and got[4] == [] and got[5] and got[6][0]["stallKind"] == "tick"
    doc = port_flight.load_dump(str(tmp_path / "port" / got[-3]))
    assert doc["header"]["reason"] == "stall:continuous.tick"
    doc = port_flight.load_dump(str(tmp_path / "port" / f"stall-serving.request-{os.getpid()}.jsonl"))
    assert doc["header"]["reason"] == "stall:serving.request"


CHAIN_SCRIPT = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
from predictionio_tpu_torch.obs import flight
def earlier(signum, frame):
    open(os.path.join(sys.argv[2], "earlier-handler-ran"), "w").close()
signal.signal(signal.SIGTERM, earlier)
flight.record("deploy", "test.site", n=1)
print(flight.arm(sys.argv[2], signals=True), flush=True)
os.kill(os.getpid(), signal.SIGTERM)
signal.pause()
"""


def test_sigterm_dump_chains_to_the_earlier_handler(tmp_path):
    proc = subprocess.run([sys.executable, "-c", CHAIN_SCRIPT, REPO, str(tmp_path)],
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, PIO_FLIGHT="1"))
    assert proc.returncode == -signal.SIGTERM, proc.stderr  # the exit was not swallowed
    assert (tmp_path / "earlier-handler-ran").exists()
    path = proc.stdout.strip()
    doc = port_flight.load_dump(path)
    assert os.path.basename(path).startswith("flight-")
    assert doc["header"]["reason"] == "signal-15"
    assert [e["site"] for e in doc["events"]] == ["test.site"]
    assert any(p.name.startswith("faulthandler-") for p in tmp_path.iterdir())


def test_killed_run_server_leaves_its_flight_dump(tmp_path):
    from predictionio_tpu_torch.tools.register import load_engine_dir
    from predictionio_tpu_torch.tools.templates import get_template
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithmParams
    from predictionio_tpu_torch.workflow import persist_instance

    base, flight_dir = tmp_path / "store", tmp_path / "flight"
    engine_dir = tmp_path / "proj"
    get_template("recommendation", str(engine_dir))
    manifest = load_engine_dir(str(engine_dir)).manifest
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(base)})
    persist_instance(registry, EngineParams(algorithm_params_list=[
        ("als", ALSAlgorithmParams(rank=6))]), [port_model(5)],
        engine_id=manifest.id, engine_version=manifest.version)
    env = dict(os.environ, PIO_FS_BASEDIR=str(base), PIO_FLIGHT_DIR=str(flight_dir),
               PYTHONPATH=REPO, PIO_NO_UPGRADE_CHECK="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.run_server", "--engine-dir",
         str(engine_dir), "--device", "cpu", "--ip", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()  # the server answers once this is out
        port = json.loads(line)["port"]
        assert request(port, "POST", "/queries.json", {"user": "u1", "num": 3})[0] == 200
        assert request(port, "POST", "/reload")[0] == 200  # a flight event
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    doc = port_flight.load_dump(str(flight_dir / f"flight-{proc.pid}.jsonl"))
    assert doc["header"]["reason"] == "signal-15"
    assert any(e["site"] == "serving.reload" for e in doc["events"])
    assert (flight_dir / f"faulthandler-{proc.pid}.txt").exists()


# -- 3. wiring and the CLIs -------------------------------------------------------
@pytest.fixture()
def event_server(tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "events")})
    server = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                 registry=registry, block=False)
    try:
        yield server
    finally:
        close_server(server)


def test_health_and_blackbox_routes(event_server, tmp_path):
    status, doc, _ = request(event_server.bound_port, "GET", "/health.json")
    assert status == 200 and doc["kind"] == "event" and doc["firing"] == 0
    assert {o["name"] for o in doc["objectives"]} == {"availability", "latency", "drift"}
    assert all(o["abstaining"] for o in doc["objectives"]) and "stalls" in doc
    status, doc, _ = request(event_server.bound_port, "GET", "/blackbox.json")
    assert status == 200 and isinstance(doc["events"], list) and doc["enabled"]
    with port_server(tmp_path, port_model(1)) as server:
        for _ in range(3):
            assert request(server.bound_port, "POST", "/queries.json",
                           {"user": "u2", "num": 2})[0] == 200
        summary = server.health.tick()
        assert summary["firing"] == 0
        status, doc, _ = request(server.bound_port, "GET", "/health.json")
        assert doc["kind"] == "query" and {o["name"] for o in doc["objectives"]} == {
            o.name for o in jax_slo.default_objectives("query")}
        assert doc["stalls"]["inflight"] == 0
        _, text, _ = request(server.bound_port, "GET", "/metrics")
        assert 'pio_slo_alert_state{objective="availability"}' in text
        assert "pio_stall_inflight 0" in text


def test_the_ticker_lives_with_its_server(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_SLO_TICK_S", "0.05")
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    server = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                 registry=registry, block=False)
    plane = server.health
    assert plane._thread is not None and plane._thread.is_alive()
    before = set(threading.enumerate())
    with pytest.raises(OSError):  # the port is taken: no ticker may leak
        create_event_server(EventServerConfig(ip="127.0.0.1", port=server.bound_port),
                            registry=registry, block=False)
    assert not [t for t in set(threading.enumerate()) - before if t.name.startswith("health-")]
    thread = plane._thread
    close_server(server)
    assert plane._thread is None and not thread.is_alive()


def test_health_cli_exit_codes(tmp_path, capsys, event_server):
    assert health.main(["health", "--nodes", "127.0.0.1:9", "--timeout", "0.5"]) == 2
    assert "DOWN" in capsys.readouterr().out
    node = f"127.0.0.1:{event_server.bound_port}"
    assert health.main(["health", "--nodes", node]) == 0
    assert "event" in capsys.readouterr().out
    assert console.main(["health", "--nodes", f"{node},127.0.0.1:9", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["up"] for r in rows] == [True, False]
    assert health.main(["alerts", "--node", node]) == 0


def test_alerts_cli_exit_codes(tmp_path, capsys):
    assert health.main(["alerts", "--ledger", str(tmp_path / "missing.jsonl")]) == 2
    assert health.main(["alerts", "--ledger", str(tmp_path)]) == 2  # a directory
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert health.main(["alerts", "--ledger", str(empty)]) == 0
    ledger = str(tmp_path / "alerts.jsonl")
    fire = {"schema": 1, "kind": "alert", "objective": "availability", "metric": "m",
            "state": "FIRING", "burnFast": 12.0, "burnSlow": 9.0, "node": "query",
            "at": 1000.0}
    append_record(ledger, fire)
    assert health.main(["alerts", "--ledger", ledger]) == 1
    jax_append(ledger, dict(fire, state="CLEARED", burnFast=0.1))  # one format
    assert console.main(["alerts", "--ledger", ledger]) == 0
    out = capsys.readouterr().out
    assert "FIRING" in out and "CLEARED" in out
    assert health.main(["alerts"]) == 2  # neither a ledger nor a node


def test_blackbox_cli(tmp_path, capsys, event_server, monkeypatch):
    recorder = port_flight.FlightRecorder(enabled=True, clock=FakeClock())
    recorder.record("breaker", "breaker.event-server", state="open")
    path = str(tmp_path / "flight-1.jsonl")
    recorder.dump_to(path)
    assert health.main(["blackbox", "show", "--file", path]) == 0
    assert "breaker.event-server" in capsys.readouterr().out
    monkeypatch.setenv("PIO_FLIGHT_DIR", str(tmp_path))
    assert console.main(["blackbox", "show"]) == 0  # the newest dump there
    assert health.main(["blackbox", "show", "--file", str(tmp_path / "nope.jsonl")]) == 2
    assert health.main(["blackbox", "dump", "--node", "127.0.0.1:9",
                        "--timeout", "0.5"]) == 2
    node = f"127.0.0.1:{event_server.bound_port}"
    out_file = str(tmp_path / "bb.jsonl")
    assert health.main(["blackbox", "dump", "--node", node, "--out", out_file]) == 0
    assert port_flight.load_dump(out_file)["header"]["reason"] == f"pio blackbox dump {node}"


def test_kill_severs_live_connections(tmp_path):
    """``kill()``: the accept loop stops and a keep-alive connection that
    was answering is cut, as if the server's process had died."""
    import http.client

    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    server = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                 registry=registry, block=False)
    port = server.bound_port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/")
        assert conn.getresponse().read() == b'{"status": "alive"}'
        server.kill()
        with pytest.raises((ConnectionError, http.client.HTTPException, OSError)):
            conn.request("GET", "/")
            conn.getresponse().read()
    finally:
        conn.close()
    with pytest.raises(OSError):
        request(port, "GET", "/", timeout=2)
    assert server.health._thread is None  # the ticker stopped with it
