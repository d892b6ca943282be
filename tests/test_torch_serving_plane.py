"""The port's query-server request plane against the JAX package's server.

Both servers serve the same seeded factors (rank 6, 40 users, 90 items;
the port on ``device="cpu"``) and get the same requests:

- feedback: the ``predict`` event each POSTs to a capturing sink is the
  same body but for ``prId`` (its ``entityId`` and ``idempotencyKey``)
  and ``eventTime``; to the port's own Event Server it reads back once;
- the error log: a failed query POSTs ``{engineInstance, message,
  query}`` to ``--log-url``;
- deadlines: an expired budget is answered ``504`` with the same
  ``stage`` (admission, dispatch, batch-wait), driven by fake clocks and
  a batch held on an event, never by sleeping;
- a dead Event Server: the ``event-server`` breaker opens after the same
  deliveries on both, every query still answers, ``/metrics`` shows
  ``pio_breaker_state{dep="event-server"} 2``;
- ``GET /``, ``/shard.json``, ``pio_train_phase_seconds`` and the routes
  of modules that are not ported;
- a seeded concurrent burst answered alike (items equal but for ties,
  scores 1e-5).
"""

from __future__ import annotations

import re
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import predictionio_tpu.controller as jax_controller
import predictionio_tpu.models.recommendation as jax_rec
import predictionio_tpu.utils.resilience as jax_res
import predictionio_tpu_torch.controller as port_controller
import predictionio_tpu_torch.models.recommendation as port_rec
import predictionio_tpu_torch.utils.resilience as port_res
from predictionio_tpu_torch.api.event_server import EventServerConfig, create_event_server
from predictionio_tpu_torch.storage import StorageRegistry
from predictionio_tpu_torch.storage.events import EventFilter
from predictionio_tpu_torch.storage.metadata import AccessKey, App
from predictionio_tpu_torch.testing.clock import FakeClock

from torch_plane import (
    N_USERS,
    Sink,
    close_server,
    closed_port,
    jax_model,
    jax_server,
    port_model,
    port_server,
    request,
    same_ranking,
    wait_until,
)

SEED = 11


def both(tmp_path, **config):
    """(JAX server, port server) context managers on the same factors."""
    return (jax_server(tmp_path, jax_model(SEED), **config),
            port_server(tmp_path, port_model(SEED), **config))


def _feedback_to(port):
    return dict(feedback=True, event_server_ip="127.0.0.1", event_server_port=port,
                access_key="k")


def _without_ids(body):
    body = dict(body)
    pr_id = body.pop("entityId")
    assert body.pop("idempotencyKey") == pr_id  # the prId is the retry key
    assert re.fullmatch(r"[A-Za-z0-9]{64}", pr_id)
    event_time = body.pop("eventTime")
    assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3}\+00:00", event_time)
    props = dict(body.pop("properties"))
    prediction = props.pop("prediction")
    return body, props, prediction


def test_feedback_event_matches_the_jax_servers(tmp_path):
    sink = Sink()
    try:
        query = {"user": "u3", "num": 4}
        posts = []
        for i, ctx in enumerate(both(tmp_path, **_feedback_to(sink.port))):
            with ctx as server:
                status, answer, headers = request(server.bound_port, "POST", "/queries.json",
                                                  query, {"X-PIO-Trace": f"fb-{i}"})
                assert status == 200 and "prId" not in answer
                path, post_headers, body = sink.wait_for(i + 1)[i]
                assert path == "/events.json?accessKey=k"
                assert post_headers["X-PIO-Trace"] == headers["X-PIO-Trace"] == f"fb-{i}"
                posts.append((_without_ids(body), answer))
        (jax_body, jax_props, jax_pred), jax_answer = posts[0]
        (port_body, port_props, port_pred), port_answer = posts[1]
        assert port_body == jax_body == {"event": "predict", "entityType": "pio_pr"}
        assert port_props == jax_props == {"engineInstanceId": "EI-00000001",
                                           "query": query, "variant": "baseline"}
        assert same_ranking(port_pred, jax_pred) and same_ranking(port_answer, jax_answer)
    finally:
        sink.close()


def test_feedback_reads_back_from_the_ports_event_server(tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path / "events")})
    md = registry.get_metadata()
    app = md.app_insert(App(id=0, name="fb"))
    md.access_key_insert(AccessKey(key="k", appid=app))
    registry.get_events().init(app)
    events = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                                 registry=registry, block=False)
    try:
        with port_server(tmp_path, port_model(SEED), **_feedback_to(events.bound_port)) as srv:
            users = [f"u{u}" for u in range(8)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                answers = list(pool.map(lambda u: request(
                    srv.bound_port, "POST", "/queries.json", {"user": u, "num": 3}), users))
            assert all(status == 200 for status, _, _ in answers)
            wait_until(lambda: srv.stats.count("feedback_sent") == len(users),
                       what="eight deliveries")
            stored = list(registry.get_events().find(app, EventFilter(limit=-1)))
            assert sorted(e.properties.to_dict()["query"]["user"] for e in stored) == users
            assert {e.event for e in stored} == {"predict"}
            assert all(e.entity_type == "pio_pr" for e in stored)
            # the idempotency key makes a replayed delivery insert nothing
            ev = stored[0]
            replay = {"event": "predict", "entityType": "pio_pr", "entityId": ev.entity_id,
                      "idempotencyKey": ev.entity_id, "properties": {}}
            assert request(events.bound_port, "POST", "/events.json?accessKey=k",
                           replay)[0] == 201
            assert len(list(registry.get_events().find(app, EventFilter(limit=-1)))) == 8
            status = request(srv.bound_port, "GET", "/status.json")[1]
            assert status["stats"]["feedbackSent"] == 8 and status["feedback"] is True
    finally:
        close_server(events)


def test_error_log_posts_each_failure(tmp_path):
    sink = Sink()
    try:
        bodies = [{"user": "u1", "num": "ten"}, {"num": 3}]
        for i, ctx in enumerate(both(tmp_path, log_url=f"http://127.0.0.1:{sink.port}/log")):
            with ctx as server:
                statuses = [request(server.bound_port, "POST", "/queries.json", b)[0]
                            for b in bodies]
                assert statuses == [500, 400]
                posted = sink.wait_for(2 * (i + 1))[2 * i:]
                assert sorted(p[0] for p in posted) == ["/log", "/log"]
                got = sorted((p[2]["engineInstance"], str(p[2]["query"])) for p in posted)
                assert got == sorted(("EI-00000001", str(b)) for b in bodies)
                assert all(p[2]["message"] for p in posted)
    finally:
        sink.close()


class _Held:
    """A batch held on an event: the served batch waits (bounded) until
    the test lets it go."""

    def __init__(self):
        self.release = threading.Event()

    def wrap(self, original):
        def held(algo, model, indexed):
            self.release.wait(timeout=30)
            return original(algo, model, indexed)
        return held


@pytest.mark.parametrize("stage", ["admission", "dispatch", "batch-wait"])
def test_deadline_504_names_the_same_stage(stage, tmp_path, monkeypatch):
    results = []
    for name, rec, controller in (("jax", jax_rec, jax_controller),
                                  ("port", port_rec, port_controller)):
        clock = FakeClock()
        held = _Held()
        if stage == "dispatch":
            def slow_supplement(self, query, clock=clock):
                clock.advance(5.0)  # the supplement outlives the budget
                return query
            monkeypatch.setattr(controller.FirstServing, "supplement", slow_supplement,
                                raising=False)
        if stage == "batch-wait":
            monkeypatch.setattr(rec.ALSAlgorithm, "batch_predict",
                                held.wrap(rec.ALSAlgorithm.batch_predict))
        budget = {"admission": "0", "dispatch": "1000", "batch-wait": "50"}[stage]
        model = jax_model(SEED) if name == "jax" else port_model(SEED)
        ctx = (jax_server if name == "jax" else port_server)(
            tmp_path, model, server_kwargs={"clock": clock}, batch_wait_ms=0.0)
        with ctx as server:
            try:
                status, body, _ = request(server.bound_port, "POST", "/queries.json",
                                          {"user": "u1", "num": 2},
                                          {"X-PIO-Deadline-Ms": budget})
            finally:
                held.release.set()
            stats = request(server.bound_port, "GET", "/status.json")[1]["stats"]
            results.append((status, body["stage"], stats["deadlineExpired"]))
            assert "deadline exceeded" in body["message"]
        monkeypatch.undo()
    assert results[0] == results[1] == (504, stage, 1)


def test_a_dead_event_server_opens_the_breaker(tmp_path):
    dead = closed_port()
    outcomes = []
    for name, res in (("jax", jax_res), ("port", port_res)):
        clock = FakeClock()
        kwargs = {"clock": clock,
                  "retry_policy": res.RetryPolicy(attempts=2, sleep=lambda s: None),
                  "feedback_breaker": res.CircuitBreaker("event-server", failure_threshold=2,
                                                         reset_timeout_s=30.0, clock=clock)}
        model = jax_model(SEED) if name == "jax" else port_model(SEED)
        ctx = (jax_server if name == "jax" else port_server)(
            tmp_path, model, server_kwargs=kwargs, **_feedback_to(dead))
        with ctx as server:
            trace = []
            for n in range(5):
                status, _, _ = request(server.bound_port, "POST", "/queries.json",
                                       {"user": f"u{n}", "num": 3})
                # one delivery at a time: its outcome lands before the next
                wait_until(lambda: sum(server.stats.snapshot()[k] for k in (
                    "feedbackSent", "feedbackFailures", "feedbackSkipped")) == n + 1)
                trace.append((status, server.feedback_breaker.state))
            status = request(server.bound_port, "GET", "/status.json")[1]
            metrics = request(server.bound_port, "GET", "/metrics")[1]
            counts = {k: status["stats"][k] for k in ("feedbackFailures", "feedbackSkipped",
                                                      "feedbackSent", "requests")}
            outcomes.append((trace, counts, status["degraded"], status["status"],
                             status["breakers"]["eventServer"]["state"]))
            assert re.search(r'pio_breaker_state\{dep="event-server"(,variant="-")?\} 2', metrics)
            assert re.search(r'pio_breaker_opens\{dep="event-server"(,variant="-")?\} 1', metrics)
            if name == "port":
                assert 'pio_breaker_state{dep="error-log"} 0' in metrics
                assert "pio_observer_errors_total" in metrics
    assert outcomes[0] == outcomes[1]
    trace, counts, degraded, state, breaker = outcomes[1]
    assert [s for s, _ in trace] == [200] * 5
    assert [b for _, b in trace] == ["closed", "open", "open", "open", "open"]
    assert counts == {"feedbackFailures": 2, "feedbackSkipped": 3, "feedbackSent": 0,
                      "requests": 5}
    assert degraded and state == "degraded" and breaker == "open"


def test_status_page_shard_json_and_train_phases(tmp_path):
    env = {"PIO_TRAIN_PHASES": '{"prepare": 0.25, "read": 1.5, "train[0]": 3.0}'}
    pages = []
    for ctx in (jax_server(tmp_path, jax_model(SEED), env=env),
                port_server(tmp_path, port_model(SEED), env=env)):
        with ctx as server:
            port = server.bound_port
            status, page, headers = request(port, "GET", "/")
            assert status == 200 and headers["Content-Type"].startswith("text/html")
            assert "EI-00000001" in page and "Request count" in page
            status, doc, _ = request(port, "GET", "/", headers={"Accept": "application/json"})
            assert doc["engineInstance"] == "EI-00000001" and doc["degraded"] is False
            assert doc["trainPhases"] == {"prepare": 0.25, "read": 1.5, "train[0]": 3.0}
            shard = request(port, "GET", "/shard.json")[1]
            metrics = request(port, "GET", "/metrics")[1]
            lines = sorted(line for line in metrics.splitlines()
                           if line.startswith("pio_train_phase_seconds{"))
            pages.append((shard, lines))
    assert pages[0] == pages[1]
    shard, lines = pages[1]
    assert shard == {"sharded": False, "shardIndex": 0, "shardCount": 1,
                     "engineInstance": "EI-00000001",
                     "models": [{"type": "ALSModel", "items": 90}]}
    assert lines == ['pio_train_phase_seconds{phase="prepare"} 0.25',
                     'pio_train_phase_seconds{phase="read"} 1.5',
                     'pio_train_phase_seconds{phase="train[0]"} 3']


@pytest.mark.parametrize("method,path,item", [
    ("POST", "/rollout/start", 6), ("GET", "/rollout.json", 6),
    ("POST", "/continuous/trigger", 9), ("GET", "/continuous.json", 9),
])
def test_routes_of_modules_not_ported_name_their_item(method, path, item, tmp_path):
    with port_server(tmp_path, port_model(SEED)) as server:
        status, body, _ = request(server.bound_port, method, path, {})
        assert status == 404
        assert f"queue 1 item {item})" in body["message"]
        assert request(server.bound_port, "GET", "/nowhere")[1] == {"message": "Not Found"}


def test_port_and_jax_servers_answer_a_seeded_burst_alike(tmp_path):
    rng = np.random.default_rng(SEED)
    bodies = [{"user": f"u{u}", "num": int(n)}
              for u, n in zip(rng.integers(0, N_USERS, 46), rng.integers(1, 40, 46))]
    bodies += [{"user": "ghost", "num": 5}, {"user": "u0", "num": 500}]
    answers = []
    for ctx in both(tmp_path, batch_wait_ms=2.0):
        with ctx as server:
            with ThreadPoolExecutor(max_workers=16) as pool:
                got = list(pool.map(lambda b: request(server.bound_port, "POST",
                                                      "/queries.json", b), bodies))
            assert all(status == 200 for status, _, _ in got)
            answers.append([answer for _, answer, _ in got])
            batching = request(server.bound_port, "GET", "/status.json")[1]["batching"]
            assert batching["submitted"] == len(bodies)
    for jax_answer, port_answer in zip(*answers):
        assert same_ranking(port_answer, jax_answer)
    assert answers[1][-2] == {"itemScores": []} and len(answers[1][-1]["itemScores"]) == 90
