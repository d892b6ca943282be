"""The port's Event Server over a live socket.

Mirrors the JAX package's ``tests/test_event_server.py`` (the reference's
``EventServiceSpec`` routes: alive, 401 on a missing or wrong
``accessKey``, POST/GET/DELETE round trip, 400 on malformed events,
filtered finds with the default limit, stats by app and their hour
rollover, keep-alive after a rejected POST, the batch route) against both
of the port's event stores, and adds ``idempotencyKey`` deduplication and
``create_event_server`` over a registry.
"""

import datetime as dt

import pytest
import requests

from predictionio_tpu_torch.api import (
    EventServer,
    EventServerConfig,
    StatsTracker,
    create_event_server,
)
from predictionio_tpu_torch.storage import (
    AccessKey,
    App,
    Event,
    EventFilter,
    MetadataStore,
    NativeEventStore,
    SqliteEventStore,
    StorageRegistry,
)


@pytest.fixture(params=["sqlite", "native"])
def server(request, tmp_path):
    if request.param == "sqlite":
        events = SqliteEventStore(":memory:")
    else:
        events = NativeEventStore(str(tmp_path / "events_native"))
    metadata = MetadataStore(":memory:")
    app_id = metadata.app_insert(App(id=0, name="testapp"))
    metadata.access_key_insert(AccessKey(key="SECRET", appid=app_id, events=[]))
    events.init(app_id)
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0, stats=True), events, metadata)
    srv.start_background()
    yield f"http://127.0.0.1:{srv.bound_port}", app_id, events
    srv.shutdown()
    srv.server_close()
    events.close()


def _event_payload(**overrides):
    payload = {
        "event": "rate", "entityType": "user", "entityId": "u1",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": 4.5}, "eventTime": "2026-01-02T03:04:05.000Z",
    }
    payload.update(overrides)
    return payload


def test_root_alive(server):
    base, _, _ = server
    r = requests.get(f"{base}/")
    assert r.status_code == 200 and r.json() == {"status": "alive"}


@pytest.mark.parametrize("route,method", [
    ("/events.json", "post"), ("/events.json", "get"), ("/batches/events.json", "post"),
    ("/events/x.json", "get"), ("/events/x.json", "delete"), ("/stats.json", "get"),
])
@pytest.mark.parametrize("key", ["", "?accessKey=WRONG"])
def test_every_route_requires_an_access_key(server, route, method, key):
    base, _, _ = server
    body = [_event_payload()] if "batches" in route else _event_payload()
    r = getattr(requests, method)(f"{base}{route}{key}",
                                  json=body if method == "post" else None)
    assert r.status_code == 401
    assert r.json() == {"message": "Invalid accessKey."}


def test_post_get_delete_roundtrip(server):
    base, _, _ = server
    r = requests.post(f"{base}/events.json?accessKey=SECRET", json=_event_payload())
    assert r.status_code == 201
    event_id = r.json()["eventId"]
    r = requests.get(f"{base}/events/{event_id}.json?accessKey=SECRET")
    assert r.status_code == 200
    body = r.json()
    assert (body["event"], body["entityId"], body["targetEntityId"]) == ("rate", "u1", "i1")
    assert body["properties"]["rating"] == 4.5
    assert body["eventTime"].startswith("2026-01-02T03:04:05")
    r = requests.delete(f"{base}/events/{event_id}.json?accessKey=SECRET")
    assert r.status_code == 200 and r.json() == {"message": "Found"}
    assert requests.get(f"{base}/events/{event_id}.json?accessKey=SECRET").status_code == 404
    r = requests.delete(f"{base}/events/{event_id}.json?accessKey=SECRET")
    assert r.status_code == 404 and r.json() == {"message": "Not Found"}


def test_post_malformed_body_is_400(server):
    base, _, _ = server
    r = requests.post(f"{base}/events.json?accessKey=SECRET", data="{not json",
                      headers={"Content-Type": "application/json"})
    assert r.status_code == 400
    r = requests.post(f"{base}/events.json?accessKey=SECRET",
                      json=_event_payload(event="$set"))  # $set with a target
    assert r.status_code == 400


@pytest.mark.parametrize("field,value", [
    ("targetEntityType", 0), ("targetEntityType", False), ("entityType", 5), ("event", None),
])
def test_non_string_type_fields_are_400_not_500(server, field, value):
    base, _, _ = server
    r = requests.post(f"{base}/events.json?accessKey=SECRET",
                      json=_event_payload(**{field: value}))
    assert r.status_code == 400, r.text
    assert "message" in r.json()


def test_find_with_filters(server):
    base, _, _ = server
    for i in range(25):
        requests.post(f"{base}/events.json?accessKey=SECRET", json=_event_payload(
            entityId=f"u{i % 2}", eventTime=f"2026-01-{i + 1:02d}T00:00:00.000Z"))
    r = requests.get(f"{base}/events.json?accessKey=SECRET")
    assert r.status_code == 200 and len(r.json()) == 20  # the default limit
    assert len(requests.get(f"{base}/events.json?accessKey=SECRET&limit=-1").json()) == 25
    r = requests.get(f"{base}/events.json?accessKey=SECRET&entityType=user&entityId=u0&limit=-1")
    assert len(r.json()) == 13
    r = requests.get(f"{base}/events.json?accessKey=SECRET"
                     "&startTime=2026-01-02T00:00:00.000Z&untilTime=2026-01-04T00:00:00.000Z")
    assert len(r.json()) == 2
    r = requests.get(f"{base}/events.json?accessKey=SECRET&reversed=true&limit=3")
    times = [e["eventTime"] for e in r.json()]
    assert times == sorted(times, reverse=True) and times[0].startswith("2026-01-25")
    assert requests.get(f"{base}/events.json?accessKey=SECRET&event=none").status_code == 404
    assert requests.get(f"{base}/events.json?accessKey=SECRET&limit=x").status_code == 400


def test_stats_counts_by_app(server):
    base, _, _ = server
    requests.post(f"{base}/events.json?accessKey=SECRET", json=_event_payload())
    requests.post(f"{base}/events.json?accessKey=SECRET", json=_event_payload(event="buy"))
    no_target = _event_payload(event="view")
    del no_target["targetEntityType"], no_target["targetEntityId"]
    requests.post(f"{base}/events.json?accessKey=SECRET", json=no_target)
    snap = requests.get(f"{base}/stats.json?accessKey=SECRET").json()
    assert set(snap) == {"time", "currentHour", "prevHour", "longLive"}
    counted = {kv["key"]["event"]: kv["value"] for kv in snap["longLive"]["basic"]}
    assert counted == {"rate": 1, "buy": 1, "view": 1}
    assert snap["longLive"]["statusCode"] == [{"key": 201, "value": 3}]


def test_stats_disabled_is_404():
    events, metadata = SqliteEventStore(":memory:"), MetadataStore(":memory:")
    app_id = metadata.app_insert(App(id=0, name="nostats"))
    metadata.access_key_insert(AccessKey(key="K", appid=app_id))
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0), events, metadata)
    srv.start_background()
    try:
        r = requests.get(f"http://127.0.0.1:{srv.bound_port}/stats.json?accessKey=K")
        assert r.status_code == 404 and "stats" in r.json()["message"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_keepalive_survives_rejected_post(server):
    base, _, _ = server
    with requests.Session() as s:
        assert s.post(f"{base}/events.json", json=_event_payload()).status_code == 401
        assert s.post(f"{base}/events.json?accessKey=SECRET",
                      json=_event_payload()).status_code == 201


def test_stats_tracker_hour_rollover():
    tracker = StatsTracker()
    e = Event(event="rate", entity_type="user", entity_id="u1")
    tracker.bookkeeping(7, 201, e)
    assert tracker.get(7)["currentHour"]["statusCode"] == [{"key": 201, "value": 1}]
    tracker.hourly.start_time = tracker.hourly.start_time - dt.timedelta(hours=2)
    tracker.bookkeeping(7, 201, e)
    snap = tracker.get(7)
    assert snap["currentHour"]["statusCode"] == [{"key": 201, "value": 1}]
    assert snap["longLive"]["statusCode"] == [{"key": 201, "value": 2}]
    assert tracker.get(8)["longLive"]["basic"] == []


def test_batch_events_route(server):
    base, _, _ = server
    batch = [_event_payload(entityId=f"b{i}") for i in range(5)] + [
        {"event": "", "entityType": "user", "entityId": "bad"},
        _event_payload(entityId="b-last", eventId="client-chosen-id"),
        5,
    ]
    r = requests.post(f"{base}/batches/events.json?accessKey=SECRET", json=batch)
    assert r.status_code == 200
    results = r.json()
    assert [x["status"] for x in results] == [201] * 5 + [400, 201, 400]
    assert "message" in results[5] and "JSON object" in results[7]["message"]
    assert results[6]["eventId"] == "client-chosen-id"
    found = requests.get(f"{base}/events.json?accessKey=SECRET&limit=-1").json()
    ids = {e["entityId"] for e in found}
    assert {f"b{i}" for i in range(5)} <= ids and "b-last" in ids and "bad" not in ids
    eid = results[0]["eventId"]
    assert requests.get(f"{base}/events/{eid}.json?accessKey=SECRET").status_code == 200
    r = requests.post(f"{base}/batches/events.json?accessKey=SECRET", json={"not": "array"})
    assert r.status_code == 400


def test_idempotency_key_inserts_once(server):
    base, app_id, events = server
    body = _event_payload(entityId="once", idempotencyKey="req-1")
    first = requests.post(f"{base}/events.json?accessKey=SECRET", json=body).json()
    again = requests.post(f"{base}/events.json?accessKey=SECRET", json=body).json()
    batch = requests.post(f"{base}/batches/events.json?accessKey=SECRET",
                          json=[body, _event_payload(entityId="x", idempotencyKey="")]).json()
    assert first == again and batch[0]["eventId"] == first["eventId"]
    assert batch[1]["status"] == 400
    stored = list(events.find(app_id, EventFilter(entity_type="user", entity_id="once")))
    assert [e.event_id for e in stored] == [first["eventId"]]


def test_metrics_route_counts_responses(server):
    base, _, _ = server
    requests.get(f"{base}/")
    requests.post(f"{base}/events.json", json=_event_payload())
    text = requests.get(f"{base}/metrics").text
    assert 'pio_http_responses_total{status="401"}' in text
    assert "pio_http_request_seconds" in text


def test_create_event_server_over_a_registry(tmp_path):
    registry = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    md = registry.get_metadata()
    app_id = md.app_insert(App(id=0, name="reg"))
    md.access_key_insert(AccessKey(key="RK", appid=app_id))
    srv = create_event_server(EventServerConfig(ip="127.0.0.1", port=0),
                              registry=registry, block=False)
    try:
        r = requests.post(f"http://127.0.0.1:{srv.bound_port}/events.json?accessKey=RK",
                          json=_event_payload())
        assert r.status_code == 201
        assert registry.get_events().get(r.json()["eventId"], app_id) is not None
    finally:
        srv.shutdown()
        srv.server_close()
