"""The port's storage primary and remote family
(``predictionio_tpu_torch/storage/{storage_server,remote}.py``) against
the JAX package's, on the CPU.

Mirrors ``tests/test_remote_storage.py``'s metadata-RPC, model-blob and
registry cases against the port's primary, and holds the wire in both
directions: the JAX package's ``RemoteEventStore`` against the port's
server and the port's client against the JAX package's server give the
same records (exact equality). Then the primary's own surface: seq
headers, ``/replicate/changes`` and its 410 gap, ``/replicate/checkpoint``,
``/status.json``, deadline and trace headers, the ratings infeed over
``scan_columnar`` (equal to the local store's, exactly), and the refusals
that name ROADMAP.md queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.storage import MetadataStore as JaxMetadataStore
from predictionio_tpu.storage import SqliteEventStore as JaxSqliteEventStore
from predictionio_tpu.storage import remote as jremote
from predictionio_tpu.storage.event import Event as JaxEvent
from predictionio_tpu.storage.events import EventFilter as JaxEventFilter
from predictionio_tpu.storage.model_store import SqliteModelStore as JaxSqliteModelStore
from predictionio_tpu.storage.storage_server import StorageServer as JaxStorageServer
from predictionio_tpu_torch.storage import (
    AccessKey,
    App,
    EngineInstance,
    EngineManifest,
    Event,
    EventFilter,
    MetadataStore,
    Model,
    SqliteEventStore,
    SqliteModelStore,
    StorageRegistry,
)
from predictionio_tpu_torch.storage import remote, storage_server
from predictionio_tpu_torch.storage.changefeed import SEQ_HEADER
from predictionio_tpu_torch.storage.metadata import STATUS_COMPLETED, STATUS_INIT
from predictionio_tpu_torch.storage.remote import (
    RemoteEventStore,
    RemoteMetadataStore,
    RemoteModelStore,
    RemoteStorageError,
)

UTC = dt.timezone.utc
SEED = 29


def _start(server):
    server.start_background()
    return server


def _stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture(autouse=True)
def _fresh_breakers():
    remote.reset_resilience()
    yield
    remote.reset_resilience()


@pytest.fixture()
def primary(tmp_path):
    """The port's primary over in-memory stores, changefeed on."""
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    server = _start(storage_server.create_storage_server(
        "127.0.0.1", 0, reg, oplog_dir=str(tmp_path / "oplog")))
    yield server
    _stop(server)


@pytest.fixture()
def base_url(primary):
    return f"http://127.0.0.1:{primary.bound_port}"


@pytest.fixture()
def jax_server():
    server = JaxStorageServer("127.0.0.1", 0, JaxSqliteEventStore(":memory:"),
                              JaxMetadataStore(":memory:"), JaxSqliteModelStore(":memory:"))
    server.start_background()
    yield server
    server.shutdown()
    server.server_close()


def seeded_events(rng, cls, n=40):
    t0 = dt.datetime(2026, 3, 1, tzinfo=UTC)
    return [cls(event=["rate", "buy", "view"][int(rng.integers(3))], entity_type="user",
                entity_id=f"u{int(rng.integers(12))}", target_entity_type="item",
                target_entity_id=f"i{int(rng.integers(20))}",
                properties={"rating": float(rng.integers(1, 11)) / 2},
                event_time=t0 + dt.timedelta(seconds=int(k)), event_id=f"e{k:03d}")
            for k in range(n)]


def canon(events):
    return sorted(json.dumps(e.to_json_dict(), sort_keys=True) for e in events)


# -- metadata over RPC (tests/test_remote_storage.py) --------------------------
def test_remote_metadata_app_and_accesskey(base_url):
    md = RemoteMetadataStore(base_url)
    app_id = md.app_insert(App(id=0, name="remoteapp"))
    assert isinstance(app_id, int)
    assert md.app_get(app_id).name == "remoteapp"
    assert md.app_get_by_name("remoteapp").id == app_id
    assert [a.name for a in md.app_get_all()] == ["remoteapp"]
    key = md.access_key_insert(AccessKey(key="", appid=app_id, events=["rate"]))
    got = md.access_key_get(key)
    assert got.appid == app_id and list(got.events) == ["rate"]
    assert md.access_key_delete(key)


def test_remote_metadata_engine_instances(base_url):
    md = RemoteMetadataStore(base_url)
    t0 = dt.datetime(2026, 7, 2, tzinfo=UTC)
    iid = md.engine_instance_insert(EngineInstance(
        id="", status=STATUS_INIT, start_time=t0, end_time=t0, engine_id="e",
        engine_version="v", engine_variant="default", engine_factory="pkg.Factory"))
    got = md.engine_instance_get(iid)
    assert got.start_time == t0 and got.status == STATUS_INIT
    md.engine_instance_update(dataclasses.replace(got, status=STATUS_COMPLETED))
    latest = md.engine_instance_get_latest_completed("e", "v", "default")
    assert latest is not None and latest.id == iid
    assert md.manifest_update(EngineManifest(id="m", version="1", name="n",
                                             engine_factory="f"))
    assert md.manifest_get("m", "1").name == "n"
    assert md.gen_next("seq") == 1 and md.gen_next("seq") == 2


def test_remote_metadata_rejects_unknown_method(base_url):
    with pytest.raises(RemoteStorageError, match="HTTP 400"):
        remote._RemoteRPC(base_url, "os_system", 5.0)("rm -rf /")


def test_rpc_lists_are_the_jax_packages():
    from predictionio_tpu.storage import storage_server as jss
    from predictionio_tpu_torch.storage.changefeed import METADATA_MUTATING_METHODS

    assert storage_server.METADATA_RPC_METHODS == jss.METADATA_RPC_METHODS
    assert storage_server.METADATA_READ_METHODS == jss.METADATA_READ_METHODS
    assert (storage_server.METADATA_READ_METHODS | METADATA_MUTATING_METHODS
            == storage_server.METADATA_RPC_METHODS)
    assert storage_server.DEFAULT_PORT == jss.DEFAULT_PORT


def test_remote_models_roundtrip(base_url):
    ms = RemoteModelStore(base_url)
    blob = bytes(range(256)) * 10
    ms.insert(Model(id="m1", models=blob))
    assert ms.get("m1").models == blob
    ms.delete("m1")
    assert ms.get("m1") is None


@pytest.mark.parametrize("keys", ["url", "host_port"])
def test_registry_resolves_remote_type_from_env(keys, primary, base_url):
    env = {"PIO_STORAGE_SOURCES_RS_TYPE": "remote"}
    if keys == "url":
        env["PIO_STORAGE_SOURCES_RS_URL"] = base_url + "/"
    else:
        env.update(PIO_STORAGE_SOURCES_RS_HOST="127.0.0.1",
                   PIO_STORAGE_SOURCES_RS_PORT=str(primary.bound_port))
    reg = StorageRegistry(env)
    ev = reg.get_events()
    assert isinstance(ev, RemoteEventStore)
    ev.init(7)
    eid = ev.insert(Event(event="rate", entity_type="user", entity_id="u1",
                          target_entity_type="item", target_entity_id="i1"), 7)
    assert ev.get(eid, 7).entity_id == "u1" and ev.get("nope", 7) is None
    assert isinstance(reg.get_metadata(), RemoteMetadataStore)
    assert isinstance(reg.get_models(), RemoteModelStore)
    assert reg.get_events() is ev  # cached a source


# -- the wire in both directions ----------------------------------------------
def test_jax_client_against_the_port_primary_gives_the_same_records(primary, base_url):
    rng = np.random.default_rng(SEED)
    jax_store = jremote.RemoteEventStore(base_url)
    jax_store.init(3)
    sent = seeded_events(rng, JaxEvent)
    jax_store.write(sent[:30], 3)
    for e in sent[30:]:
        jax_store.insert(e, 3)
    port_side = canon(primary.events.find(3))
    assert canon(jax_store.find(3)) == canon(sent) == port_side
    flt = JaxEventFilter(event_names=["rate"], entity_id="u3", reversed=True, limit=3)
    got = [e.event_id for e in jax_store.find(3, flt)]
    want = [e.event_id for e in primary.events.find(3, EventFilter(
        event_names=["rate"], entity_id="u3", reversed=True, limit=3))]
    assert got == want
    cols = jax_store.scan_columnar(3)
    mine = RemoteEventStore(base_url).scan_columnar(3)
    assert {k: list(v) for k, v in cols.items()} == {k: list(v) for k, v in mine.items()}
    assert jax_store.delete("e000", 3) and jax_store.get("e000", 3) is None
    # the JAX client's metadata RPC through the port's primary
    jmd = jremote.RemoteMetadataStore(base_url)
    from predictionio_tpu.storage.metadata import App as JaxApp

    app_id = jmd.app_insert(JaxApp(id=0, name="from-jax"))
    assert RemoteMetadataStore(base_url).app_get(app_id).name == "from-jax"


def test_port_client_against_the_jax_server_gives_the_same_records(jax_server):
    rng = np.random.default_rng(SEED + 1)
    url = f"http://127.0.0.1:{jax_server.bound_port}"
    store = RemoteEventStore(url)
    store.init(5)
    sent = seeded_events(rng, Event)
    store.write_new(sent[:25], 5)
    store.write(sent[25:35], 5)
    for e in sent[35:]:
        store.insert(e, 5)
    assert canon(store.find(5)) == canon(sent) == canon(jax_server.events.find(5))
    got = [e.event_id for e in store.find(5, EventFilter(event_names=["buy"], limit=4))]
    want = [e.event_id for e in jax_server.events.find(5, JaxEventFilter(
        event_names=["buy"], limit=4))]
    assert got == want
    md = RemoteMetadataStore(url)
    app_id = md.app_insert(App(id=0, name="from-port"))
    assert jax_server.metadata.app_get(app_id).name == "from-port"
    ms = RemoteModelStore(url)
    ms.insert(Model(id="blob", models=b"\x00\x01" * 99))
    assert jax_server.models.get("blob").models == b"\x00\x01" * 99


# -- the primary's own surface -------------------------------------------------
def test_writes_carry_their_seq_and_the_changefeed_serves_them(primary, base_url):
    body = json.dumps({"event": "rate", "entityType": "u", "entityId": "1"}).encode()
    with remote._request(f"{base_url}/events/1", "POST", body) as resp:
        seq = int(resp.getheader(SEQ_HEADER))
    assert seq == primary.changefeed.last_seq >= 1
    RemoteEventStore(base_url).write([Event(event="rate", entity_type="u", entity_id="2")], 1)
    with urllib.request.urlopen(f"{base_url}/replicate/changes?since=0&limit=1") as resp:
        page = json.load(resp)
    assert [c["seq"] for c in page["changes"]] == [1] and page["lastSeq"] == 2
    assert page["generation"] == primary.changefeed.oplog.generation
    with urllib.request.urlopen(f"{base_url}/replicate/checkpoint") as resp:
        ck = json.load(resp)
    assert ck["seq"] == 2 and ck["oldestSeq"] == 1 and ck["stores"]["events"] == \
        "SqliteEventStore"
    with urllib.request.urlopen(f"{base_url}/status.json") as resp:
        status = json.load(resp)
    assert status["role"] == "primary" and status["seq"] == 2
    with urllib.request.urlopen(f"{base_url}/metrics") as resp:
        assert "pio_changefeed_seq 2" in resp.read().decode()


def test_a_cursor_older_than_the_log_is_a_410(tmp_path):
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    from predictionio_tpu_torch.storage.oplog import OpLog

    OpLog(str(tmp_path / "oplog"), base_seq=10).close()
    server = _start(storage_server.create_storage_server(
        "127.0.0.1", 0, reg, oplog_dir=str(tmp_path / "oplog")))
    try:
        url = f"http://127.0.0.1:{server.bound_port}"
        with pytest.raises(RemoteStorageError) as info:
            with remote._request(f"{url}/replicate/changes?since=2"):
                pass
        assert info.value.code == 410
        with pytest.raises(RemoteStorageError) as info:
            with remote._request(f"{url}/replicate/promote", "POST", b"{}"):
                pass
        assert info.value.code == 409
    finally:
        _stop(server)


def test_an_expired_deadline_is_answered_504_before_store_work(primary, base_url):
    req = urllib.request.Request(f"{base_url}/events/1/init", data=b"{}", method="POST",
                                 headers={"X-PIO-Deadline-Ms": "0"})
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req)
    assert info.value.code == 504
    assert primary.changefeed.last_seq == 0


def test_a_traced_call_joins_the_callers_trace(primary, base_url):
    from predictionio_tpu_torch.obs.trace import Tracer

    tracer = Tracer("caller")
    with tracer.server_span("POST /queries.json") as span:
        RemoteEventStore(base_url).init(1)
    from torch_plane import wait_until

    client = [s for s in tracer.store.dump() if s["name"] == "storage.POST"]
    # the server closes its span after the answer went out
    server = wait_until(lambda: [s for s in primary.tracer.store.dump()
                                 if s["name"] == "POST /events"], what="the server span")
    assert client and server[0]["traceId"] == client[0]["traceId"] == span.trace_id


def test_the_ratings_infeed_over_the_remote_store_equals_the_local_one(primary, base_url):
    from predictionio_tpu_torch.workflow import stream_ratings

    rng = np.random.default_rng(SEED + 2)
    events = seeded_events(rng, Event, n=300)
    RemoteEventStore(base_url).write(events, 4)
    rules = {"rate": "rating", "buy": 4.0}
    got = stream_ratings(RemoteEventStore(base_url), 4, rules, chunk_rows=64)
    want = stream_ratings(primary.events, 4, rules)
    for name in ("users", "items", "ratings"):
        assert np.array_equal(getattr(got, name), getattr(want, name))
    assert got.user_map.to_dict() == want.user_map.to_dict()
    assert got.item_map.to_dict() == want.item_map.to_dict()
    chunks = list(RemoteEventStore(base_url).scan_columnar_iter(4, chunk_rows=64))
    assert [len(c["event"]) for c in chunks] == [64, 64, 64, 64, 44]


def test_a_primary_without_a_changefeed_serves_every_route(tmp_path):
    """``create_storage_server`` without an oplog (``pio storageserver
    --no-changefeed``): the stores answer, no seq header, nothing to tail."""
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    server = _start(storage_server.create_storage_server("127.0.0.1", 0, reg))
    try:
        url = f"http://127.0.0.1:{server.bound_port}"
        store = RemoteEventStore(url)
        assert store.init(2)
        events = seeded_events(np.random.default_rng(SEED + 3), Event, n=12)
        store.write_new(events[:6], 2)
        store.write(events[6:10], 2)
        for e in events[10:]:
            with remote._request(store._path(2), "POST",
                                 json.dumps(e.to_json_dict()).encode()) as resp:
                assert resp.getheader(SEQ_HEADER) is None
        assert canon(store.find(2)) == canon(events)
        assert store.delete("e000", 2) and not store.delete("e000", 2)
        RemoteModelStore(url).insert(Model(id="m", models=b"x"))
        RemoteModelStore(url).delete("m")
        assert RemoteModelStore(url).get("m") is None
        assert RemoteMetadataStore(url).gen_next("s") == 1
        assert store.remove(2)
        for path in ("changes?since=0", "checkpoint"):
            with pytest.raises(RemoteStorageError) as info:
                with remote._request(f"{url}/replicate/{path}"):
                    pass
            assert info.value.code == 404
    finally:
        _stop(server)


@pytest.mark.parametrize("conf", [
    {"url": "pio+ha://a:1,b:2"}, {"url": "http://a:1;http://b:2"},
    {"nodes": "a:1,b:2"}, {"partitions": "a:1;b:2"},
])
def test_ha_and_partitioned_sources_name_item_12(conf):
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        remote.base_url(conf)


@pytest.mark.parametrize("kwargs", [{"partition_count": 2}, {"partition_index": 1,
                                                              "partition_count": 2}])
def test_a_partitioned_primary_names_item_12(kwargs, tmp_path):
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        storage_server.create_storage_server("127.0.0.1", 0, reg,
                                             oplog_dir=str(tmp_path), **kwargs)


@pytest.mark.parametrize("argv", [
    ["storageserver", "--replica-of", "http://127.0.0.1:1"],
    ["storageserver", "--partition-count", "2", "--port", "0"],
])
def test_storageserver_refusals_exit_1_naming_item_12(argv, tmp_path, capsys):
    from predictionio_tpu_torch.tools import console

    reg = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    assert console.main(argv, reg) == 1
    assert "queue 1 item 12)" in json.loads(capsys.readouterr().out)["error"]
