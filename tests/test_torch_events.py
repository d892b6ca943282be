"""The port's event model, stores, app/access-key metadata and registry.

Mirrors the JAX package's ``tests/test_storage_core.py`` (DataMap, event
validation, ``$set``/``$unset``/``$delete`` aggregation, the EventStore
contract, run here against both of the port's stores: SQLite and the
native log) and the apps/access-keys part of ``tests/test_metadata.py``,
plus parity with the JAX package: the same event has the same wire JSON
in both, and the same seeded events written through both packages'
stores read back as the same events. Exact comparisons throughout.
"""

import datetime as dt
import itertools

import numpy as np
import pytest

from predictionio_tpu.storage import (
    AccessKey as JaxAccessKey,
    App as JaxApp,
    Event as JaxEvent,
    EventFilter as JaxEventFilter,
    MetadataStore as JaxMetadataStore,
)
from predictionio_tpu.storage.native_events import NativeEventStore as JaxNativeEventStore
from predictionio_tpu.storage.sqlite_events import SqliteEventStore as JaxSqliteEventStore
from predictionio_tpu_torch.storage import (
    AccessKey,
    App,
    DataMap,
    DataMapException,
    Event,
    EventFilter,
    EventValidationError,
    MetadataStore,
    NativeEventStore,
    SqliteEventStore,
    StorageError,
    StorageRegistry,
    aggregate_properties,
    aggregate_single,
    validate_event,
)

UTC = dt.timezone.utc


def ts(seconds: int) -> dt.datetime:
    return dt.datetime(2024, 1, 1, tzinfo=UTC) + dt.timedelta(seconds=seconds)


@pytest.fixture(params=["sqlite", "native"])
def event_store(request, tmp_path):
    """Every store test runs against both of the port's event stores."""
    if request.param == "sqlite":
        store = SqliteEventStore(":memory:")
    else:
        store = NativeEventStore(str(tmp_path / "events_native"))
    store.init(1)
    yield store
    store.close()


# -- DataMap ------------------------------------------------------------------
class TestDataMap:
    def test_typed_get(self):
        d = DataMap({"a": 1, "b": "x", "c": [1, 2], "d": 2.5})
        assert d.get_as("a", int) == 1
        assert d.get_as("b", str) == "x"
        assert d.get_as("c", list) == [1, 2]
        assert d.get_as("d", float) == 2.5
        assert d.get_as("a", float) == 1.0

    def test_get_missing_and_wrong_type_raise(self):
        with pytest.raises(DataMapException):
            DataMap({}).get_as("nope", int)
        with pytest.raises(DataMapException):
            DataMap({"a": "str"}).get_as("a", int)

    def test_mapping_get_opt_and_or_else(self):
        d = DataMap({"a": 7})
        assert d.get("missing") is None and d.get("missing", "f") == "f"
        assert d.get_opt("a", int) == 7 and d.get_opt("zz", int) is None
        assert d.get_or_else("zz", 3) == 3

    def test_merge_right_biased_and_without(self):
        a = DataMap({"x": 1, "y": 2})
        assert (a | DataMap({"y": 9, "z": 3})).to_dict() == {"x": 1, "y": 9, "z": 3}
        assert a.without(["y"]).to_dict() == {"x": 1}

    def test_non_json_values_are_refused(self):
        with pytest.raises(DataMapException):
            DataMap({"a": object()})


# -- Event validation (Event.scala:70-99) ---------------------------------------
def _ok(**kw):
    return Event(**dict(dict(event="rate", entity_type="user", entity_id="u1"), **kw))


@pytest.mark.parametrize("kw", [
    dict(target_entity_type="item", target_entity_id="i1",
         properties=DataMap({"rating": 4.0})),
    dict(event="$set", properties=DataMap({"a": 1})),
    dict(event="$unset", properties=DataMap({"a": None})),
    dict(event="$delete"),
    dict(entity_type="pio_pr"),
])
def test_valid_events_pass(kw):
    validate_event(_ok(**kw))


@pytest.mark.parametrize("kw", [
    dict(event="$frob"), dict(event=""), dict(entity_type=""), dict(entity_id=""),
    dict(target_entity_type="item"), dict(target_entity_id="i1"),
    dict(event="$unset"),
    dict(event="$set", target_entity_type="item", target_entity_id="i1"),
    dict(entity_type="pio_thing"), dict(properties=DataMap({"pio_x": 1})),
])
def test_invalid_events_are_refused_like_the_jax_package(kw):
    with pytest.raises(EventValidationError) as ours:
        validate_event(_ok(**kw))
    from predictionio_tpu.storage import EventValidationError as JaxError
    from predictionio_tpu.storage import validate_event as jax_validate

    jax_kw = dict(kw)
    if "properties" in jax_kw:
        jax_kw["properties"] = jax_kw["properties"].to_dict()
    with pytest.raises(JaxError) as theirs:
        jax_validate(JaxEvent(**dict(dict(event="rate", entity_type="user",
                                          entity_id="u1"), **jax_kw)))
    assert str(ours.value) == str(theirs.value)


def test_json_roundtrip_and_wire_parity_with_the_jax_package():
    kw = dict(event="rate", entity_type="user", entity_id="u1",
              target_entity_type="item", target_entity_id="i1",
              properties={"rating": 4.0}, event_time=ts(5), tags=("a", "b"),
              pr_id="pr-1", creation_time=ts(9), event_id="e-1")
    e = Event(**kw)
    e2 = Event.from_json_dict(e.to_json_dict())
    assert e2 == e
    assert e.to_json_dict() == JaxEvent(**kw).to_json_dict()


def test_idempotency_ids_match_the_jax_package():
    from predictionio_tpu.storage.event import idempotency_event_id as jax_id
    from predictionio_tpu_torch.storage.event import idempotency_event_id

    assert idempotency_event_id(3, "req-1") == jax_id(3, "req-1")
    assert idempotency_event_id(3, "req-1") != idempotency_event_id(4, "req-1")


# -- aggregation (LEventAggregatorSpec / PEventAggregator.scala) --------------------
def set_ev(eid, t, props):
    return Event(event="$set", entity_type="user", entity_id=eid,
                 properties=DataMap(props), event_time=ts(t))


def unset_ev(eid, t, keys):
    return Event(event="$unset", entity_type="user", entity_id=eid,
                 properties=DataMap({k: None for k in keys}), event_time=ts(t))


def delete_ev(eid, t):
    return Event(event="$delete", entity_type="user", entity_id=eid, event_time=ts(t))


class TestAggregation:
    def test_set_merge_latest_wins(self):
        pm = aggregate_properties([
            set_ev("u1", 10, {"a": 1, "b": 2}),
            set_ev("u1", 20, {"b": 3, "c": 4}),
            set_ev("u1", 15, {"b": 99}),
        ])["u1"]
        assert pm.to_dict() == {"a": 1, "b": 3, "c": 4}
        assert (pm.first_updated, pm.last_updated) == (ts(10), ts(20))

    def test_order_independence(self):
        events = [set_ev("u1", 10, {"a": 1}), unset_ev("u1", 15, ["a"]),
                  set_ev("u1", 20, {"a": 5})]
        results = {tuple(sorted(aggregate_single(list(p)).to_dict().items()))
                   for p in itertools.permutations(events)}
        assert results == {(("a", 5),)}

    @pytest.mark.parametrize("events,want", [
        ([set_ev("u1", 10, {"a": 1, "b": 2}), unset_ev("u1", 15, ["a"])], {"b": 2}),
        ([set_ev("u1", 10, {"a": 1}), unset_ev("u1", 5, ["a"])], {"a": 1}),
        ([set_ev("u1", 10, {"a": 1}), unset_ev("u1", 10, ["a"])], {}),
        ([set_ev("u1", 10, {"a": 1}), unset_ev("u1", 15, ["zz"])], {"a": 1}),
        ([set_ev("u1", 10, {"a": 1}), delete_ev("u1", 15), set_ev("u1", 20, {"b": 2})],
         {"b": 2}),
        ([set_ev("u1", 10, {"a": 1}), delete_ev("u1", 20)], None),
        ([unset_ev("u1", 5, ["a"])], None),
        ([delete_ev("u1", 5)], None),
    ])
    def test_resolution_rules(self, events, want):
        pm = aggregate_single(events)
        assert (None if pm is None else pm.to_dict()) == want

    def test_non_special_events_ignored_and_entities_kept_apart(self):
        rate = Event(event="rate", entity_type="user", entity_id="u1",
                     target_entity_type="item", target_entity_id="i1",
                     event_time=ts(50))
        pm = aggregate_single([set_ev("u1", 10, {"a": 1}), rate])
        assert pm.to_dict() == {"a": 1} and pm.last_updated == ts(10)
        out = aggregate_properties([set_ev("u1", 10, {"a": 1}),
                                    set_ev("u2", 11, {"a": 2}), delete_ev("u2", 12)])
        assert set(out) == {"u1"}


# -- the EventStore contract (EventsSpec analogue), both stores ------------------
class TestEventStore:
    def test_insert_get_roundtrip(self, event_store):
        e = Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties=DataMap({"rating": 4.5}), event_time=ts(1),
                  tags=("t1",), pr_id="p1")
        eid = event_store.insert(e, app_id=1)
        got = event_store.get(eid, app_id=1)
        assert (got.event, got.entity_id, got.target_entity_id) == ("rate", "u1", "i1")
        assert got.properties.get_as("rating", float) == 4.5
        assert got.event_time == ts(1) and got.tags == ("t1",) and got.pr_id == "p1"
        assert got.event_id == eid

    def test_delete(self, event_store):
        eid = event_store.insert(Event(event="e", entity_type="t", entity_id="i"), 1)
        assert event_store.delete(eid, 1) is True
        assert event_store.get(eid, 1) is None
        assert event_store.delete(eid, 1) is False

    def test_app_isolation(self, event_store):
        event_store.init(2)
        event_store.insert(Event(event="a", entity_type="t", entity_id="1"), 1)
        event_store.insert(Event(event="b", entity_type="t", entity_id="1"), 2)
        assert [e.event for e in event_store.find(1)] == ["a"]
        assert [e.event for e in event_store.find(2)] == ["b"]

    def test_find_filters(self, event_store):
        for i, (name, etype, eid_) in enumerate([
            ("rate", "user", "u1"), ("buy", "user", "u1"),
            ("rate", "user", "u2"), ("view", "item", "i1"),
        ]):
            event_store.insert(Event(event=name, entity_type=etype, entity_id=eid_,
                                     target_entity_type="item", target_entity_id="x",
                                     event_time=ts(i)), 1)
        assert len(list(event_store.find(1, EventFilter(event_names=["rate"])))) == 2
        f = EventFilter(entity_type="user", entity_id="u1")
        assert len(list(event_store.find(1, f))) == 2
        f = EventFilter(start_time=ts(1), until_time=ts(3))
        assert [e.event for e in event_store.find(1, f)] == ["buy", "rate"]
        f = EventFilter(limit=2, reversed=True)
        assert [e.event for e in event_store.find(1, f)] == ["view", "rate"]

    def test_aggregate_through_store(self, event_store):
        for e in (set_ev("u1", 10, {"a": 1}), unset_ev("u1", 15, ["a"]),
                  set_ev("u1", 20, {"b": 2}), set_ev("u2", 20, {"a": 9})):
            event_store.insert(e, 1)
        out = event_store.aggregate_properties(1, "user")
        assert out["u1"].to_dict() == {"b": 2} and out["u2"].to_dict() == {"a": 9}
        assert event_store.aggregate_properties_single(1, "user", "u1").to_dict() == {"b": 2}
        assert set(event_store.aggregate_properties(1, "user", required=["b"])) == {"u1"}

    def test_scan_columnar(self, event_store):
        for i in range(5):
            event_store.insert(Event(
                event="rate", entity_type="user", entity_id=f"u{i % 2}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": float(i)}), event_time=ts(i)), 1)
        cols = event_store.scan_columnar(1, EventFilter(event_names=["rate"]))
        assert cols["entity_id"] == ["u0", "u1", "u0", "u1", "u0"]
        assert [p["rating"] for p in cols["properties"]] == [0, 1, 2, 3, 4]
        assert cols["event_time_ms"].dtype == np.int64

    def test_bulk_write_and_write_new(self, event_store):
        events = [Event(event="rate", entity_type="user", entity_id=f"u{i}",
                        event_time=ts(i)) for i in range(30)]
        event_store.write(events[:10], 1)
        event_store.write_new([e for e in events[10:]], 1)
        assert [e.entity_id for e in event_store.find(1)] == [f"u{i}" for i in range(30)]

    def test_explicit_id_upserts(self, event_store):
        e = Event(event="a", entity_type="t", entity_id="1", event_time=ts(0),
                  properties=DataMap({"v": 1}), event_id="fixed")
        event_store.insert(e, 1)
        event_store.write([Event(event="a", entity_type="t", entity_id="1",
                                 event_time=ts(0), properties=DataMap({"v": 2}),
                                 event_id="fixed")], 1)
        (found,) = list(event_store.find(1))
        assert found.properties.get_as("v", int) == 2

    def test_remove_app(self, event_store):
        event_store.insert(Event(event="a", entity_type="t", entity_id="1"), 1)
        assert event_store.remove(1)
        event_store.init(1)
        assert list(event_store.find(1)) == []


@pytest.mark.parametrize("kind", ["sqlite", "native"])
def test_the_same_events_read_back_alike_in_both_packages(kind, tmp_path):
    rng = np.random.default_rng(11)
    rows = [dict(event=str(rng.choice(["rate", "buy", "view"])), entity_type="user",
                 entity_id=f"u{int(rng.integers(20))}", target_entity_type="item",
                 target_entity_id=f"i{int(rng.integers(30))}",
                 properties={"rating": float(rng.integers(1, 6))},
                 event_time=ts(int(rng.integers(0, 500))), creation_time=ts(900),
                 event_id=f"e{j}")
            for j in range(200)]
    if kind == "sqlite":
        ours, theirs = SqliteEventStore(":memory:"), JaxSqliteEventStore(":memory:")
    else:
        ours = NativeEventStore(str(tmp_path / "port"))
        theirs = JaxNativeEventStore(str(tmp_path / "jax"))
    ours.write([Event(**r) for r in rows], 5)
    theirs.write([JaxEvent(**r) for r in rows], 5)
    for flt_kw in ({}, dict(event_names=["rate"]), dict(entity_type="user", entity_id="u3"),
                   dict(reversed=True, limit=17), dict(start_time=ts(100), until_time=ts(300))):
        got = [e.to_json_dict() for e in ours.find(5, EventFilter(**flt_kw))]
        want = [e.to_json_dict() for e in theirs.find(5, JaxEventFilter(**flt_kw))]
        assert got == want
    a, b = ours.scan_columnar(5), theirs.scan_columnar(5)
    for key in a:
        assert list(a[key]) == list(b[key]), key


# -- apps and access keys (test_metadata.py) ----------------------------------------
class TestAppsAndKeys:
    def test_app_crud(self):
        md = MetadataStore(":memory:")
        app_id = md.app_insert(App(id=0, name="myapp", description="d"))
        assert md.app_get(app_id).name == "myapp"
        assert md.app_get_by_name("myapp").id == app_id
        assert md.app_insert(App(id=0, name="myapp")) is None  # name taken
        assert len(md.app_get_all()) == 1
        assert md.app_update(App(id=app_id, name="renamed"))
        assert md.app_get(app_id).name == "renamed"
        assert md.app_delete(app_id) and md.app_get(app_id) is None

    def test_generate_and_auth(self):
        md = MetadataStore(":memory:")
        key = md.access_key_insert(AccessKey(key="", appid=7, events=("rate",)))
        assert key and len(key) > 20
        ak = md.access_key_get(key)
        assert ak.appid == 7 and ak.events == ("rate",)
        assert md.access_key_get_by_app(7)[0].key == key
        assert md.access_key_insert(AccessKey(key=key, appid=8)) is None
        assert md.access_key_delete(key) and md.access_key_get(key) is None

    def test_one_metadata_file_serves_both_packages(self, tmp_path):
        path = str(tmp_path / "metadata.db")
        theirs = JaxMetadataStore(path)
        app_id = theirs.app_insert(JaxApp(id=0, name="shared"))
        theirs.access_key_insert(JaxAccessKey(key="K1", appid=app_id, events=("rate",)))
        ours = MetadataStore(path)
        assert ours.app_get_by_name("shared").id == app_id
        assert ours.access_key_get("K1") == AccessKey("K1", app_id, ("rate",))
        new_id = ours.app_insert(App(id=0, name="from-port"))
        ours.access_key_insert(AccessKey(key="K2", appid=new_id))
        assert theirs.app_get(new_id).name == "from-port"
        assert theirs.access_key_get("K2").appid == new_id


# -- registry ----------------------------------------------------------------
@pytest.mark.parametrize("stype,cls", [
    ("sqlite", SqliteEventStore), ("localfs", SqliteEventStore),
    ("memory", SqliteEventStore), ("native", NativeEventStore),
])
def test_registry_event_families(stype, cls, tmp_path):
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_S_TYPE": stype,
                           "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path)})
    ev = reg.get_events()
    assert isinstance(ev, cls) and reg.get_events() is ev
    ev.init(1)
    eid = ev.insert(Event(event="x", entity_type="t", entity_id="1"), 1)
    assert ev.get(eid, 1) is not None


def test_registry_binds_eventdata_to_its_own_source(tmp_path):
    reg = StorageRegistry({
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "db"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "native",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "log"),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
    })
    assert isinstance(reg.get_events(), NativeEventStore)
    assert (tmp_path / "log" / "events_native").is_dir()
    assert isinstance(reg.get_metadata(), MetadataStore)
    bad = StorageRegistry({"PIO_STORAGE_SOURCES_LOG_TYPE": "native",
                           "PIO_STORAGE_SOURCES_LOG_PATH": str(tmp_path / "x")})
    with pytest.raises(StorageError, match="metadata"):
        bad.get_metadata()


def test_default_registry_is_sqlite_under_the_base_dir(tmp_path):
    reg = StorageRegistry({"PIO_FS_BASEDIR": str(tmp_path)})
    assert isinstance(reg.get_events(), SqliteEventStore)
    reg.get_events().init(1)
    assert (tmp_path / "events.db").exists()
