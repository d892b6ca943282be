"""The port's oplog, changefeed and wire codec
(``predictionio_tpu_torch/storage/{oplog,changefeed,wire}.py``) against
the JAX package's, on the CPU.

Mirrors ``TestChangefeed`` (``tests/test_replication.py``),
``test_oplog_gap_is_loud`` and ``test_wire_roundtrip_records``
(``tests/test_remote_storage.py``), and holds the on-disk format: an
oplog directory written by either package is read op for op by the
other (same seqs, same generation, ops equal as JSON), a torn tail is cut
alike, and replaying either log through either package's ``apply_op``
rebuilds the same stores. Exact equality throughout: no tolerance.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import os

import numpy as np
import pytest

from predictionio_tpu.storage import (
    MetadataStore as JaxMetadataStore,
    SqliteEventStore as JaxSqliteEventStore,
)
from predictionio_tpu.storage import changefeed as jcf
from predictionio_tpu.storage import oplog as joplog
from predictionio_tpu.storage import wire as jwire
from predictionio_tpu.storage.event import Event as JaxEvent
from predictionio_tpu.storage.metadata import (
    App as JaxApp,
    EngineInstance as JaxEngineInstance,
)
from predictionio_tpu.storage.model_store import (
    Model as JaxModel,
    SqliteModelStore as JaxSqliteModelStore,
)
from predictionio_tpu_torch.storage import (
    App,
    EngineInstance,
    Event,
    EventFilter,
    MetadataStore,
    Model,
    SqliteEventStore,
    SqliteModelStore,
)
from predictionio_tpu_torch.storage import changefeed, oplog, wire
from predictionio_tpu_torch.storage.metadata import STATUS_COMPLETED, STATUS_INIT

UTC = dt.timezone.utc
SEED = 29


def port_stores():
    return SqliteEventStore(":memory:"), MetadataStore(":memory:"), SqliteModelStore(":memory:")


def jax_stores():
    return (JaxSqliteEventStore(":memory:"), JaxMetadataStore(":memory:"),
            JaxSqliteModelStore(":memory:"))


def seeded_ops(rng, event_cls, app_cls, model_cls):
    """A seeded script of mutations: (method, args) for a Changefeed."""
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    script = [("init_app", (7,)), ("metadata_rpc", ("app_insert", [app_cls(id=0, name="a")]))]
    for k in range(int(rng.integers(4, 8))):
        ev = event_cls(event="rate", entity_type="user", entity_id=f"u{rng.integers(20)}",
                       target_entity_type="item", target_entity_id=f"i{rng.integers(30)}",
                       properties={"rating": float(rng.integers(1, 11)) / 2},
                       event_time=t0 + dt.timedelta(seconds=k),
                       event_id=f"ev{k}")
        script.append(("insert_event", (ev, 7)))
    batch = [event_cls(event="buy", entity_type="user", entity_id=f"u{j}",
                       target_entity_type="item", target_entity_id=f"i{j}",
                       event_time=t0, event_id=f"b{j}") for j in range(3)]
    script += [("write_events", (batch, 7, False)),
               ("delete_event", ("ev0", 7)),
               ("metadata_rpc", ("gen_next", ["ids"])),
               ("metadata_rpc", ("gen_next", ["ids"])),
               ("put_model", (model_cls(id="m1", models=bytes(rng.integers(0, 256, 64,
                                                                              dtype=np.uint8))),)),
               ("delete_model", ("m1",))]
    return script


def run_script(cf, script):
    for name, args in script:
        getattr(cf, name)(*args)


def read_all(log):
    entries, last = log.read_since(0, limit=10_000)
    return [(s, json.dumps(op, sort_keys=True)) for s, op in entries], last


# -- the changefeed records (TestChangefeed) ----------------------------------
class TestChangefeed:
    def test_mutations_are_sequenced_and_resolved(self, tmp_path):
        events, md, models = port_stores()
        cf = changefeed.Changefeed(oplog.OpLog(str(tmp_path / "log")), events, md, models)
        cf.init_app(7)
        eid, _ = cf.insert_event(Event(event="rate", entity_type="u", entity_id="1"), 7)
        cf.write_events([Event(event="rate", entity_type="u", entity_id=str(i))
                         for i in range(3)], 7, fresh=False)
        entries, last = cf.oplog.read_since(0)
        assert [seq for seq, _ in entries] == list(range(1, last + 1))
        assert [op["kind"] for _, op in entries] == ["event_init", "event_insert", "event_write"]
        assert entries[1][1]["event"]["eventId"] == eid
        assert all(d.get("eventId") for d in entries[2][1]["events"])

    def test_noop_mutations_are_not_logged(self, tmp_path):
        events, md, models = port_stores()
        cf = changefeed.Changefeed(oplog.OpLog(str(tmp_path / "log")), events, md, models)
        app_id, _ = cf.metadata_rpc("app_insert", [App(id=0, name="a")])
        before = cf.last_seq
        assert cf.metadata_rpc("app_insert", [App(id=0, name="a")]) == (None, None)
        assert cf.metadata_rpc("app_delete", [app_id + 99]) == (False, None)
        assert cf.metadata_rpc("app_get", [app_id])[1] is None  # a read logs nothing
        assert cf.last_seq == before

    def test_gen_next_replays_idempotently(self, tmp_path):
        events, md, models = port_stores()
        cf = changefeed.Changefeed(oplog.OpLog(str(tmp_path / "log")), events, md, models)
        for _ in range(3):
            cf.metadata_rpc("gen_next", ["ids"])
        entries, _ = cf.oplog.read_since(0)
        r_events, r_md, r_models = port_stores()
        for _ in range(2):  # the whole suffix twice: advance-to absorbs it
            for _, op in entries:
                changefeed.apply_op(op, r_events, r_md, r_models)
        assert r_md.gen_next("ids") == 4

    def test_mutating_methods_are_the_jax_packages(self):
        assert changefeed.METADATA_MUTATING_METHODS == jcf.METADATA_MUTATING_METHODS
        assert (changefeed.SEQ_HEADER, changefeed.MIN_SEQ_HEADER) == (jcf.SEQ_HEADER,
                                                                      jcf.MIN_SEQ_HEADER)


def test_oplog_gap_is_loud(tmp_path):
    log = oplog.OpLog(str(tmp_path), base_seq=50)
    with pytest.raises(oplog.OpLogGap):
        log.read_since(10)
    assert log.checkpoint() == {"seq": 50, "generation": log.generation, "oldestSeq": 51}


@pytest.mark.parametrize("kwargs", [{"partition": (0, 2)}])
def test_a_partitioned_oplog_names_item_12(kwargs, tmp_path):
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        oplog.OpLog(str(tmp_path), **kwargs)
    # a directory the JAX package stamped with a partition slot, too
    joplog.OpLog(str(tmp_path / "j"), partition=(1, 2)).close()
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        oplog.OpLog(str(tmp_path / "j"))


# -- the wire codec (test_wire_roundtrip_records) ---------------------------
def _instance(cls, status):
    return cls(id="i1", status=status, start_time=dt.datetime(2026, 7, 1, 12, tzinfo=UTC),
               end_time=dt.datetime(2026, 7, 1, 12, 5, tzinfo=UTC), engine_id="e",
               engine_version="1", engine_variant="default", engine_factory="f",
               env={"A": "B"})


def test_wire_roundtrip_records():
    inst = _instance(EngineInstance, STATUS_INIT)
    assert wire.decode(wire.encode(inst)) == inst
    assert wire.decode(wire.encode([inst, {"k": inst}])) == [inst, {"k": inst}]
    assert wire.decode(wire.encode({"x": [1, "a", None, 2.5]})) == {"x": [1, "a", None, 2.5]}


@pytest.mark.parametrize("status", [STATUS_INIT, STATUS_COMPLETED])
def test_wire_encodes_as_the_jax_package_does(status):
    """The same record encodes to the same JSON in both packages, and each
    decodes the other's into its own record type."""
    port, jax = _instance(EngineInstance, status), _instance(JaxEngineInstance, status)
    assert json.dumps(wire.encode(port), sort_keys=True) == \
        json.dumps(jwire.encode(jax), sort_keys=True)
    assert wire.decode(jwire.encode(jax)) == port
    assert jwire.decode(wire.encode(port)) == jax


# -- the on-disk format in both directions ----------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_oplog_written_by_one_package_is_read_op_for_op_by_the_other(writer, tmp_path):
    rng = np.random.default_rng(SEED)
    path = str(tmp_path / "log")
    if writer == "jax":
        cf = jcf.Changefeed(joplog.OpLog(path), *jax_stores())
        run_script(cf, seeded_ops(rng, JaxEvent, JaxApp, JaxModel))
    else:
        cf = changefeed.Changefeed(oplog.OpLog(path), *port_stores())
        run_script(cf, seeded_ops(rng, Event, App, Model))
    cf.oplog.close()
    written = read_all(cf.oplog)
    port_log, jax_log = oplog.OpLog(path), joplog.OpLog(path)
    assert read_all(port_log) == read_all(jax_log) == written
    assert port_log.generation == jax_log.generation == cf.oplog.generation
    assert port_log.checkpoint() == jax_log.checkpoint()
    # reading from the middle, in pages, gives the same records
    mid = written[1] // 2
    assert port_log.read_since(mid, limit=3) == jax_log.read_since(mid, limit=3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_appends_interleave_across_packages(writer, tmp_path):
    """One package appends after the other reopened the log: the seqs run
    on, and each reads the other's records."""
    path = str(tmp_path / "log")
    first, second = (joplog, oplog) if writer == "jax" else (oplog, joplog)
    log = first.OpLog(path)
    for k in range(70):  # past the sparse index's stride
        log.append({"kind": "event_init", "app": k})
    log.close()
    log2 = second.OpLog(path)
    assert log2.last_seq == 70
    assert log2.append({"kind": "event_remove", "app": 1}) == 71
    log2.close()
    assert read_all(first.OpLog(path)) == read_all(second.OpLog(path))
    assert read_all(oplog.OpLog(path))[0][-1] == (71, json.dumps(
        {"app": 1, "kind": "event_remove"}, sort_keys=True))


@pytest.mark.parametrize("cut", [3, 11, 17])
def test_a_torn_tail_is_cut_alike(cut, tmp_path):
    path = str(tmp_path / "log")
    log = oplog.OpLog(path)
    for k in range(5):
        log.append({"kind": "event_init", "app": k})
    log.close()
    ops = os.path.join(path, "ops.log")
    with open(ops, "r+b") as fh:
        fh.truncate(os.path.getsize(ops) - cut)
    port_copy, jax_copy = str(tmp_path / "p"), str(tmp_path / "j")
    for dst in (port_copy, jax_copy):
        os.makedirs(dst)
        for name in os.listdir(path):
            with open(os.path.join(path, name), "rb") as src, \
                    open(os.path.join(dst, name), "wb") as out:
                out.write(src.read())
    p, j = oplog.OpLog(port_copy), joplog.OpLog(jax_copy)
    assert p.last_seq == j.last_seq == 4
    assert read_all(p) == read_all(j)
    with open(os.path.join(port_copy, "ops.log"), "rb") as a, \
            open(os.path.join(jax_copy, "ops.log"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_through_either_package_rebuilds_the_same_stores(writer, tmp_path):
    rng = np.random.default_rng(SEED + 1)
    path = str(tmp_path / "log")
    if writer == "jax":
        cf = jcf.Changefeed(joplog.OpLog(path), *jax_stores())
        run_script(cf, seeded_ops(rng, JaxEvent, JaxApp, JaxModel))
    else:
        cf = changefeed.Changefeed(oplog.OpLog(path), *port_stores())
        run_script(cf, seeded_ops(rng, Event, App, Model))
    entries, _ = cf.oplog.read_since(0, limit=10_000)
    p_events, p_md, p_models = port_stores()
    j_events, j_md, j_models = jax_stores()
    for _, op in entries:
        changefeed.apply_op(op, p_events, p_md, p_models)
        jcf.apply_op(op, j_events, j_md, j_models)
    got = sorted(json.dumps(e.to_json_dict(), sort_keys=True) for e in p_events.find(7))
    want = sorted(json.dumps(e.to_json_dict(), sort_keys=True) for e in j_events.find(7))
    inserts = sum(op["kind"] == "event_insert" for _, op in entries)
    assert got == want and len(got) == inserts + 3 - 1  # + the batch, - the delete
    assert [a.name for a in p_md.app_get_all()] == [a.name for a in j_md.app_get_all()]
    assert p_md.gen_next("ids") == j_md.gen_next("ids") == 3
    assert p_models.get("m1") is None and j_models.get("m1") is None
    assert [e.event_id for e in p_events.find(7, EventFilter(event_names=["buy"]))] == \
        [e.event_id for e in j_events.find(7, EventFilter(event_names=["buy"]))]


def test_resolved_events_keep_their_fields(tmp_path):
    events, md, models = port_stores()
    cf = changefeed.Changefeed(oplog.OpLog(str(tmp_path / "log")), events, md, models)
    ev = Event(event="rate", entity_type="user", entity_id="u1", target_entity_type="item",
               target_entity_id="i1", properties={"rating": 4.5})
    cf.write_events([ev], 7, fresh=True)
    (stored,) = list(events.find(7))
    (_, op), = cf.oplog.read_since(0)[0]
    assert op["events"][0]["eventId"] == stored.event_id
    assert dataclasses.replace(Event.from_json_dict(op["events"][0])) == stored
