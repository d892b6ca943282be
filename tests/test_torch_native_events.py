"""The port's native (C++) event log: what this backend owns.

Mirrors the single-log cases of the JAX package's
``tests/test_native_events.py`` (durability across reopen, torn-tail
recovery, tombstones, scan-capacity growth, time order, upserts, two
handles and two processes on one log, the registry's ``native`` type),
and adds: the log files of both packages read each other (same record
layout), the native batch id hash against the pure-Python FNV-1a that
the JAX package keeps as its fallback (exact), and the ratings scan
against the chunked path. Writer segments are not ported.
"""

import dataclasses
import datetime as dt
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage.native_events import NativeEventStore as JaxNativeEventStore
from predictionio_tpu_torch.storage import DataMap, Event, EventFilter, NativeEventStore
from predictionio_tpu_torch.storage.bimap import _fnv1a64_batch
from predictionio_tpu_torch.storage.native_events import NativeScanUnsupported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ts(i):
    return dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(hours=i)


@pytest.fixture()
def root(tmp_path):
    return str(tmp_path / "evnative")


def _fnv1a64_python(keys):
    """The pure-Python FNV-1a the JAX package falls back to (its
    ``storage/bimap.py``, salt 0), kept here as the native hash's oracle."""
    out = np.empty(len(keys), dtype=np.uint64)
    mask = (1 << 64) - 1
    for j, key in enumerate(keys):
        h = 14695981039346656037
        for b in key.encode("utf-8"):
            h = ((h ^ b) * 1099511628211) & mask
        out[j] = h if h else 1
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_batch_hash_matches_the_python_oracle(seed):
    rng = np.random.default_rng(seed)
    keys = ["", "a", "ñ–🎉", "user\x00u1"] + [
        "".join(chr(int(c)) for c in rng.integers(32, 0x3000, int(n)))
        for n in rng.integers(0, 40, 5000)
    ]
    np.testing.assert_array_equal(_fnv1a64_batch(keys), _fnv1a64_python(keys))
    assert _fnv1a64_batch([]).shape == (0,)


def test_native_hash_is_the_event_logs_hash():
    from predictionio_tpu_torch.storage.native_events import _fnv

    keys = ["rate", "user\x00u17", "e-42"]
    assert [_fnv(k) for k in keys] == _fnv1a64_batch(keys).tolist()


def test_persistence_across_reopen(root):
    s = NativeEventStore(root)
    eid = s.insert(Event(event="rate", entity_type="user", entity_id="u1",
                         properties=DataMap({"r": 1.5}), event_time=ts(0)), 1)
    s.close()
    s2 = NativeEventStore(root)
    assert s2.get(eid, 1).properties.get_as("r", float) == 1.5
    assert len(list(s2.find(1))) == 1
    s2.close()


def test_tombstone_survives_reopen(root):
    s = NativeEventStore(root)
    eid = s.insert(Event(event="a", entity_type="t", entity_id="1"), 1)
    keep = s.insert(Event(event="b", entity_type="t", entity_id="2"), 1)
    assert s.delete(eid, 1)
    s.close()
    s2 = NativeEventStore(root)
    assert s2.get(eid, 1) is None and s2.get(keep, 1) is not None
    assert [e.event for e in s2.find(1)] == ["b"]
    s2.close()


def test_torn_tail_truncated_on_reopen(root):
    s = NativeEventStore(root)
    for i in range(3):
        s.insert(Event(event="e", entity_type="t", entity_id=str(i), event_time=ts(i)), 1)
    path = s._log_path(1)
    s.close()
    with open(path, "ab") as f:  # a crash mid-append: half a header
        f.write(struct.pack("<II", 160, 0) + b"\x00" * 20)
    s2 = NativeEventStore(root)
    assert len(list(s2.find(1))) == 3
    s2.insert(Event(event="new", entity_type="t", entity_id="9"), 1)
    assert len(list(s2.find(1))) == 4
    s2.close()


def test_scan_cap_growth(root):
    s = NativeEventStore(root)
    events = [Event(event="rate", entity_type="u", entity_id=str(i % 7),
                    event_time=ts(i % 50)) for i in range(1500)]
    s.write(events, 1)
    assert len(list(s.find(1))) == 1500
    f = EventFilter(entity_type="u", entity_id="0")
    assert len(list(s.find(1, f))) == sum(e.entity_id == "0" for e in events)
    s.close()


def test_time_ordering_and_reverse(root):
    s = NativeEventStore(root)
    for i in [3, 0, 2, 1]:
        s.insert(Event(event=f"e{i}", entity_type="t", entity_id="x", event_time=ts(i)), 1)
    assert [e.event for e in s.find(1)] == ["e0", "e1", "e2", "e3"]
    assert [e.event for e in s.find(1, EventFilter(reversed=True, limit=2))] == ["e3", "e2"]
    s.close()


def test_reinsert_after_delete_is_live(root):
    s = NativeEventStore(root)
    e = Event(event="a", entity_type="t", entity_id="1", event_time=ts(0))
    eid = s.insert(e, 1)
    assert s.delete(eid, 1)
    s.insert(dataclasses.replace(e, event_id=eid), 1)
    assert s.get(eid, 1) is not None
    assert [ev.event_id for ev in s.find(1)] == [eid]
    s.close()


def test_two_handles_same_log(root):
    s1 = NativeEventStore(root)
    s1.init(1)
    assert list(s1.find(1)) == []
    s2 = NativeEventStore(root)
    s2.insert(Event(event="imported", entity_type="t", entity_id="1", event_time=ts(0)), 1)
    assert [e.event for e in s1.find(1)] == ["imported"]
    eid = s1.insert(Event(event="own", entity_type="t", entity_id="2", event_time=ts(1)), 1)
    assert [e.event for e in s2.find(1)] == ["imported", "own"]
    assert s2.get(eid, 1) is not None
    s1.close()
    s2.close()


def test_scan_columnar_times_and_reverse(root):
    s = NativeEventStore(root)
    for i in range(5):
        s.insert(Event(event="rate", entity_type="user", entity_id=f"u{i % 2}",
                       target_entity_type="item", target_entity_id=f"i{i}",
                       properties=DataMap({"rating": float(i)}), event_time=ts(i)), 1)
    cols = s.scan_columnar(1, EventFilter(event_names=["rate"]))
    assert cols["event_time_ms"].tolist() == [1577836800000 + i * 3600_000 for i in range(5)]
    rev = s.scan_columnar(1, EventFilter(reversed=True, limit=2))
    assert rev["target_entity_id"] == ["i4", "i3"]
    chunks = list(s.scan_columnar_iter(1, chunk_rows=2))
    assert [len(c["event"]) for c in chunks] == [2, 2, 1]
    s.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_two_packages_read_each_others_logs(writer, root):
    """One record layout: a log either package wrote, the other reads —
    point gets, filtered finds, tombstones and the ratings scan alike."""
    cls_w = NativeEventStore if writer == "port" else JaxNativeEventStore
    cls_r = JaxNativeEventStore if writer == "port" else NativeEventStore
    ev_w = Event if writer == "port" else JaxEvent
    w = cls_w(root)
    ids = []
    for i in range(40):
        ids.append(w.insert(ev_w(event="rate", entity_type="user", entity_id=f"u{i % 6}",
                                 target_entity_type="item", target_entity_id=f"i{i % 9}",
                                 properties={"rating": float(i % 5 + 1)},
                                 event_time=ts(i), creation_time=ts(100)), 3))
    w.delete(ids[7], 3)
    w.close()
    r = cls_r(root)
    assert r.get(ids[7], 3) is None
    assert r.get(ids[8], 3).entity_id == "u2"
    got = [e.entity_id for e in r.find(3)]
    assert got == [f"u{i % 6}" for i in range(40) if i != 7]
    users, items, vals, uids, iids = r.scan_ratings(3, {"rate": "rating"})
    assert len(users) == 39 and uids[users[0]] == "u0" and iids[items[-1]] == "i3"
    r.close()


def test_ratings_scan_declines_two_property_names(root):
    s = NativeEventStore(root)
    s.insert(Event(event="rate", entity_type="user", entity_id="u", target_entity_type="item",
                   target_entity_id="i", properties={"rating": 1.0}), 1)
    with pytest.raises(NativeScanUnsupported):
        s.scan_ratings(1, {"rate": "rating", "like": "score"})
    assert s.scan_ratings(2, {"rate": "rating"})[0].shape == (0,)  # no log yet
    s.close()


def test_registry_native_type(tmp_path):
    from predictionio_tpu_torch.storage import StorageRegistry

    reg = StorageRegistry({"PIO_STORAGE_SOURCES_N_TYPE": "native",
                           "PIO_STORAGE_SOURCES_N_PATH": str(tmp_path)})
    ev = reg.get_events()
    assert isinstance(ev, NativeEventStore)
    eid = ev.insert(Event(event="x", entity_type="t", entity_id="1"), 1)
    assert ev.get(eid, 1) is not None
    assert os.path.isdir(str(tmp_path / "events_native"))


def test_concurrent_cross_process_appends(root):
    """Two processes append to one log at once: the log's flock keeps
    every record whole and none is lost."""
    worker = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[3])
        from predictionio_tpu_torch.storage import Event, NativeEventStore, utcnow

        store = NativeEventStore(sys.argv[1])
        tag = sys.argv[2]
        for j in range(200):
            store.insert(Event(event="rate", entity_type="user", entity_id=f"{tag}-u{j}",
                               target_entity_type="item", target_entity_id=f"i{j % 7}",
                               properties={"rating": 1.0}, event_time=utcnow()), 1)
        store.close()
        print("DONE", tag)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", worker, root, f"p{k}", REPO],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-1500:]
        assert "DONE" in out
    store = NativeEventStore(root)
    ids = [e.entity_id for e in store.find(1)]
    assert len(ids) == 400 and len(set(ids)) == 400
    assert sum(i.startswith("p0-") for i in ids) == 200
    store.close()
