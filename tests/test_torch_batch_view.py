"""The port's deprecated batch-view layer (``storage/batch_view.py``)
held to the JAX package's (``tests/test_batch_view.py``'s cases) on the
same events: filter combinators (exclusive start), event-ordered
per-entity folds, and the legacy DataMap aggregator.
"""

import datetime as dt

import pytest

from predictionio_tpu.storage import DataMap as JaxDataMap
from predictionio_tpu.storage import Event as JaxEvent
from predictionio_tpu.storage import SqliteEventStore as JaxSqliteEventStore
from predictionio_tpu.storage.batch_view import BatchView as JaxBatchView
from predictionio_tpu_torch.storage import DataMap, Event, SqliteEventStore
from predictionio_tpu_torch.storage.batch_view import BatchView

UTC = dt.timezone.utc


def ts(h):
    return dt.datetime(2021, 6, 1, h, tzinfo=UTC)


def _events(event_cls, map_cls):
    return [
        event_cls(event="$set", entity_type="item", entity_id="i1",
                  properties=map_cls({"a": 1, "b": 2}), event_time=ts(1)),
        event_cls(event="$unset", entity_type="item", entity_id="i1",
                  properties=map_cls({"b": 0}), event_time=ts(2)),
        event_cls(event="$set", entity_type="item", entity_id="i2",
                  properties=map_cls({"a": 9}), event_time=ts(3)),
        event_cls(event="$delete", entity_type="item", entity_id="i2", event_time=ts(4)),
        event_cls(event="$set", entity_type="user", entity_id="u1",
                  properties=map_cls({"x": 5}), event_time=ts(1)),
        event_cls(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties=map_cls({"rating": 4.0}), event_time=ts(5)),
    ]


@pytest.fixture()
def stores():
    port = SqliteEventStore(":memory:")
    port.init(1)
    port.write(_events(Event, DataMap), 1)
    jax = JaxSqliteEventStore(":memory:")
    jax.init(1)
    jax.write(_events(JaxEvent, JaxDataMap), 1)
    return port, jax


def _views(stores, **kw):
    with pytest.deprecated_call():
        port = BatchView(stores[0], 1, **kw)
    with pytest.deprecated_call():
        jax = JaxBatchView(stores[1], 1, **kw)
    return port, jax


def _props(folded):
    return {k: dict(v) for k, v in folded.items()}


@pytest.mark.parametrize("entity_type,want", [
    ("item", {"i1": {"a": 1}}),  # i1: set {a,b} then unset b; i2: set then $delete
    ("user", {"u1": {"x": 5}}),
])
def test_aggregate_properties_folds_in_event_order(stores, entity_type, want):
    port, jax = _views(stores)
    assert _props(port.aggregate_properties(entity_type)) == want
    assert _props(jax.aggregate_properties(entity_type)) == want


def test_filter_start_time_is_exclusive(stores):
    port, jax = _views(stores)
    seq = port.events.filter(start_time=ts(1))
    assert all(e.event_time > ts(1) for e in seq)
    assert len(seq) == len(port.events) - 2 == len(jax.events.filter(start_time=ts(1)))


def test_window_applies_at_view_construction(stores):
    port, jax = _views(stores, until_time=ts(4))
    # the rate at ts(5) and the $delete at ts(4) fall outside: i2's $set survives
    want = {"i1": {"a": 1}, "i2": {"a": 9}}
    assert _props(port.aggregate_properties("item")) == want
    assert _props(jax.aggregate_properties("item")) == want


def test_aggregate_by_entity_ordered_and_chained_filters(stores):
    port, jax = _views(stores)
    for view in (port, jax):
        counts = view.events.filter(entity_type="item").aggregate_by_entity_ordered(
            0, lambda acc, e: acc + 1)
        assert counts == {"i1": 2, "i2": 2}
        seq = view.events.filter(event="$set").filter(entity_type="item")
        assert {e.entity_id for e in seq} == {"i1", "i2"}
    order = port.events.aggregate_by_entity_ordered(
        (), lambda acc, e: acc + (e.event,))
    assert order == jax.events.aggregate_by_entity_ordered((), lambda acc, e: acc + (e.event,))


def test_naive_datetime_bounds_taken_as_utc(stores):
    port, jax = _views(stores)
    naive = dt.datetime(2021, 6, 1, 1)  # == ts(1) without tzinfo
    for view in (port, jax):
        assert all(e.event_time > ts(1) for e in view.events.filter(start_time=naive))
        props = view.aggregate_properties("item", until_time=dt.datetime(2021, 6, 1, 4))
        assert set(props) == {"i1", "i2"}
