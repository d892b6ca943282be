"""Batch views over an app's events (DEPRECATED — parity shim).

Copy of ``predictionio_tpu/storage/batch_view.py``, a rebuild of the
reference's deprecated batch-view layer
(``data/src/main/scala/io/prediction/data/view/LBatchView.scala:1-195``):
an eagerly-materialized event list with filter combinators, per-entity
time-ordered folds, and ``aggregateProperties``. The reference marked the
whole package ``/* Deprecated */`` and superseded it with
``LEvents.aggregateProperties`` — whose analogue here is
:meth:`EventStore.aggregate_properties`, the API new code should use.
This module exists for coverage of code that was written against the
view API; constructing a view emits a :class:`DeprecationWarning`.

Semantics preserved from the reference:

- ``filter(event=..., entity_type=..., start_time=..., until_time=...)``
  composes predicates over the materialized list (``EventSeq.filter``,
  ``LBatchView.scala:104-118``). NOTE the reference's start-time
  predicate is EXCLUSIVE (``!(before || equal)``) while its until-time
  is also exclusive — both faithfully mirrored, even though the storage
  layer's own ``EventFilter`` uses the conventional inclusive start.
- ``aggregate_by_entity_ordered(init, op)`` groups by entityId and folds
  each group ordered by event time (``LBatchView.scala:119-126``).
- ``aggregate_properties(entity_type)`` folds ``$set``/``$unset``/
  ``$delete`` in event order via the same DataMap rules as
  ``ViewAggregators.getDataMapAggregator`` (``LBatchView.scala:67-91``):
  unlike the modern monoid (``storage/aggregator.py``), this LEGACY fold
  applies ops strictly in event order with no timestamp tie-breaking —
  that is the deprecated layer's documented behavior, kept verbatim.
"""

from __future__ import annotations

import datetime as _dt
import warnings
from typing import Any, Callable, Dict, List, Optional

from .data_map import DataMap
from .event import SPECIAL_EVENTS, Event
from .events import EventFilter, EventStore

__all__ = ["EventSeq", "BatchView"]


class EventSeq:
    """Filterable materialized event list (``EventSeq``,
    ``LBatchView.scala:103-128``)."""

    def __init__(self, events: List[Event]):
        self.events = list(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def filter(
        self,
        event: Optional[str] = None,
        entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        predicate: Optional[Callable[[Event], bool]] = None,
    ) -> "EventSeq":
        def utc(t: Optional[_dt.datetime]) -> Optional[_dt.datetime]:
            # same convention as EventFilter: naive bounds are taken as
            # UTC (event times are always tz-aware)
            if t is not None and t.tzinfo is None:
                return t.replace(tzinfo=_dt.timezone.utc)
            return t

        start_time, until_time = utc(start_time), utc(until_time)
        out = self.events
        if event is not None:
            out = [e for e in out if e.event == event]
        if start_time is not None:
            # reference quirk: start is EXCLUSIVE here
            # (ViewPredicates.getStartTimePredicate)
            out = [e for e in out if e.event_time > start_time]
        if until_time is not None:
            out = [e for e in out if e.event_time < until_time]
        if entity_type is not None:
            out = [e for e in out if e.entity_type == entity_type]
        if predicate is not None:
            out = [e for e in out if predicate(e)]
        return EventSeq(out)

    def aggregate_by_entity_ordered(
        self, init: Any, op: Callable[[Any, Event], Any]
    ) -> Dict[str, Any]:
        """Group by entityId, fold each group ordered by event time
        (``aggregateByEntityOrdered``, ``LBatchView.scala:119-126``)."""
        groups: Dict[str, List[Event]] = {}
        for e in self.events:
            groups.setdefault(e.entity_id, []).append(e)
        out: Dict[str, Any] = {}
        for entity_id, evs in groups.items():
            acc = init
            for e in sorted(evs, key=lambda e: e.event_time):
                acc = op(acc, e)
            out[entity_id] = acc
        return out


def _data_map_aggregator(
    acc: Optional[DataMap], e: Event
) -> Optional[DataMap]:
    """``ViewAggregators.getDataMapAggregator`` (``LBatchView.scala:67-91``):
    strictly event-ordered $set/$unset/$delete fold."""
    if e.event == "$set":
        if acc is None:
            return e.properties
        return acc.merge(e.properties)  # the reference's ``++``
    if e.event == "$unset":
        if acc is None:
            return None
        return acc.without(e.properties.keyset())  # the reference's ``--``
    if e.event == "$delete":
        return None
    return acc  # do nothing for others


class BatchView:
    """``LBatchView(appId, startTime, untilTime)``: eagerly reads the
    window's events once; every aggregate derives from that snapshot."""

    def __init__(
        self,
        store: EventStore,
        app_id: int,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ):
        warnings.warn(
            "BatchView is deprecated (parity with the reference's "
            "deprecated data.view package); use "
            "EventStore.aggregate_properties / find instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self._store = store
        self.app_id = app_id
        self.start_time = start_time
        self.until_time = until_time
        # eager materialization, like the reference's lazy-val-forced list
        self.events = EventSeq(
            list(
                store.find(
                    app_id,
                    EventFilter(
                        start_time=start_time, until_time=until_time
                    ),
                )
            )
        )

    def aggregate_properties(
        self,
        entity_type: str,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Dict[str, DataMap]:
        """``LBatchView.aggregateProperties`` (``LBatchView.scala:143-166``):
        entity → folded DataMap, entities resolving to None dropped."""
        folded = (
            self.events.filter(
                entity_type=entity_type,
                start_time=start_time,
                until_time=until_time,
            )
            .filter(predicate=lambda e: e.event in SPECIAL_EVENTS)
            .aggregate_by_entity_ordered(None, _data_map_aggregator)
        )
        return {k: v for k, v in folded.items() if v is not None}
