"""Property aggregation: fold ``$set/$unset/$delete`` into entity state.

Rebuild of the reference's aggregation monoid
(``data/src/main/scala/io/prediction/data/storage/PEventAggregator.scala:27-209``
and ``LEventAggregator.scala``): each special event becomes an :class:`EventOp`;
ops combine associatively and commutatively (per-field latest-timestamp wins),
so aggregation order never matters — the analogue of Spark's ``aggregateByKey``
is a plain fold here. Copy of the JAX package's ``storage/aggregator.py``.

Resolution rules (``PEventAggregator.scala:115-146``):

- No ``$set`` ever seen → entity has no property map (``None``).
- A field is dropped if an ``$unset`` of it is at a time >= the field's set time.
- A ``$delete`` at time >= the *latest* ``$set`` time deletes the entity;
  otherwise it drops every field whose set time <= the delete time.
- ``first_updated`` / ``last_updated`` span only the special events seen.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Dict, Iterable, Optional

from .data_map import PropertyMap
from .event import SPECIAL_EVENTS, Event, to_millis as _millis


@dataclasses.dataclass(frozen=True)
class PropTime:
    """A field value with the time it was set (``PEventAggregator.scala:27``)."""

    value: Any
    t: int  # epoch millis


@dataclasses.dataclass(frozen=True)
class EventOp:
    """Commutative monoid of property operations (``PEventAggregator.scala:87``)."""

    set_fields: Optional[Dict[str, PropTime]] = None
    set_t: int = 0  # latest $set event time (valid when set_fields is not None)
    unset_fields: Optional[Dict[str, int]] = None
    delete_t: Optional[int] = None
    first_updated: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None

    @classmethod
    def identity(cls) -> "EventOp":
        return cls()

    @classmethod
    def from_event(cls, e: Event) -> "EventOp":
        """``EventOp.apply`` (``PEventAggregator.scala:153-186``)."""
        t = _millis(e.event_time)
        if e.event == "$set":
            return cls(
                set_fields={k: PropTime(v, t) for k, v in e.properties.items()},
                set_t=t,
                first_updated=e.event_time,
                last_updated=e.event_time,
            )
        if e.event == "$unset":
            return cls(
                unset_fields={k: t for k in e.properties},
                first_updated=e.event_time,
                last_updated=e.event_time,
            )
        if e.event == "$delete":
            return cls(
                delete_t=t,
                first_updated=e.event_time,
                last_updated=e.event_time,
            )
        return cls()

    def combine(self, other: "EventOp") -> "EventOp":
        """Monoid ``++`` (``PEventAggregator.scala:95-110``)."""
        # $set merge: per-field latest time wins; latest set time kept.
        if self.set_fields is None:
            set_fields, set_t = other.set_fields, other.set_t
        elif other.set_fields is None:
            set_fields, set_t = self.set_fields, self.set_t
        else:
            merged = dict(self.set_fields)
            for k, pt in other.set_fields.items():
                cur = merged.get(k)
                if cur is None or pt.t > cur.t:
                    merged[k] = pt
            set_fields, set_t = merged, max(self.set_t, other.set_t)

        # $unset merge: per-field latest time wins.
        if self.unset_fields is None:
            unset_fields = other.unset_fields
        elif other.unset_fields is None:
            unset_fields = self.unset_fields
        else:
            unset_fields = dict(self.unset_fields)
            for k, t in other.unset_fields.items():
                if t > unset_fields.get(k, -1):
                    unset_fields[k] = t

        delete_ts = [t for t in (self.delete_t, other.delete_t) if t is not None]
        firsts = [d for d in (self.first_updated, other.first_updated) if d]
        lasts = [d for d in (self.last_updated, other.last_updated) if d]
        return EventOp(
            set_fields=set_fields,
            set_t=set_t,
            unset_fields=unset_fields,
            delete_t=max(delete_ts) if delete_ts else None,
            first_updated=min(firsts) if firsts else None,
            last_updated=max(lasts) if lasts else None,
        )

    __add__ = combine

    def to_property_map(self) -> Optional[PropertyMap]:
        """``toPropertyMap`` (``PEventAggregator.scala:115-146``)."""
        if self.set_fields is None:
            return None
        fields = dict(self.set_fields)

        # Fields unset at/after their set time are dropped. (The reference
        # indexes set.fields(k) directly; keys never $set are simply absent.)
        if self.unset_fields:
            for k, unset_t in self.unset_fields.items():
                pt = fields.get(k)
                if pt is not None and unset_t >= pt.t:
                    del fields[k]

        if self.delete_t is not None:
            if self.delete_t >= self.set_t:
                return None  # entity deleted after its last $set
            fields = {k: pt for k, pt in fields.items() if pt.t > self.delete_t}

        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(
            {k: pt.value for k, pt in fields.items()},
            first_updated=self.first_updated,
            last_updated=self.last_updated,
        )


#: Event names that participate in aggregation (``PEventAggregator.scala:191``).
AGGREGATOR_EVENT_NAMES = tuple(sorted(SPECIAL_EVENTS))


def aggregate_properties(
    events: Iterable[Event],
) -> Dict[str, PropertyMap]:
    """Fold events into per-entity property maps.

    The analogue of ``PEventAggregator.aggregateProperties``
    (``PEventAggregator.scala:193-209``) and
    ``LEventAggregator.aggregateProperties``; callers are expected to have
    filtered to one (entityType) and the special event names.
    """
    ops: Dict[str, EventOp] = {}
    for e in events:
        op = EventOp.from_event(e)
        cur = ops.get(e.entity_id)
        ops[e.entity_id] = op if cur is None else cur.combine(op)
    out: Dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def aggregate_single(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Aggregate events of a single entity (``LEventAggregator.scala``
    ``aggregatePropertiesSingle``)."""
    acc = EventOp.identity()
    for e in events:
        acc = acc.combine(EventOp.from_event(e))
    return acc.to_property_map()
