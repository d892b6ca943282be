"""Event store interface.

Rebuild of the reference's event DAO traits
(``data/src/main/scala/io/prediction/data/storage/LEvents.scala:30-402`` and
``PEvents.scala:30-119``). The L/P split (local futures vs. Spark RDDs)
collapses here into one interface: point ops for the serving path and bulk
``find``/``aggregate_properties`` scans for the training path. Backends return
plain iterators; the training infeed (``workflow/infeed.py``) turns them
into the dense arrays the trainer bucketizes (the analogue of
``newAPIHadoopRDD`` feeding executors). Copy of the JAX package's
``storage/events.py``.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt
from typing import Dict, Iterator, Optional, Sequence

from .aggregator import AGGREGATOR_EVENT_NAMES, aggregate_properties, aggregate_single
from .data_map import PropertyMap
from .event import UTC, Event


@dataclasses.dataclass(frozen=True)
class EventFilter:
    """Bulk-scan predicate set, mirroring the parameters of
    ``LEvents.futureFind`` (``LEvents.scala:121-147``) / ``PEvents.find``
    (``PEvents.scala:45-73``).

    To select events *without* a target entity, use
    ``has_target_entity_type=False`` (the analogue of the reference's
    ``targetEntityType = Some(None)`` encoding).
    """

    start_time: Optional[_dt.datetime] = None  # inclusive
    until_time: Optional[_dt.datetime] = None  # exclusive
    entity_type: Optional[str] = None
    entity_id: Optional[str] = None
    event_names: Optional[Sequence[str]] = None
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    has_target_entity_type: Optional[bool] = None  # None = don't care
    has_target_entity_id: Optional[bool] = None
    limit: Optional[int] = None  # None or <0 = unlimited (LEvents.scala:137)
    reversed: bool = False  # descending event time (LEvents.scala:139)

    def __post_init__(self):
        # Naive bounds are taken as UTC, matching Event's convention.
        for field in ("start_time", "until_time"):
            t = getattr(self, field)
            if t is not None and t.tzinfo is None:
                object.__setattr__(self, field, t.replace(tzinfo=UTC))

    def matches(self, e: Event) -> bool:
        if self.start_time is not None and e.event_time < self.start_time:
            return False
        if self.until_time is not None and e.event_time >= self.until_time:
            return False
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.entity_id is not None and e.entity_id != self.entity_id:
            return False
        if self.event_names is not None and e.event not in set(self.event_names):
            return False
        if self.has_target_entity_type is not None:
            if self.has_target_entity_type != (e.target_entity_type is not None):
                return False
        if (
            self.target_entity_type is not None
            and e.target_entity_type != self.target_entity_type
        ):
            return False
        if self.has_target_entity_id is not None:
            if self.has_target_entity_id != (e.target_entity_id is not None):
                return False
        if (
            self.target_entity_id is not None
            and e.target_entity_id != self.target_entity_id
        ):
            return False
        return True


class EventStore(abc.ABC):
    """Unified event DAO (reference ``LEvents`` + ``PEvents``)."""

    # -- lifecycle (LEvents.scala:44-56) ----------------------------------
    @abc.abstractmethod
    def init(self, app_id: int) -> bool:
        """Initialize per-app storage (HBase table creation analogue)."""

    @abc.abstractmethod
    def remove(self, app_id: int) -> bool:
        """Remove all events of an app and its storage."""

    def close(self) -> None:
        """Release resources (``LEvents.scala:63``)."""

    # -- point ops (LEvents.scala:65-119) ---------------------------------
    @abc.abstractmethod
    def insert(self, event: Event, app_id: int) -> str:
        """Insert one event, returning its assigned event id."""

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int) -> Optional[Event]:
        ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int) -> bool:
        ...

    # -- bulk scan (LEvents.scala:121-145 / PEvents.scala:45-73) ----------
    @abc.abstractmethod
    def find(
        self, app_id: int, filter: Optional[EventFilter] = None
    ) -> Iterator[Event]:
        """Events ordered by event time (descending when ``filter.reversed``)."""

    def scan_columnar_iter(
        self,
        app_id: int,
        filter: Optional[EventFilter] = None,
        chunk_rows: int = 1_000_000,
    ) -> Iterator[dict]:
        """Chunked columnar scan: yields column dicts of at most
        ``chunk_rows`` rows each (same keys as ``scan_columnar``).

        The streaming-infeed primitive (the analogue of the reference's
        region-split reads feeding executors, ``HBPEvents.scala:58-98``):
        a training pipeline can translate + stage each chunk while the next
        is being read, holding one chunk of Python objects at a time
        instead of the whole app. Backends override with columnar fast
        paths; this base version derives chunks from ``find``.
        """
        import numpy as np

        from .event import to_millis

        def new_cols() -> dict:
            return {
                "event": [], "entity_type": [], "entity_id": [],
                "target_entity_type": [], "target_entity_id": [],
                "properties": [], "event_time_ms": [],
            }

        cols = new_cols()
        for e in self.find(app_id, filter):
            cols["event"].append(e.event)
            cols["entity_type"].append(e.entity_type)
            cols["entity_id"].append(e.entity_id)
            cols["target_entity_type"].append(e.target_entity_type)
            cols["target_entity_id"].append(e.target_entity_id)
            cols["properties"].append(e.properties.to_dict())
            cols["event_time_ms"].append(to_millis(e.event_time))
            if len(cols["event"]) >= chunk_rows:
                cols["event_time_ms"] = np.asarray(
                    cols["event_time_ms"], dtype=np.int64
                )
                yield cols
                cols = new_cols()
        if cols["event"]:
            cols["event_time_ms"] = np.asarray(
                cols["event_time_ms"], dtype=np.int64
            )
            yield cols

    # -- derived views ----------------------------------------------------
    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Entity-state view over special events
        (``LEvents.scala:147-195`` / ``PEvents.scala:75-103``)."""
        events = self.find(
            app_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                event_names=AGGREGATOR_EVENT_NAMES,
            ),
        )
        result = aggregate_properties(events)
        if required:
            req = set(required)
            result = {
                k: v for k, v in result.items() if req.issubset(v.keyset())
            }
        return result

    def aggregate_properties_single(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Optional[PropertyMap]:
        """One entity's state (``LEvents.scala:197-245``)."""
        events = self.find(
            app_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=AGGREGATOR_EVENT_NAMES,
            ),
        )
        return aggregate_single(events)

    def find_single_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """Serving-side low-latency read for one entity
        (``LEvents.scala:306-402``) — used by e-commerce-style engines to
        apply live constraints at query time."""
        return self.find(
            app_id,
            EventFilter(
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=latest,
            ),
        )

    def write(self, events: Sequence[Event], app_id: int) -> None:
        """Bulk write (``PEvents.write``, ``PEvents.scala:105-118``)."""
        for e in events:
            self.insert(e, app_id)

    def write_new(self, events: Sequence[Event], app_id: int) -> None:
        """Bulk write of events the caller GUARANTEES are fresh (every
        ``event_id`` newly minted and unique) — backends may skip their
        upsert/replace machinery. Default: plain ``write``."""
        self.write(events, app_id)
