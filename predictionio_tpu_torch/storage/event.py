"""Event model and validation.

Copy of the JAX package's ``storage/event.py``: the reference's event
record and validation rules
(``data/src/main/scala/io/prediction/data/storage/Event.scala:37-115``):
an append-only, immutable event with entity / optional target-entity
addressing, a schema-free property bag, and reserved-name rules for the
``$set/$unset/$delete`` special events and the ``pio_`` prefix.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
from typing import Any, Mapping, Optional, Sequence, Union

from .data_map import DataMap

UTC = _dt.timezone.utc

#: Single-entity reserved events (``Event.scala:66``).
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Entity types exempt from the reserved-prefix rule (``Event.scala:102``).
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})

#: Property names exempt from the reserved-prefix rule (``Event.scala:103``).
BUILTIN_PROPERTIES: frozenset = frozenset()


class EventValidationError(ValueError):
    """An event violates the reference's validation rules."""


def is_reserved_prefix(name: str) -> bool:
    """``$``- or ``pio_``-prefixed names are reserved (``Event.scala:63-64``)."""
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def _as_datetime(value: Union[_dt.datetime, str, None]) -> Optional[_dt.datetime]:
    if value is None or isinstance(value, _dt.datetime):
        if isinstance(value, _dt.datetime) and value.tzinfo is None:
            # Reference default time zone is UTC (Event.scala:59).
            return value.replace(tzinfo=UTC)
        return value
    if isinstance(value, str):
        return parse_event_time(value)
    raise EventValidationError(f"Cannot interpret {value!r} as a datetime")


def parse_event_time(text: str) -> _dt.datetime:
    """Parse an ISO-8601 timestamp; naive times are taken as UTC."""
    t = text.strip()
    if t.endswith("Z") or t.endswith("z"):
        t = t[:-1] + "+00:00"
    try:
        parsed = _dt.datetime.fromisoformat(t)
    except ValueError as exc:
        raise EventValidationError(f"Invalid event time {text!r}: {exc}") from exc
    if parsed.tzinfo is None:
        parsed = parsed.replace(tzinfo=UTC)
    return parsed


def to_millis(when: _dt.datetime) -> int:
    """Epoch milliseconds; naive datetimes are taken as UTC."""
    if when.tzinfo is None:
        when = when.replace(tzinfo=UTC)
    return int(when.timestamp() * 1000)


#: one-slot memo for format_event_time: bulk imports and server-assigned
#: creation times repeat timestamps heavily (benign racy swap under
#: threads). Keyed on (datetime, utcoffset) — equal instants at different
#: offsets render differently and must not share an entry.
_last_time_fmt: tuple = (None, None, "")


def format_event_time(when: _dt.datetime) -> str:
    """ISO-8601 with millisecond precision and explicit offset."""
    last = _last_time_fmt
    offset = when.utcoffset()
    if last[0] is not None and when == last[0] and offset == last[1]:
        return last[2]
    out = when
    if out.tzinfo is None:
        out = out.replace(tzinfo=UTC)
    text = out.isoformat(timespec="milliseconds")
    globals()["_last_time_fmt"] = (when, offset, text)
    return text


@dataclasses.dataclass(frozen=True)
class Event:
    """One immutable event (``Event.scala:37-55``).

    ``event_id`` is assigned by the event store on insert; ``creation_time``
    records system arrival while ``event_time`` is when the event happened.
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: _dt.datetime = dataclasses.field(default_factory=utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = dataclasses.field(default_factory=utcnow)
    event_id: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        object.__setattr__(self, "event_time", _as_datetime(self.event_time))
        object.__setattr__(self, "creation_time", _as_datetime(self.creation_time))
        object.__setattr__(self, "tags", tuple(self.tags))

    # -- JSON codec (wire format of the Event Server, EventJson4sSupport) --
    def to_json_dict(self) -> dict:
        out: dict = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_dict(),
            "eventTime": format_event_time(self.event_time),
        }
        if self.event_id is not None:
            out["eventId"] = self.event_id
        if self.target_entity_type is not None:
            out["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            out["targetEntityId"] = self.target_entity_id
        if self.tags:
            out["tags"] = list(self.tags)
        if self.pr_id is not None:
            out["prId"] = self.pr_id
        out["creationTime"] = format_event_time(self.creation_time)
        return out

    @classmethod
    def from_json_dict(cls, obj: Mapping[str, Any]) -> "Event":
        def req(key: str) -> Any:
            if key not in obj:
                raise EventValidationError(f"field {key} is required")
            return obj[key]

        def req_str(key: str) -> str:
            v = req(key)
            if not isinstance(v, str):
                raise EventValidationError(f"field {key} must be a string")
            return v

        tet = obj.get("targetEntityType")
        if tet is not None and not isinstance(tet, str):
            # ids coerce (numeric ids are common) but TYPE names must be
            # strings — a JSON 0/false here would otherwise surface as an
            # uncaught AttributeError deep in validation (500, not 400)
            raise EventValidationError("field targetEntityType must be a string")
        now = utcnow()
        return cls(
            event=req_str("event"),
            entity_type=req_str("entityType"),
            entity_id=str(req("entityId")),
            target_entity_type=tet,
            target_entity_id=(
                None
                if obj.get("targetEntityId") is None
                else str(obj["targetEntityId"])
            ),
            properties=DataMap(obj.get("properties") or {}),
            event_time=_as_datetime(obj.get("eventTime")) or now,
            tags=tuple(obj.get("tags") or ()),
            pr_id=obj.get("prId"),
            creation_time=_as_datetime(obj.get("creationTime")) or now,
            event_id=obj.get("eventId"),
        )


def idempotency_event_id(app_id: int, key: str) -> str:
    """Deterministic event id for a client-supplied ``idempotencyKey``.

    The dedup mechanism rides the stores' existing upsert-by-``event_id``
    semantics (SQLite ``INSERT OR REPLACE``, the native log's
    last-write-wins replay): same ``(app, key)`` → same id → at most one
    stored event, however many times the POST is retried. That is what
    finally makes *writes* safe to retry on the online path — a retried
    insert with a key can only land on top of itself.
    """
    digest = hashlib.sha256(
        f"{int(app_id)}\x00{key}".encode("utf-8")
    ).hexdigest()
    # "idem" prefix keeps these ids visually distinct from the composite
    # entity-hash/millis/uuid scheme of make_event_id
    return f"idem{digest[:44]}"


def with_event_id(event: Event, event_id: str) -> Event:
    """Copy of ``event`` with ``event_id`` set — the bulk-ingest fast path.

    ``dataclasses.replace`` re-runs ``__init__``/``__post_init__`` (field
    normalization + property validation) per event; on a batch of
    already-validated events that is pure overhead, so this clones the
    instance dict directly. Only safe because Event is frozen (no
    aliasing hazards) and the input was already constructed through
    ``__init__``.
    """
    clone = object.__new__(Event)
    clone.__dict__.update(event.__dict__)
    clone.__dict__["event_id"] = event_id
    return clone


def validate_event(e: Event) -> None:
    """Apply the reference's validation rules (``Event.scala:70-99``).

    Written as plain conditionals (no helper-call/f-string work on the
    valid path): this runs per event on the bulk-ingest hot path.
    """
    if not e.event:
        raise EventValidationError("event must not be empty.")
    if not e.entity_type:
        raise EventValidationError("entityType must not be empty string.")
    if not e.entity_id:
        raise EventValidationError("entityId must not be empty string.")
    tet, tei = e.target_entity_type, e.target_entity_id
    if tet is not None and not tet:
        raise EventValidationError("targetEntityType must not be empty string")
    if tei is not None and not tei:
        raise EventValidationError("targetEntityId must not be empty string.")
    if (tet is None) != (tei is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be specified together."
        )
    if is_reserved_prefix(e.event):
        if not is_special_event(e.event):
            raise EventValidationError(
                f"{e.event} is not a supported reserved event name."
            )
        if e.event == "$unset" and e.properties.is_empty():
            raise EventValidationError(
                "properties cannot be empty for $unset event"
            )
        if tet is not None or tei is not None:
            raise EventValidationError(
                f"Reserved event {e.event} cannot have targetEntity"
            )
    if (
        is_reserved_prefix(e.entity_type)
        and e.entity_type not in BUILTIN_ENTITY_TYPES
    ):
        raise EventValidationError(
            f"The entityType {e.entity_type} is not allowed. "
            "'pio_' is a reserved name prefix."
        )
    if (
        tet is not None
        and is_reserved_prefix(tet)
        and tet not in BUILTIN_ENTITY_TYPES
    ):
        raise EventValidationError(
            f"The targetEntityType {tet} is not allowed. "
            "'pio_' is a reserved name prefix."
        )
    for key in e.properties.keyset():
        if is_reserved_prefix(key) and key not in BUILTIN_PROPERTIES:
            raise EventValidationError(
                f"The property {key} is not allowed. "
                "'pio_' is a reserved name prefix."
            )
