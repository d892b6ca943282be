"""Schema-free property bags.

Copy of the JAX package's ``storage/data_map.py``: the reference's
``DataMap`` / ``PropertyMap`` (``data/src/main/scala/io/prediction/data/storage/DataMap.scala:38-194`` and
``PropertyMap.scala``): an immutable string-keyed bag of JSON values with typed
accessors, plus a ``PropertyMap`` that carries first/last-updated times from
property aggregation.

The reference backs this with json4s ``JValue``; here values are plain Python
JSON-compatible objects (``None``/bool/int/float/str/list/dict).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Iterator, Mapping, Optional, Type, TypeVar

T = TypeVar("T")

_JSON_TYPES = (type(None), bool, int, float, str, list, dict)


class DataMapException(Exception):
    """Raised on missing required fields or type mismatches.

    Mirrors ``DataMapException`` in ``DataMap.scala:30-36``.
    """


def _check_json_value(key: str, value: Any) -> Any:
    if not isinstance(value, _JSON_TYPES):
        raise DataMapException(
            f"DataMap field {key!r} holds non-JSON value of type "
            f"{type(value).__name__}"
        )
    return value


class DataMap(Mapping[str, Any]):
    """Immutable mapping of field name → JSON value with typed ``get``.

    Reference semantics (``DataMap.scala``):

    - ``get_as(name, as_type)`` raises :class:`DataMapException` when the
      field is missing (``require`` behavior, ``DataMap.scala:49-55``).
    - ``get_opt`` returns ``None`` when missing.
    - ``get(name, default)`` keeps the standard ``Mapping.get`` contract.
    - ``++`` merge (here ``|`` / :meth:`merge`) is right-biased.
    - ``--`` removal (:meth:`without`).
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        data = dict(fields or {})
        for k, v in data.items():
            if not isinstance(k, str):
                raise DataMapException(f"DataMap keys must be str, got {k!r}")
            _check_json_value(k, v)
        object.__setattr__(self, "_fields", data)

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    # -- Typed accessors ---------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapException(f"The field {name} is required.")

    def get(self, name: str, default: Any = None) -> Any:
        """Standard ``Mapping.get``: value or ``default`` when missing."""
        return self._fields.get(name, default)

    def get_as(self, name: str, as_type: Type[T] = object) -> T:
        """Return field ``name`` coerced to ``as_type``; raise if missing
        (the reference's typed ``get[T]``)."""
        self.require(name)
        return self._coerce(name, self._fields[name], as_type)

    def get_opt(self, name: str, as_type: Type[T] = object) -> Optional[T]:
        if name not in self._fields:
            return None
        return self._coerce(name, self._fields[name], as_type)

    def get_or_else(self, name: str, default: T) -> T:
        """Typed get with fallback (``DataMap.scala`` ``getOrElse``)."""
        value = self.get_opt(name, type(default))
        return default if value is None else value

    @staticmethod
    def _coerce(name: str, value: Any, as_type: Type[T]) -> T:
        if as_type is object or isinstance(value, as_type):
            return value  # type: ignore[return-value]
        # Numeric widening: int stored where float requested.
        if as_type is float and isinstance(value, int) and not isinstance(value, bool):
            return float(value)  # type: ignore[return-value]
        raise DataMapException(
            f"The field {name} has type {type(value).__name__}; "
            f"expected {as_type.__name__}."
        )

    # -- Combinators -------------------------------------------------------
    def merge(self, other: "DataMap") -> "DataMap":
        """Right-biased merge (reference ``++``, ``DataMap.scala:139-141``)."""
        merged = dict(self._fields)
        merged.update(other._fields)
        return DataMap(merged)

    __or__ = merge

    def without(self, keys) -> "DataMap":
        """Remove ``keys`` (reference ``--``, ``DataMap.scala:143-146``)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def is_empty(self) -> bool:
        return not self._fields

    def keyset(self) -> set:
        return set(self._fields)

    def to_dict(self) -> dict:
        return dict(self._fields)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        import json

        # Canonical JSON so equal maps (incl. nested dicts in any insertion
        # order) hash equally.
        return hash(json.dumps(self._fields, sort_keys=True, default=repr))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


class PropertyMap(DataMap):
    """A :class:`DataMap` plus aggregation provenance.

    Produced by property aggregation over ``$set/$unset/$delete`` events
    (reference ``PropertyMap.scala``): ``first_updated`` / ``last_updated``
    are event times of the earliest / latest contributing events.
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.to_dict() == other.to_dict()
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    def __hash__(self) -> int:
        return hash((super().__hash__(), self.first_updated, self.last_updated))
