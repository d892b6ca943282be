"""Bidirectional ID ↔ index map.

Trimmed copy of ``predictionio_tpu/storage/bimap.py`` (``BiMap``, with
the accessors serving uses, the ``string_int`` constructor the
sequence recommender indexes its items with and ``from_ids``, which the
weight carries build their id maps with; ``HashedIdMap``, the hashed
big-id map of the training infeed; and the native batch id hash
``_fnv1a64_batch`` both it and the event log index by; ``EntityMap`` and
the vectorized constructors wait): the boundary between host-side string
ids and the device's dense indices — the forward map turns a query's
user id into a factor row, the inverse decodes top-k indices.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Generic, Iterable, Mapping, Optional, Sequence, TypeVar, Union

import numpy as np

from ..native import load_library

K = TypeVar("K")
V = TypeVar("V")

#: ids with their rows (``BiMap.to_dict()``), or ids listed in row order
IdsLike = Union[Mapping[str, int], Sequence[str]]


class BiMap(Generic[K, V]):
    """Immutable bidirectional map (``BiMap.scala:25-105``).

    Construction fails if values are not unique: the map must be
    invertible."""

    def __init__(self, forward: Mapping[K, V], _inverse: Optional[Mapping[V, K]] = None):
        self._forward: Dict[K, V] = dict(forward)
        if _inverse is None:
            inverse: Dict[V, K] = {}
            for k, v in self._forward.items():
                if v in inverse:
                    raise ValueError(
                        f"BiMap values must be unique; duplicate value {v!r}"
                    )
                inverse[v] = k
            self._inverse = inverse
        else:
            self._inverse = dict(_inverse)
        self._inverse_view: Optional["BiMap[V, K]"] = None

    def __getitem__(self, key: K) -> V:
        return self._forward[key]

    def get(self, key: K) -> Optional[V]:
        return self._forward.get(key)

    def __contains__(self, key: K) -> bool:
        return key in self._forward

    def __len__(self) -> int:
        return len(self._forward)

    @property
    def inverse(self) -> "BiMap[V, K]":
        """O(1) inverted view sharing this map's dicts (BiMaps are never
        mutated after construction), cached so the serving path can take
        ``.inverse`` per batch without copying the catalog. No
        back-pointer: a map↔view cycle would keep catalog-sized dicts
        alive past a ``/reload``."""
        inv = self._inverse_view
        if inv is None:
            inv = BiMap.__new__(BiMap)
            inv._forward = self._inverse
            inv._inverse = self._forward
            inv._inverse_view = None
            self._inverse_view = inv
        return inv

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_inverse_view", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._inverse_view = None

    def to_dict(self) -> Dict[K, V]:
        return dict(self._forward)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BiMap):
            return self._forward == other._forward
        return NotImplemented

    def __repr__(self) -> str:
        return f"BiMap({self._forward!r})"

    # -- constructors (BiMap.scala:110-164) -------------------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Distinct keys → dense [0, n) indices in first-seen order
        (``BiMap.stringInt``)."""
        seen: Dict[str, int] = {}
        for k in keys:
            if k not in seen:
                seen[k] = len(seen)
        return BiMap(seen)

    @staticmethod
    def from_ids(ids: IdsLike, rows: int, what: str) -> "BiMap[str, int]":
        """The id map of a table with ``rows`` rows, from ids with their
        rows or ids in row order; raises unless every row gets exactly
        one id (``what`` names the ids in the message)."""
        mapping = dict(ids) if isinstance(ids, Mapping) else {
            k: i for i, k in enumerate(ids)
        }
        if sorted(mapping.values()) != list(range(rows)):
            raise ValueError(
                f"{what} ids must map onto rows 0..{rows - 1} exactly once "
                f"(got {len(mapping)} ids for {rows} rows)"
            )
        return BiMap(mapping)


class HashedIdMap:
    """Fixed-capacity hashed id → index map for huge id spaces (the
    hashing trick): an id's index is ``fnv1a64(id, salt) & (capacity -
    1)``, computed natively in batch, so the map stores nothing per id.

    Aliased ids share a factor row: the fraction of ids sharing a slot
    with another is about ``1 - exp(-n / capacity)`` (size capacity >= 16n
    to keep it under about 6 %). Capacity is a power of two of at most
    2^31 (int32 indices) and is the factor table's row count downstream.
    There is no inverse, so keep an exact :class:`BiMap` for the side whose
    ids results must name (items). Forward-only ``BiMap`` interface:
    ``map_array``, ``[]``, ``get``, ``len`` (the capacity)."""

    _MAX_CAPACITY = 1 << 31

    def __init__(self, capacity: int, salt: int = 0):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {capacity}")
        if capacity > self._MAX_CAPACITY:
            raise ValueError(
                f"capacity {capacity} exceeds 2^31 (int32 indices); shard "
                "the id space across hosts instead of growing one map"
            )
        self.capacity = capacity
        self.salt = salt

    def __len__(self) -> int:
        return self.capacity

    def __getitem__(self, key: str) -> int:
        return int(self.map_array([key])[0])

    def get(self, key: str) -> int:
        # every key hashes somewhere: a hashed map has no unknown id
        return self[key]

    def __contains__(self, key: str) -> bool:
        return True

    @property
    def inverse(self):
        raise TypeError(
            "HashedIdMap cannot be inverted (indices do not decode to ids);"
            " use an exact BiMap for the side whose ids must be recovered"
        )

    def expected_collision_fraction(self, n_ids: int) -> float:
        """Fraction of ``n_ids`` ids expected to share a slot with another
        (about 1 - exp(-n / capacity))."""
        return 1.0 - float(np.exp(-n_ids / self.capacity))

    def map_array(self, keys: Iterable[str], missing: int = -1) -> np.ndarray:
        """int32 slot of each id of a chunk (one native call). ``missing``
        is accepted for ``BiMap`` compatibility and unused: every id has a
        slot."""
        keys = list(keys)
        if not keys:
            return np.zeros(0, dtype=np.int32)
        hashes = _fnv1a64_batch(keys, self.salt)
        return (hashes & np.uint64(self.capacity - 1)).astype(np.int32)


def _fnv1a64_batch(keys: Sequence[str], salt: int = 0) -> np.ndarray:
    """uint64 FNV-1a hashes of ``keys`` (UTF-8) in one threaded native
    call (``native/idhash.cc``), the offset basis XOR-ed with ``salt``:
    with salt 0, the event log's ``evlog_fnv1a64``. A hash of 0 reads as 1
    (0 means "no value" in a log header). A library that fails to build
    raises ``NativeBuildError``: there is no slower Python path."""
    lib = load_library("idhash")
    if not getattr(lib, "_pio_configured", False):
        lib.pio_fnv1a64_batch.restype = None
        lib.pio_fnv1a64_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib._pio_configured = True
    encoded = [k.encode("utf-8") for k in keys]
    buf = np.frombuffer(b"".join(encoded) or b"\0", dtype=np.uint8)
    ends = np.cumsum([len(e) for e in encoded], dtype=np.int64)
    out = np.empty(len(encoded), dtype=np.uint64)
    if encoded:
        lib.pio_fnv1a64_batch(
            buf.ctypes.data, ends.ctypes.data, len(encoded), salt, out.ctypes.data
        )
    return out
