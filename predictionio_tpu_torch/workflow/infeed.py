"""Streaming training infeed: event store → dense rating index arrays.

Copy of the JAX package's ``workflow/infeed.py``.

The reference feeds training through ``newAPIHadoopRDD`` region splits —
events stream from HBase regionservers into executor partitions without any
single host holding the whole dataset
(``data/src/main/scala/io/prediction/data/storage/hbase/HBPEvents.scala:58-98``).
This module is the analogue for the host side of that pipe: the
chunked columnar scan (``EventStore.scan_columnar_iter``) streams bounded
column chunks, each chunk is translated to dense int32 indices on the fly
(incremental BiMap build), and only the final index/value arrays — 12
bytes/rating — are retained. No per-event objects, no full-app Python
string lists: peak host memory is one chunk of decoded strings plus the
numeric output, instead of the 3× materialization of a read-all →
map-all → bucketize pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..storage.bimap import BiMap, HashedIdMap
from ..storage.events import EventFilter, EventStore


class StreamingIndexer:
    """Incremental ``BiMap.string_int``: dense indices in arrival order.

    Feeding chunks through :meth:`index_chunk` produces exactly the ids a
    one-shot ``BiMap.string_int(all_keys)`` would assign, without ever
    holding ``all_keys``.
    """

    def __init__(self):
        self._map: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._map)

    def index_chunk(self, keys: Sequence[str]) -> np.ndarray:
        """Translate one chunk, assigning fresh indices to unseen keys."""
        m = self._map
        out = np.empty(len(keys), dtype=np.int32)
        for j, k in enumerate(keys):
            v = m.get(k)
            if v is None:
                v = len(m)
                m[k] = v
            out[j] = v
        return out

    def to_bimap(self) -> BiMap:
        return BiMap(self._map)


#: Value rule for one event name: a float (fixed value, e.g. implicit
#: "buy" → 4.0) or a property name to read (required on the event).
ValueRule = Dict[str, object]


def _extract_chunk(cols: dict, value_rules: ValueRule):
    """One column chunk → (user ids, target ids, values), applying the
    per-event value rules and skipping target-less events."""
    uids: List[str] = []
    tids: List[str] = []
    vals: List[float] = []
    for ev, uid, tid, props in zip(
        cols["event"], cols["entity_id"],
        cols["target_entity_id"], cols["properties"],
    ):
        if tid is None:
            continue
        rule = value_rules[ev]
        if isinstance(rule, str):
            if rule not in props:
                raise ValueError(
                    f"{ev!r} event for {uid}->{tid} has no {rule!r} property"
                )
            vals.append(float(props[rule]))
        else:
            vals.append(float(rule))
        uids.append(uid)
        tids.append(tid)
    return uids, tids, vals


@dataclasses.dataclass
class RatingBatch:
    """Final product of a streaming read."""

    users: np.ndarray  # int32 [nnz]
    items: np.ndarray  # int32 [nnz]
    ratings: np.ndarray  # float32 [nnz]
    user_map: BiMap  # a HashedIdMap under ``hashed_users``
    item_map: BiMap


def stream_ratings(
    store: EventStore,
    app_id: int,
    value_rules: ValueRule,
    chunk_rows: int = 1_000_000,
    hashed_users: int = 0,
) -> RatingBatch:
    """Stream (entity → target, value) events into dense rating arrays.

    ``value_rules`` maps each event name to either a fixed float or the name
    of a required float property (the recommendation template's
    rate-vs-buy rule, ``DataSource.scala:25-55``). Events without a target
    entity are skipped.

    On a store with a native ratings scan (:class:`~predictionio_tpu_torch.
    storage.native_events.NativeEventStore`) the whole loop runs in C++
    and gives the same arrays and maps as the chunked path
    (:func:`_stream_ratings_chunked`), which every other store takes.

    ``hashed_users`` (a power-of-two capacity) switches the user side to
    :class:`~predictionio_tpu_torch.storage.bimap.HashedIdMap`, the
    big-id path for catalogs whose unique-user dict would not fit one
    host (see its aliasing trade-off); it takes the chunked path. Items
    keep the exact map: serving must decode item indices back to ids.
    """
    if hashed_users:
        return _stream_ratings_chunked(store, app_id, value_rules, chunk_rows,
                                       HashedIdMap(hashed_users))
    # Native fast path: the event log's C++ ratings scan does the whole
    # chunked loop in one pass (ratings.cc) — only the unique-id strings
    # cross into Python. Constraint: one distinct property name.
    n_props = len({r for r in value_rules.values() if isinstance(r, str)})
    if n_props <= 1 and hasattr(store, "scan_ratings"):
        from ..storage.native_events import NativeScanUnsupported

        try:
            users, items, vals, user_ids, item_ids = store.scan_ratings(
                app_id, value_rules
            )
        except NativeScanUnsupported:
            # the native scan declined (more than one property name): the
            # generic chunked path is always exact. Plain ValueError (bad
            # data) still propagates.
            pass
        else:
            return RatingBatch(
                users=users,
                items=items,
                ratings=vals,
                user_map=BiMap({k: i for i, k in enumerate(user_ids)}),
                item_map=BiMap({k: i for i, k in enumerate(item_ids)}),
            )
    return _stream_ratings_chunked(store, app_id, value_rules, chunk_rows)


def _stream_ratings_chunked(
    store: EventStore,
    app_id: int,
    value_rules: ValueRule,
    chunk_rows: int = 1_000_000,
    hashed: Optional[HashedIdMap] = None,
) -> RatingBatch:
    """The generic path of :func:`stream_ratings`: ``scan_columnar_iter``
    chunks of at most ``chunk_rows`` events, each translated by
    :class:`StreamingIndexer` (users by ``hashed`` when given) — the
    native scan's oracle."""
    user_ix = StreamingIndexer() if hashed is None else None
    index_users = user_ix.index_chunk if hashed is None else hashed.map_array
    item_ix = StreamingIndexer()
    u_parts: List[np.ndarray] = []
    i_parts: List[np.ndarray] = []
    v_parts: List[np.ndarray] = []

    flt = EventFilter(event_names=list(value_rules))
    for cols in store.scan_columnar_iter(app_id, flt, chunk_rows=chunk_rows):
        uids, tids, vals = _extract_chunk(cols, value_rules)
        if not uids:
            continue
        u_parts.append(index_users(uids))
        i_parts.append(item_ix.index_chunk(tids))
        v_parts.append(np.asarray(vals, dtype=np.float32))

    empty_i = np.zeros(0, dtype=np.int32)
    return RatingBatch(
        users=np.concatenate(u_parts) if u_parts else empty_i,
        items=np.concatenate(i_parts) if i_parts else empty_i,
        ratings=(
            np.concatenate(v_parts)
            if v_parts
            else np.zeros(0, dtype=np.float32)
        ),
        user_map=hashed if hashed is not None else user_ix.to_bimap(),
        item_map=item_ix.to_bimap(),
    )
