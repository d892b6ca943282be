"""Exact top-k merge over per-shard candidate lists.

Copy of ``predictionio_tpu/fleet/merge.py``. In sharded serving each query
server holds one partition of the item table and answers with its local
top-k; every item lives on exactly one shard and is scored against the
whole user row, so the global top-k is a subset of the union of the local
ones and the merge reproduces the unsharded answer exactly. Merge order
is ``(-score, item_id)``: ties break by item id, so any merger of the
same answers gives the same output.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "merge_item_scores",
    "merge_predictions",
    "merged_matches_reference",
]


def _sort_key(entry: Dict[str, Any]):
    # score descending, then item id ascending: a total order, so equal
    # scores cannot flap between merges or router replicas
    return (-float(entry.get("score", 0.0)), str(entry.get("item", "")))


def merge_item_scores(
    shard_lists: Sequence[Sequence[Dict[str, Any]]],
    k: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """K-way merge of per-shard ``[{"item", "score"}, ...]`` lists into
    the exact global top-``k`` (all entries when ``k`` is None).

    Each shard list is first ordered by the merge key (shards already
    return descending scores, but the merge must not *depend* on it —
    a misbehaving shard degrades to a sort, never to a wrong answer),
    then consumed through a heap so the common case is O(total · log S).
    """
    runs = [sorted(entries, key=_sort_key) for entries in shard_lists if entries]
    merged = heapq.merge(*runs, key=_sort_key)
    if k is None:
        return list(merged)
    out: List[Dict[str, Any]] = []
    for entry in merged:
        out.append(entry)
        if len(out) >= k:
            break
    return out


def merge_predictions(
    shard_results: Sequence[Any], k: Optional[int] = None
) -> Any:
    """Merge per-shard *encoded* prediction bodies (the ``/queries.json``
    response JSON) into one.

    Recognizes the templates' shared ``{"itemScores": [...]}`` wire
    shape (``models/wire.py``) and merges those lists exactly; any other
    shape cannot be sharded meaningfully, so the first shard's answer
    passes through unchanged — with a loud ``ValueError`` when shards
    *disagree* on non-mergeable bodies (silently picking one would turn
    a misconfigured fleet into quietly wrong answers)."""
    results = [r for r in shard_results if r is not None]
    if not results:
        return None
    if all(isinstance(r, dict) and "itemScores" in r for r in results):
        merged = dict(results[0])
        merged["itemScores"] = merge_item_scores(
            [r["itemScores"] for r in results], k
        )
        return merged
    first = results[0]
    if any(r != first for r in results[1:]):
        raise ValueError(
            "shard responses disagree and carry no itemScores list to "
            "merge; this engine's result shape cannot be served sharded"
        )
    return first


def merged_matches_reference(
    merged: Any, reference: Any, rtol: float = 1e-5, atol: float = 1e-6
) -> bool:
    """The f32 ranking-equality contract shared by sharded serving and
    the fused top-k kernels: identical item *ranking* (the top-k and its
    order — exact), scores equal to f32 reassociation tolerance. The
    item set/order is what "exact top-k" means; scores carry last-ulp
    noise because a product's accumulation order depends on the shapes,
    so a shard's table and the whole catalog — or a streamed tile and a
    dense row — round differently. A permutation is accepted only where
    the item sets agree and the positionwise scores still align, which
    confines any swap to a tied window (``|a-b| <= atol + rtol*|b|``,
    numpy ``allclose`` semantics)."""
    if not (isinstance(merged, dict) and isinstance(reference, dict)):
        return merged == reference
    got = merged.get("itemScores")
    want = reference.get("itemScores")
    if got is None or want is None:
        return merged == reference
    got_items = [e.get("item") for e in got]
    want_items = [e.get("item") for e in want]
    if got_items != want_items:
        # Two items whose scores differ by LESS than the tolerance can
        # legitimately swap rank between two computations of the same
        # top-k (the same noise, applied to a near-tie). Accept a
        # permutation only when the item SETS agree and the positionwise
        # scores still align — which confines any swap to within a tied
        # window; a genuinely different item in the list still fails.
        if set(got_items) != set(want_items):
            return False
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        ga, gb = float(a.get("score", 0.0)), float(b.get("score", 0.0))
        if not abs(ga - gb) <= atol + rtol * abs(gb):
            return False
    return True
