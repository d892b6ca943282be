"""Rollout policy primitives: gate config, sticky splits, divergence.

Copy of ``predictionio_tpu/rollout/plan.py``, the pure half of the
rollout plane: every function here is deterministic in its inputs (no
clocks, no storage, no server state), so the routing and the gate
arithmetic are the same in every process and across restarts.

- :class:`GateConfig` — the promotion-gate thresholds a
  :class:`~.controller.RolloutController` evaluates over sliding
  windows; serialized into ``RolloutPlan.gates``.
- :func:`variant_for_key` — the sticky split: SHA-256 over
  ``salt|key`` into one of 10,000 buckets, candidate iff the bucket
  falls under ``percent``.
- :func:`prediction_divergence` — a [0, 1] structural distance between
  two encoded predictions, the shadow stage's signal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterator, Tuple

from ..obs.quality import USER_KEY_FIELDS

__all__ = [
    "BASELINE",
    "CANDIDATE",
    "NUM_BUCKETS",
    "VARIANT_HEADER",
    "GateConfig",
    "bucket_for_key",
    "plan_epoch",
    "plan_to_json",
    "prediction_divergence",
    "sticky_key",
    "variant_for_key",
]

#: variant names — a closed two-value vocabulary, safe as a metric label
BASELINE = "baseline"
CANDIDATE = "candidate"

#: response header carrying the variant a query was SERVED by ("-" when
#: no rollout is involved)
VARIANT_HEADER = "X-PIO-Variant"

#: split resolution: percent maps to buckets out of 10,000 (0.01% steps)
NUM_BUCKETS = 10_000
_BUCKETS = NUM_BUCKETS

#: payload fields tried (in order) as the sticky entity key before
#: falling back to the whole canonicalized payload. The user-identity
#: prefix is the feedback join's field order too — shared from ONE home
#: (obs.quality, stdlib-only) or the served-list and feedback keys
#: silently diverge; item/id are sticky-only fallbacks for payloads
#: with no user field.
_ENTITY_KEY_FIELDS = USER_KEY_FIELDS + ("item", "id")


@dataclasses.dataclass(frozen=True)
class GateConfig:
    """Promotion-gate thresholds for one rollout.

    ``window_s``/``min_samples`` bound the sliding windows the gates
    read; the three gates themselves are *deltas against the baseline*,
    not absolutes — a candidate is judged by whether it made things
    worse, so the policy holds whether the fleet is fast or slow that
    day. ``*_hold_s`` is the minimum residence time per stage before
    auto-promotion (rollback is immediate — a failing gate never
    waits)."""

    window_s: float = 300.0
    min_samples: int = 50
    #: candidate error rate may exceed baseline's by at most this much
    max_error_rate_delta: float = 0.02
    #: candidate p99 may be at most this multiple of baseline p99
    max_p99_latency_ratio: float = 2.0
    #: mean shadow divergence ceiling (see prediction_divergence)
    max_divergence: float = 0.25
    shadow_hold_s: float = 60.0
    canary_hold_s: float = 120.0
    #: traffic share the candidate takes in the CANARY stage
    canary_percent: float = 10.0
    #: served-score distribution drift gate:
    #: roll back when the candidate's score PSI vs the pinned baseline
    #: snapshot exceeds this. 0 disables (the default — PSI needs the
    #: quality monitor's min_psi_samples on both sides before it reports,
    #: and an engine whose predictions carry no scores never reports).
    #: Unlike the other gates this one is an absolute distribution
    #: distance, not a delta: PSI is already measured against the live
    #: baseline's own distribution. Conventional reading: <0.1 stable,
    #: >0.25 a real shift.
    max_score_psi: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            f.name: float(getattr(self, f.name))
            for f in dataclasses.fields(self)
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "GateConfig":
        """Strict decode: an unknown key is a typo in an operator's gate
        override, and a typo that silently no-ops is a gate that never
        fires."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - fields)
        if unknown:
            raise ValueError(
                f"unknown gate option(s) {unknown}; expected {sorted(fields)}"
            )
        kwargs = {k: float(v) for k, v in data.items()}
        if "min_samples" in kwargs:
            kwargs["min_samples"] = int(kwargs["min_samples"])
        return cls(**kwargs)


def plan_to_json(plan: Any) -> Dict[str, Any]:
    """The camelCase wire shape of a ``RolloutPlan`` (``/rollout.json``
    and ``/status.json``)."""
    return {
        "id": plan.id,
        "stage": plan.stage,
        "engineId": plan.engine_id,
        "engineVersion": plan.engine_version,
        "engineVariant": plan.engine_variant,
        "baselineInstanceId": plan.baseline_instance_id,
        "candidateInstanceId": plan.candidate_instance_id,
        "percent": plan.percent,
        "salt": plan.salt,
        "createdTime": str(plan.created_time),
        "updatedTime": str(plan.updated_time),
        "gates": dict(plan.gates),
        "history": list(plan.history),
    }


def plan_epoch(plan: Any) -> str:
    """A deterministic token over everything in a ``RolloutPlan`` that
    can change what a query is answered with: plan identity, stage,
    split (percent and salt), both instance ids, and ``updated_time`` so
    that any durable plan write moves it. ``None`` (no active plan) is
    its own epoch, ``"-"``. A response cache stamps an entry with the
    epoch it was filled under and drops it when the epoch moves."""
    if plan is None:
        return "-"
    return "|".join(
        str(getattr(plan, field, ""))
        for field in (
            "id",
            "stage",
            "percent",
            "salt",
            "baseline_instance_id",
            "candidate_instance_id",
            "updated_time",
        )
    )


def sticky_key(payload: Any) -> str:
    """The identity a query is split on: the first conventional entity
    field present (``user``, ``entityId``, ...), else the whole payload
    canonicalized — every query still gets a *deterministic* assignment,
    just without cross-query stickiness for exotic shapes."""
    if isinstance(payload, dict):
        for field in _ENTITY_KEY_FIELDS:
            value = payload.get(field)
            if isinstance(value, (str, int, float, bool)):
                return f"{field}={value}"
    try:
        return json.dumps(payload, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return str(payload)


def bucket_for_key(salt: str, key: str) -> int:
    """SHA-256 over ``salt|key`` into one of :data:`NUM_BUCKETS`
    buckets. A pure function of its two strings, so every process
    computes the same bucket with no coordination. Golden vectors in the
    tests pin exact outputs: changing this function would move every
    sticky assignment."""
    digest = hashlib.sha256(f"{salt}|{key}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % _BUCKETS


def variant_for_key(salt: str, key: str, percent: float) -> str:
    """Deterministic sticky assignment: candidate iff the key's hash
    bucket (of 10,000) falls under ``percent``. The salt is minted once
    per plan, so consecutive rollouts sample *different* user subsets —
    the same 10% must not eat every canary's risk forever."""
    if percent <= 0:
        return BASELINE
    if percent >= 100:
        return CANDIDATE
    bucket = bucket_for_key(salt, key)
    return CANDIDATE if bucket < round(percent * (_BUCKETS / 100.0)) else BASELINE


def _leaves(obj: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """Flatten an encoded (JSON-shaped) prediction into (path, scalar)
    pairs; list positions are part of the path, so rank changes in a
    recommendation list surface as mismatches."""
    if isinstance(obj, dict):
        for key in sorted(obj):
            yield from _leaves(obj[key], path + (key,))
    elif isinstance(obj, (list, tuple)):
        for idx, item in enumerate(obj):
            yield from _leaves(item, path + (idx,))
    else:
        yield path, obj


def prediction_divergence(baseline: Any, candidate: Any) -> float:
    """Structural distance in [0, 1] between two *encoded* predictions.

    Per aligned leaf: numeric pairs contribute their relative distance
    ``|a-b| / (|a|+|b|)``; non-numeric pairs contribute 0 or 1 on
    equality; a leaf present on one side only contributes 1. The mean
    over the union of paths is the divergence. A heuristic, not a
    metric-space guarantee — its job is a stable 0 for "identical
    answer", a stable large value for "different model family", and
    monotone-ish behavior in between for the shadow gate to threshold.
    """
    la = dict(_leaves(baseline))
    lb = dict(_leaves(candidate))
    paths = set(la) | set(lb)
    if not paths:
        return 0.0
    total = 0.0
    for path in paths:
        if path not in la or path not in lb:
            total += 1.0
            continue
        va, vb = la[path], lb[path]
        num_a = isinstance(va, (int, float)) and not isinstance(va, bool)
        num_b = isinstance(vb, (int, float)) and not isinstance(vb, bool)
        if num_a and num_b:
            if va != vb:
                total += abs(va - vb) / (abs(va) + abs(vb))
        elif va != vb:
            total += 1.0
    return total / len(paths)
