"""Mergeable streaming quantile sketches and the population stability index.

Copy of ``predictionio_tpu/obs/sketch.py``, the data model of the quality
plane:

- :class:`QuantileSketch` — a DDSketch-shaped store: geometric buckets
  (``gamma = (1 + rel_err) / (1 - rel_err)``) over positive and negative
  magnitudes plus a zero bucket. ``quantile(q)`` is within ``rel_err``
  relative error of the exact sample quantile for every value whose
  magnitude exceeds ``min_magnitude``; ``merge`` is bucket-wise addition,
  associative and lossless.
- :func:`psi` — the population stability index between two sketches
  over coarsened bins (identical distributions read ~0, a real shift
  large); an empty bucket on one side is floored at ``epsilon``.
- :func:`categorical_psi` — the same index over two categorical count
  maps (the event-type mix at ingest).

Stdlib only, no clocks: windowing lives in :mod:`.quality`, where the
clock is injected.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

__all__ = [
    "DEFAULT_MAX_BUCKETS",
    "DEFAULT_MIN_MAGNITUDE",
    "DEFAULT_REL_ERR",
    "PSI_COARSEN",
    "QuantileSketch",
    "categorical_psi",
    "psi",
]

#: default relative accuracy of ``quantile()`` — 2% keeps ~512 buckets
#: good for ~8 decades of dynamic range per sign
DEFAULT_REL_ERR = 0.02

#: magnitudes at or below this collapse into the zero bucket (a relative
#: bound is meaningless at 1e-300, and the index would overflow anyway)
DEFAULT_MIN_MAGNITUDE = 1e-9

#: hard cap on stored buckets per sign; past it the lowest-magnitude
#: buckets collapse downward (the tail the quantiles care about is the
#: HIGH-magnitude end, so accuracy degrades only near zero)
DEFAULT_MAX_BUCKETS = 512

#: saturation value for the running sum: clamped extremes can still
#: overflow float addition, and an inf sum would both poison mean()
#: and serialize as a non-RFC "Infinity" token in the snapshot JSONL
_MAX_FLOAT = 1.7976931348623157e308

#: probability floor for PSI terms: a bucket empty on one side must
#: contribute a finite term, not an infinite log-ratio
PSI_EPSILON = 1e-4

#: sketch buckets per PSI bin. PSI over the raw 2%-relative buckets is
#: inflated by sampling noise: with a few hundred samples spread over
#: ~50 occupied buckets, the epsilon floor turns every
#: present-on-one-side-only bucket into a spurious term (a 120-sample
#: same-distribution resample reads ~0.6 — past the 0.25 "real change"
#: bar with zero actual drift). Grouping ``coarsen`` adjacent buckets
#: per bin (gamma^16 ≈ 1.9× per bin: roughly binary-magnitude bins, the
#: conventional 10–20 PSI bins over a typical score range) drops that
#: same resample to ~0.05 while a genuine 1.5× scale shift still reads
#: >0.4 — the separation the gate needs at its sample floor.
PSI_COARSEN = 16


class QuantileSketch:
    """Log-bucketed streaming quantile sketch (DDSketch-style).

    Values land in geometric buckets: positive ``v`` goes to bucket
    ``ceil(log_gamma(v))``, negative values mirror into a separate
    store, and ``|v| <= min_magnitude`` counts in the zero bucket.
    Memory is bounded by ``max_buckets`` per sign; ``count``/``sum``/
    ``min``/``max`` ride along exactly.
    """

    __slots__ = (
        "rel_err",
        "min_magnitude",
        "max_buckets",
        "_log_gamma",
        "_top_index",
        "_top_value",
        "_pos",
        "_neg",
        "_zero",
        "count",
        "sum",
        "min",
        "max",
    )

    def __init__(
        self,
        rel_err: float = DEFAULT_REL_ERR,
        min_magnitude: float = DEFAULT_MIN_MAGNITUDE,
        max_buckets: int = DEFAULT_MAX_BUCKETS,
    ):
        if not (0.0 < rel_err < 1.0):
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err!r}")
        if min_magnitude <= 0.0:
            raise ValueError("min_magnitude must be positive")
        if max_buckets < 8:
            raise ValueError("max_buckets must be at least 8")
        self.rel_err = rel_err
        self.min_magnitude = min_magnitude
        self.max_buckets = max_buckets
        gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(gamma)
        #: largest index any value may land in: the bucket of
        #: max-float/2. max-float's own bucket rounds UP past it, and
        #: _bucket_value of that index overflows on read — so both
        #: infinities and near-max finite magnitudes clamp here
        self._top_index = self._index(8.988465674311579e307)
        #: intake magnitude cap: the top bucket's representative value —
        #: precomputed, add() is the serving hot path
        self._top_value = self._bucket_value(self._top_index)
        self._pos: Dict[int, int] = {}
        self._neg: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- intake -----------------------------------------------------------
    def _index(self, magnitude: float) -> int:
        return math.ceil(math.log(magnitude) / self._log_gamma)

    def _bucket_value(self, index: int) -> float:
        """Representative value of bucket ``index``: the geometric
        midpoint of ``(gamma^(i-1), gamma^i]``, which is what bounds the
        relative error at ``rel_err``. The exponent is capped so an
        out-of-range index from a hand-edited snapshot reads as a huge
        finite value instead of raising OverflowError."""
        gamma = math.exp(self._log_gamma)
        exp_arg = min(self._log_gamma * index, 709.0)
        return (2.0 * math.exp(exp_arg)) / (gamma + 1.0)

    def add(self, value: float, count: int = 1) -> None:
        value = float(value)
        if math.isnan(value) or count <= 0:
            return  # a NaN score is a data bug, not a distribution sample
        if math.isinf(value) or abs(value) > self._top_value:
            # an overflowing score (inf OR near-max finite) must rank as
            # the extreme of the distribution, never as its minimum —
            # and sum/min/max take the clamped stand-in too, or one such
            # score poisons mean() forever and json.dumps writes a
            # non-RFC "Infinity" token into the durable snapshot line
            value = math.copysign(self._top_value, value)
        self.count += count
        self.sum += value * count
        if math.isinf(self.sum):
            # a few clamped extremes can still overflow the running sum
            self.sum = math.copysign(_MAX_FLOAT, self.sum)
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        magnitude = abs(value)
        if magnitude <= self.min_magnitude:
            self._zero += count
            return
        store = self._pos if value > 0 else self._neg
        idx = min(self._index(magnitude), self._top_index)
        store[idx] = store.get(idx, 0) + count
        if len(store) > self.max_buckets:
            self._collapse(store)

    @staticmethod
    def _collapse(store: Dict[int, int]) -> None:
        """Fold the lowest-index (smallest-magnitude) bucket into its
        neighbor — bounded memory at the cost of accuracy near zero,
        never at the tail."""
        low = sorted(store)
        first, second = low[0], low[1]
        store[second] = store.get(second, 0) + store.pop(first)

    def extend(self, values: Iterable[float]) -> None:
        for value in values:
            self.add(value)

    # -- queries ----------------------------------------------------------
    def quantile(self, q: float) -> float:
        """The ``q`` (0..1) quantile, within ``rel_err`` relative error
        for values with ``|v| > min_magnitude``. 0.0 when empty."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q!r}")
        if self.count <= 0:
            return 0.0
        rank = q * (self.count - 1)
        # walk: most-negative first (negative store, descending index),
        # then zero, then positive ascending
        seen = 0
        for idx in sorted(self._neg, reverse=True):
            seen += self._neg[idx]
            if seen > rank:
                return -self._bucket_value(idx)
        seen += self._zero
        if seen > rank:
            return 0.0
        for idx in sorted(self._pos):
            seen += self._pos[idx]
            if seen > rank:
                return self._bucket_value(idx)
        return self.max if self.count else 0.0

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # -- merge / serialization --------------------------------------------
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Bucket-wise add ``other`` into ``self`` (in place; returns
        self). Requires identical accuracy parameters — merging sketches
        with different gammas would silently mis-bin every count."""
        if (
            other.rel_err != self.rel_err
            or other.min_magnitude != self.min_magnitude
        ):
            raise ValueError(
                "cannot merge sketches with different accuracy parameters "
                f"(rel_err {self.rel_err} vs {other.rel_err})"
            )
        for idx, n in other._pos.items():
            self._pos[idx] = self._pos.get(idx, 0) + n
        for idx, n in other._neg.items():
            self._neg[idx] = self._neg.get(idx, 0) + n
        while len(self._pos) > self.max_buckets:
            self._collapse(self._pos)
        while len(self._neg) > self.max_buckets:
            self._collapse(self._neg)
        self._zero += other._zero
        self.count += other.count
        self.sum += other.sum
        if math.isinf(self.sum):
            self.sum = math.copysign(_MAX_FLOAT, self.sum)
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.rel_err, self.min_magnitude, self.max_buckets)
        out.merge(self)
        return out

    def to_dict(self) -> dict:
        """JSON-shaped snapshot (string bucket keys: JSON object keys)."""
        out: dict = {
            "relErr": self.rel_err,
            "minMagnitude": self.min_magnitude,
            "count": self.count,
            "sum": self.sum,
            "zero": self._zero,
            "pos": {str(k): v for k, v in self._pos.items()},
            "neg": {str(k): v for k, v in self._neg.items()},
        }
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        return out

    @classmethod
    def from_dict(cls, data: Mapping) -> "QuantileSketch":
        """Inverse of :meth:`to_dict`; unparseable bucket entries are
        skipped (a hand-edited snapshot line must not crash a report)."""
        out = cls(
            rel_err=float(data.get("relErr", DEFAULT_REL_ERR)),
            min_magnitude=float(
                data.get("minMagnitude", DEFAULT_MIN_MAGNITUDE)
            ),
        )
        for attr, key in (("_pos", "pos"), ("_neg", "neg")):
            store = getattr(out, attr)
            for raw_idx, n in (data.get(key) or {}).items():
                try:
                    store[int(raw_idx)] = int(n)
                except (TypeError, ValueError):
                    continue
        out._zero = int(data.get("zero", 0) or 0)
        out.count = int(data.get("count", 0) or 0)
        out.sum = float(data.get("sum", 0.0) or 0.0)
        out.min = float(data.get("min", math.inf))
        out.max = float(data.get("max", -math.inf))
        return out

    def _distribution(
        self, coarsen: int = 1
    ) -> Dict[Tuple[str, int], float]:
        """PSI-bin key → probability: ``coarsen`` adjacent sketch buckets
        fold into one bin (floor division keeps the mapping consistent
        for negative indices)."""
        if self.count <= 0:
            return {}
        total = float(self.count)
        out: Dict[Tuple[str, int], float] = {}
        for sign, store in (("p", self._pos), ("n", self._neg)):
            for idx, n in store.items():
                key = (sign, idx // coarsen)
                out[key] = out.get(key, 0.0) + n / total
        if self._zero:
            out[("z", 0)] = self._zero / total
        return out


def _psi_terms(
    reference: Mapping, current: Mapping, epsilon: float
) -> float:
    total = 0.0
    for key in set(reference) | set(current):
        p = max(float(reference.get(key, 0.0)), epsilon)
        q = max(float(current.get(key, 0.0)), epsilon)
        total += (p - q) * math.log(p / q)
    return total


def psi(
    reference: QuantileSketch,
    current: QuantileSketch,
    epsilon: float = PSI_EPSILON,
    coarsen: int = PSI_COARSEN,
) -> Optional[float]:
    """Population stability index between two sketches' distributions,
    computed over ``coarsen``-bucket PSI bins (see :data:`PSI_COARSEN` —
    the raw 2%-relative buckets are too fine for small samples). ~0 for
    identical distributions; conventional thresholds read <0.1 as
    stable, 0.1–0.25 as moderate shift, >0.25 as a real distribution
    change. None when either side is empty — "no data" is an
    abstention, not zero drift."""
    if reference.count <= 0 or current.count <= 0:
        return None
    if (
        reference.rel_err != current.rel_err
        or reference.min_magnitude != current.min_magnitude
    ):
        raise ValueError(
            "PSI requires sketches with identical accuracy parameters"
        )
    if coarsen < 1:
        raise ValueError(f"coarsen must be >= 1, got {coarsen!r}")
    return _psi_terms(
        reference._distribution(coarsen),
        current._distribution(coarsen),
        epsilon,
    )


def categorical_psi(
    reference: Mapping[str, float],
    current: Mapping[str, float],
    epsilon: float = PSI_EPSILON,
) -> Optional[float]:
    """PSI over two categorical count maps (e.g. event-name → count):
    the *mix* drift signal. Counts are normalized here; None when either
    side has no mass."""
    ref_total = float(sum(reference.values())) if reference else 0.0
    cur_total = float(sum(current.values())) if current else 0.0
    if ref_total <= 0 or cur_total <= 0:
        return None
    return _psi_terms(
        {k: v / ref_total for k, v in reference.items() if v > 0},
        {k: v / cur_total for k, v in current.items() if v > 0},
        epsilon,
    )
