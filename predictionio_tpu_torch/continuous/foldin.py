"""ALS fold-in: incremental factor updates for new and changed rows.

Counterpart of ``predictionio_tpu/continuous/foldin.py``. Instead of a
full alternating iteration over every row, solve **only the rows a fresh
delta touched**, each an independent regularized least-squares system
against the *fixed* counterpart table — the explicit normal equations of
the full trainer:

    A_u = Gᵀ G + λ n_u I,   b_u = Gᵀ r_u,   x_u = A_u⁻¹ b_u

Rows nobody touched keep their factors **bit-identical**. New users and
items get appended rows (:func:`seeded_rows`), and ``fold_iterations``
restricted alternations resolve the new-user-rated-new-item coupling.
:class:`FoldInPolicy` says when the approximation is no longer
trustworthy, and :func:`decide_mode` escalates to a full retrain.

:func:`solve_rows` builds the systems with the port's explicit-ALS build
— on a CUDA device the hand-written gather+Gramian kernel
(:func:`..ops.cuda_kernels.gramian_fused`: ``w2 = mask``, ``rhs = val``,
``ridge = λ·n_u``, no ``YᵀY``) — and solves them with the batched SPD
solve kernel (:func:`..ops.cuda_kernels.spd_solve`); on the CPU their
plain versions run. The padding rows of a bucket are zero systems, which
the solve's ``d > 0`` guard turns into exact zeros (the JAX package
slices its padding rows off instead). The JAX package wraps
``solve_rows`` in its jit telemetry (``obs.profile``, ROADMAP.md queue 1
item 14); the port has no jit and no such wrap.

Host math plus batched solves, no storage access: the changefeed watcher
and the controller that drive it are not ported yet (ROADMAP.md, queue 1
item 9's second half).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.als import init_factors
from ..ops.cuda_kernels import _sm_count, gramian_fused, gramian_row_slices, spd_solve
from ..ops.scoring import pad_pow2

__all__ = [
    "FOLD_IN",
    "FULL_RETRAIN",
    "FoldInPolicy",
    "FoldInStats",
    "decide_mode",
    "extend_bimap_indexing",
    "fold_in_factors",
    "seeded_rows",
    "solve_rows",
]

#: mode verdicts of :func:`decide_mode`
FOLD_IN = "fold_in"
FULL_RETRAIN = "full_retrain"


@dataclasses.dataclass(frozen=True)
class FoldInPolicy:
    """When the incremental step is trustworthy. Every threshold
    escalates to :data:`FULL_RETRAIN` when crossed."""

    #: delta events / total training events above which the "hold
    #: everything else fixed" approximation is no longer local
    max_delta_fraction: float = 0.2
    #: (new users + new items) / (known users + known items) above which
    #: the fixed counterpart tables no longer span the data
    max_new_entity_fraction: float = 0.2
    #: post-fold full-data RMSE may exceed the pre-fold RMSE by at most
    #: this fraction (relative drift)
    max_rmse_drift: float = 0.1
    #: restricted alternations over the changed rows (2 resolves the
    #: new-user × new-item coupling; 1 is pure one-shot fold-in)
    fold_iterations: int = 2
    #: widest per-row system staged at once; rows with more ratings are
    #: solved on their most recent ``max_row_width`` entries
    max_row_width: int = 2048

    def __post_init__(self):
        if self.fold_iterations < 1:
            raise ValueError(
                f"fold_iterations must be >= 1, got {self.fold_iterations}"
            )


def decide_mode(
    policy: FoldInPolicy,
    *,
    total_events: int,
    delta_events: int,
    known_entities: int,
    new_entities: int,
    fold_in_available: bool = True,
) -> Tuple[str, str]:
    """One (mode, reason) decision for a pending delta."""
    if not fold_in_available:
        return FULL_RETRAIN, "engine has no fold_in entry point"
    if total_events <= 0 or known_entities <= 0:
        return FULL_RETRAIN, "no trained baseline data to fold into"
    delta_frac = delta_events / max(1, total_events)
    if delta_frac > policy.max_delta_fraction:
        return FULL_RETRAIN, (
            f"delta fraction {delta_frac:.3f} exceeds "
            f"{policy.max_delta_fraction:.3f} "
            f"({delta_events}/{total_events} events)"
        )
    new_frac = new_entities / max(1, known_entities)
    if new_frac > policy.max_new_entity_fraction:
        return FULL_RETRAIN, (
            f"new-entity fraction {new_frac:.3f} exceeds "
            f"{policy.max_new_entity_fraction:.3f} "
            f"({new_entities} new / {known_entities} known)"
        )
    return FOLD_IN, (
        f"delta {delta_events}/{total_events} events, "
        f"{new_entities} new entities: within fold-in policy"
    )


def solve_rows(
    counter: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    mask: torch.Tensor,
    lam: float,
    rank: int,
) -> torch.Tensor:
    """Batched per-row regularized least squares against fixed counterpart
    factors on ``counter``'s device: ``counter`` [N, R], ``idx`` (int32) /
    ``val`` / ``mask`` (f32) [B, K] → [B, R]. One build and one solve for
    each slice of rows that :func:`..ops.cuda_kernels.gramian_row_slices`
    cuts (one slice up to millions of rows at rank 50): a kernel launch
    each on a CUDA device. A row whose mask is all zero solves to 0."""
    if counter.shape[1] != rank:
        raise ValueError(f"counter table has rank {counter.shape[1]}, not {rank}")
    mask = mask.to(torch.float32)
    rhs = val.to(torch.float32) * mask
    ridge = float(lam) * mask.sum(dim=1)
    n, k = idx.shape
    sm_count = None
    if counter.device.type == "cuda":
        index = (counter.device.index if counter.device.index is not None
                 else torch.cuda.current_device())
        sm_count = _sm_count(index)
    out = torch.empty((n, rank), dtype=torch.float32, device=counter.device)
    for s0, s1 in gramian_row_slices(n, k, rank, sm_count):
        a, b = gramian_fused(counter, idx[s0:s1], mask[s0:s1], rhs[s0:s1], ridge[s0:s1])
        out[s0:s1] = spd_solve(a, b)
        del a, b
    return out


@dataclasses.dataclass
class FoldInStats:
    """What one fold did — the policy's and the operator's input."""

    folded_users: int
    folded_items: int
    new_users: int
    new_items: int
    rmse_before: float
    rmse_after: float

    @property
    def rmse_drift(self) -> float:
        """Relative full-data RMSE drift (positive = the fold made it worse)."""
        if self.rmse_before <= 0.0:
            return 0.0
        return (self.rmse_after - self.rmse_before) / self.rmse_before

    def to_json(self) -> dict:
        return {
            "foldedUsers": self.folded_users,
            "foldedItems": self.folded_items,
            "newUsers": self.new_users,
            "newItems": self.new_items,
            "rmseBefore": round(self.rmse_before, 6),
            "rmseAfter": round(self.rmse_after, 6),
            "rmseDrift": round(self.rmse_drift, 6),
        }


def _row_systems(
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    vals: np.ndarray,
    rows: np.ndarray,
    max_width: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Padded per-row systems for ``rows`` out of COO data keyed by
    ``row_ids``: (rows_kept, idx [B, K], val [B, K], mask [B, K]) with B
    and K padded to powers of two, or None when no requested row has a
    rating. The same arrays as the JAX package's, reached by sorting only
    the ratings of the requested rows (a stable sort keeps their arrival
    order) instead of the whole matrix."""
    rows = np.asarray(rows)
    if len(rows) == 0 or len(row_ids) == 0:
        return None
    size = int(max(int(row_ids.max()), int(rows.max()))) + 1
    wanted = np.zeros(size, dtype=bool)
    wanted[rows] = True
    picked = np.flatnonzero(wanted[row_ids])
    keys = row_ids[picked]
    if size <= 1 << 16:  # numpy's stable sort of 16-bit keys is a radix sort
        keys = keys.astype(np.uint16)
    order = picked[np.argsort(keys, kind="stable")]
    sorted_rows = row_ids[order]
    starts = np.searchsorted(sorted_rows, rows, side="left")
    ends = np.searchsorted(sorted_rows, rows, side="right")
    counts = ends - starts
    keep = counts > 0  # a row with no rating has a singular system: leave it
    rows, starts, ends = rows[keep], starts[keep], ends[keep]
    if len(rows) == 0:
        return None
    counts = np.minimum(ends - starts, max_width)
    width = int(min(pad_pow2(int(counts.max()), lo=8), max_width))
    b_pad = pad_pow2(len(rows))
    idx = np.zeros((b_pad, width), dtype=np.int32)
    val = np.zeros((b_pad, width), dtype=np.float32)
    mask = np.zeros((b_pad, width), dtype=np.float32)
    for r in range(len(rows)):
        # keep the NEWEST `count` ratings when a row overflows the width
        # (arrival order within a row: the tail of its slice is the most
        # recent feedback)
        sel = order[ends[r] - counts[r]: ends[r]]
        idx[r, : len(sel)] = col_ids[sel]
        val[r, : len(sel)] = vals[sel]
        mask[r, : len(sel)] = 1.0
    return rows, idx, val, mask


def _staged_systems(row_ids, col_ids, vals, rows, max_width, device):
    """:func:`_row_systems` moved to ``device``: (rows as an int64
    tensor, idx, val, mask, the number of real rows), or None."""
    systems = _row_systems(row_ids, col_ids, vals, rows, max_width)
    if systems is None:
        return None
    kept, idx, val, mask = systems
    return (torch.from_numpy(kept.astype(np.int64)).to(device),
            torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device),
            torch.from_numpy(mask).to(device), len(kept))


def fold_in_factors(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    changed_users: Sequence[int],
    changed_items: Sequence[int],
    lambda_: float,
    policy: FoldInPolicy = FoldInPolicy(),
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, int]]:
    """Fold changed rows into copies of the factor tables, on ``device``
    (``cuda:0`` unless a caller passes another).

    ``users``/``items``/``ratings`` are the FULL current training COO in
    the (already extended) index space of the tables: each changed row is
    re-solved against all of its ratings, but only the changed rows.
    Callers pass tables already extended with seeded rows for new
    entities. Each of the ``fold_iterations`` alternations solves the
    changed items, then the changed users: one bucket a side (one build
    and one solve, per :func:`solve_rows`), whose systems are staged on
    the device once.

    Returns ``(user_factors, item_factors, counts)`` — fresh numpy arrays
    whose untouched rows are byte-identical to the inputs."""
    device = resolve_device(device)
    rank = user_factors.shape[1]
    uf = np.array(user_factors, dtype=np.float32, copy=True)
    itf = np.array(item_factors, dtype=np.float32, copy=True)
    cu = np.asarray(sorted(set(int(u) for u in changed_users)), dtype=np.int32)
    ci = np.asarray(sorted(set(int(i) for i in changed_items)), dtype=np.int32)
    counts = {"solved_users": 0, "solved_items": 0}
    sys_i = _staged_systems(items, users, ratings, ci, policy.max_row_width, device) \
        if len(ci) else None
    sys_u = _staged_systems(users, items, ratings, cu, policy.max_row_width, device) \
        if len(cu) else None
    if sys_i is None and sys_u is None:
        return uf, itf, counts
    uf_t = torch.from_numpy(uf).to(device)
    itf_t = torch.from_numpy(itf).to(device)
    for _ in range(policy.fold_iterations):
        if sys_i is not None:
            rows, idx, val, mask, n = sys_i
            itf_t[rows] = solve_rows(uf_t, idx, val, mask, lambda_, rank)[:n]
            counts["solved_items"] = n
        if sys_u is not None:
            rows, idx, val, mask, n = sys_u
            uf_t[rows] = solve_rows(itf_t, idx, val, mask, lambda_, rank)[:n]
            counts["solved_users"] = n
    # only the solved rows come back: every other row keeps its bytes
    for table, table_t, systems in ((itf, itf_t, sys_i), (uf, uf_t, sys_u)):
        if systems is not None:
            rows = systems[0]
            table[rows.cpu().numpy()] = table_t[rows].cpu().numpy()
    return uf, itf, counts


def seeded_rows(n_new: int, rank: int, seed: int, offset: int) -> np.ndarray:
    """Initial factors for appended rows: the distribution of
    :func:`..ops.als.init_factors` (``|N(0,1)| / sqrt(rank)``), keyed off
    the row offset so re-folding after more growth never re-mints earlier
    rows' seeds. Drawn from a ``torch.Generator``, it cannot reproduce the
    JAX package's ``jax.random`` rows: a caller that must start alike
    passes those rows in (``ALSAlgorithm.fold_in(..., new_rows=...)``)."""
    if n_new <= 0:
        return np.zeros((0, rank), dtype=np.float32)
    return init_factors(n_new, rank, seed + offset, "cpu").numpy()


def extend_bimap_indexing(
    known: Dict[str, int], incoming_ids: Sequence[str]
) -> Tuple[Dict[str, int], int]:
    """Append unseen ids to a forward map in arrival order, preserving
    every existing index (the stable-index contract untouched factor rows
    rely on). Returns ``(combined_map, n_new)``."""
    combined = dict(known)
    n = len(combined)
    for key in incoming_ids:
        if key not in combined:
            combined[key] = n
            n += 1
    return combined, n - len(known)
