"""Quantized factor tables: int8 (or fp8) rows + per-row f32 scales,
served only through the exactness gate.

Counterpart of ``predictionio_tpu/quant/table.py``. A rank-R f32 factor
row costs 4R bytes; its int8 twin costs R code bytes plus one f32 scale
(3.7x smaller at rank 50). Symmetric absmax quantization per row:

    scale_i = max_j |row_ij| / 127        codes_ij = round(row_ij / scale_i)
    dequant_ij = codes_ij * scale_i

The codes and scales are computed on the host in numpy exactly as the
JAX package computes them (``np.rint``; a zero row gets scale 0.0), so
the int8 codes are bit-identical to the JAX package's, then moved to the
table's device as torch tensors. fp8 codes are ``torch.float8_e4m3fn``
(the grid puts a row's absmax on 448); the numpy of this container has
no fp8 dtype, so a :class:`QuantizedTable` holds torch tensors where the
JAX package's holds numpy arrays.

Scoring (:func:`top_k_quantized`) is plain PyTorch, as the JAX package's
is plain XLA outside any Pallas kernel: ``(q @ codes.float().T) *
scales`` in f32 (TF32 stays off), then a stable descending sort with the
(-inf, -1) sentinels. No TPU kernel stands behind it, so no CUDA kernel
of the port does either; ``/status.json`` names the path ``quant``.

Serving from codes is allowed only through :func:`quantize_serving_table`:
the quantized top-k id sets must match the f32 top-k's — the f32 leg is
:func:`..ops.scoring.top_k_for_users_fused`, the streaming top-k kernel
on a CUDA device — on a probe set of users, and a mismatch is a loud,
counted refusal (:class:`QuantGateError`), never a silent quality slide.
``fp8`` tables need :func:`fp8_supported`; elsewhere they fall back to
int8 loudly, with a ``fallback`` marker on the table.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .ragged import ragged_gather

#: symmetric int8 grid: codes live in [-127, 127] (-128 unused so the
#: grid negates onto itself and |dequant| <= row absmax exactly)
INT8_QMAX = 127.0

#: fp8 e4m3 finite max — the fp8 grid normalizes row absmax onto it
FP8_QMAX = 448.0

NEG_INF = float("-inf")


class QuantGateError(ValueError):
    """The exactness gate refused a quantized serving table."""


def resolve_quantized_serving(
    explicit: Optional[bool], env: Optional[str] = None
) -> bool:
    """The ``quantized_serving`` tri-state: an explicit True/False wins,
    ``None`` resolves from ``PIO_SERVE_QUANT`` ("1"/"0"), else off. Any
    other env value fails loudly: a silently ignored flag would corrupt
    an A/B."""
    if explicit is not None:
        return bool(explicit)
    if env is None:
        env = os.environ.get("PIO_SERVE_QUANT")
    if env is None or env == "":
        return False
    if env not in ("0", "1"):
        raise ValueError(
            f"PIO_SERVE_QUANT must be '0' or '1', got {env!r}"
        )
    return env == "1"


# gate outcomes, process-wide: the query server exports them as
# pio_quant_gate_{runs,refusals}_total and /status.json echoes them
_GATE_LOCK = threading.Lock()
_GATE_COUNTS = {"runs": 0, "refusals": 0}


def gate_counts() -> dict:
    """Snapshot of exactness-gate outcomes for this process."""
    with _GATE_LOCK:
        return dict(_GATE_COUNTS)


def _gate_tally(key: str) -> None:
    with _GATE_LOCK:
        _GATE_COUNTS[key] += 1


@dataclasses.dataclass(frozen=True)
class QuantizedTable:
    """A factor table quantized for serving: codes + per-row scales, on
    one device (the JAX package's holds numpy arrays; see the module
    docstring)."""

    codes: torch.Tensor  # [N, R] int8 or float8_e4m3fn
    scales: torch.Tensor  # [N] f32 per-row scales; dequant = codes * scale
    dtype: str = "int8"  # "int8" | "fp8"
    #: set when a requested dtype fell back, e.g. "fp8->int8: no fp8
    #: matmul on cpu" — surfaced at /status.json, never silent
    fallback: Optional[str] = None

    @property
    def n_rows(self) -> int:
        return int(self.codes.shape[0])

    @property
    def rank(self) -> int:
        return int(self.codes.shape[1])

    @property
    def table_bytes(self) -> int:
        """Actual serving footprint: codes + scales."""
        return int(self.codes.numel() * self.codes.element_size()
                   + self.scales.numel() * self.scales.element_size())

    @property
    def f32_bytes(self) -> int:
        """The f32 twin's footprint (the compression baseline)."""
        return int(self.n_rows * self.rank * 4)

    @property
    def compression_ratio(self) -> float:
        return self.f32_bytes / max(self.table_bytes, 1)

    def status(self) -> dict:
        """The /status.json shape: dtype, bytes, compression."""
        out = {
            "dtype": self.dtype,
            "tableBytes": self.table_bytes,
            "f32Bytes": self.f32_bytes,
            "compression": round(self.compression_ratio, 2),
        }
        if self.fallback:
            out["fallback"] = self.fallback
        return out


def fp8_supported(device: DeviceLike = None) -> bool:
    """Whether fp8 serving tables are taken on ``device``: a CUDA device
    of compute capability 8.9 or above (Ada, Hopper), where
    ``torch.float8_e4m3fn`` is a native type. Elsewhere fp8 falls back to
    int8, loudly (:func:`quantize_table`)."""
    device = resolve_device(device)
    if device.type != "cuda" or not hasattr(torch, "float8_e4m3fn"):
        return False
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_capability(index) >= (8, 9)


def _normalized_rows(
    table: np.ndarray, qmax: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Rows scaled onto the [-qmax, qmax] grid + the per-row scales.

    Zero rows get scale 0.0 (their codes are 0; dequant reproduces the
    zero row exactly instead of dividing by zero)."""
    absmax = np.abs(table).max(axis=1)
    scales = (absmax / qmax).astype(np.float32)
    safe = np.where(scales > 0.0, scales, 1.0).astype(np.float32)
    return table / safe[:, None], scales


def _int8_codes(normalized: np.ndarray) -> np.ndarray:
    """The int8 codes of normalized rows, as the JAX package rounds them."""
    return np.rint(np.clip(normalized, -INT8_QMAX, INT8_QMAX)).astype(np.int8)


def _fp8_codes(normalized: np.ndarray) -> torch.Tensor:
    """The fp8 e4m3 codes of normalized rows (on the host; round to
    nearest even, as ``astype(jnp.float8_e4m3fn)`` rounds)."""
    return torch.from_numpy(np.ascontiguousarray(normalized, dtype=np.float32)).to(
        torch.float8_e4m3fn)


def _as_host_table(table) -> np.ndarray:
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    return np.asarray(table, dtype=np.float32)


def _on_device(table, device: torch.device) -> torch.Tensor:
    """An f32 table (numpy or torch) on ``device`` (numpy is copied)."""
    if isinstance(table, torch.Tensor):
        return table.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(table, dtype=np.float32), device=device)


def _device_of(table, device: DeviceLike) -> torch.device:
    if device is None and isinstance(table, torch.Tensor):
        return table.device
    return resolve_device(device)


def quantize_table(table, dtype: str = "int8", device: DeviceLike = None) -> QuantizedTable:
    """Quantize an f32 factor table (symmetric absmax, per-row scales)
    onto ``device`` (a tensor's own device when ``table`` is one, else
    ``cuda:0`` unless a caller passes another).

    The ungated constructor; the serve path goes through
    :func:`quantize_serving_table`, which is this plus the exactness
    gate. ``dtype="fp8"`` needs :func:`fp8_supported`; elsewhere it falls
    back to int8 with a warning and a ``fallback`` marker on the table
    (the JAX package's designed behaviour off an accelerator)."""
    if dtype not in ("int8", "fp8"):
        raise ValueError(
            f"quantize_table dtype must be 'int8' or 'fp8', got {dtype!r}"
        )
    device = _device_of(table, device)
    fallback = None
    if dtype == "fp8" and not fp8_supported(device):
        fallback = (
            f"fp8->int8: no fp8 matmul on {device.type} "
            "(docs/quantization.md#fp8)"
        )
        warnings.warn(fallback, stacklevel=2)
        dtype = "int8"
    table = _as_host_table(table)
    if table.ndim != 2:
        raise ValueError(f"factor table must be 2-D, got shape {table.shape}")
    if dtype == "int8":
        normalized, scales = _normalized_rows(table, INT8_QMAX)
        codes = torch.from_numpy(_int8_codes(normalized))
    else:
        normalized, scales = _normalized_rows(table, FP8_QMAX)
        codes = _fp8_codes(normalized)
    return QuantizedTable(
        codes=codes.to(device), scales=torch.from_numpy(scales).to(device),
        dtype=dtype, fallback=fallback,
    )


def dequantize_rows(qtable: QuantizedTable, ids) -> torch.Tensor:
    """f32 rows for ``ids`` (any integer shape), each unique row
    dequantized once (``codes * scale``, exact), on the table's device:
    bit-identical to dequantizing the whole table and indexing it."""
    idx = torch.as_tensor(ids, device=qtable.codes.device).long()
    rank = qtable.rank
    flat = idx.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(tuple(idx.shape) + (rank,), dtype=torch.float32,
                           device=qtable.codes.device)
    uniq, inverse = torch.unique(flat, return_inverse=True)
    rows = qtable.codes[uniq].float() * qtable.scales[uniq][:, None]
    return rows[inverse].reshape(tuple(idx.shape) + (rank,))


def estimate_table_bytes(n_rows: int, rank: int, dtype: str = "f32") -> float:
    """Serving footprint of one factor table: f32 4 bytes an element;
    int8/fp8 1 byte an element plus one f32 scale a row. Equal to
    :attr:`QuantizedTable.table_bytes` (pinned in tests)."""
    if dtype == "f32":
        return float(n_rows) * rank * 4.0
    if dtype in ("int8", "fp8"):
        return float(n_rows) * (rank * 1.0 + 4.0)
    raise ValueError(f"unknown table dtype {dtype!r}")


def estimate_quant_topk_hbm_bytes(
    b: int, n_items: int, rank: int, k: int, dtype: str = "int8"
) -> float:
    """Device-memory traffic of one quantized top-k call (the plain path:
    the ``[B, N]`` score matrix is written and read back), with the item
    table read at the quantized width."""
    queries = float(b) * rank * 4.0
    items = estimate_table_bytes(n_items, rank, dtype)
    results = float(b) * k * 8.0
    score_matrix = float(b) * n_items * 4.0
    return queries + items + 2.0 * score_matrix + results


def _topk_quant(q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, k: int):
    """Scores from upcast codes times the row scales, then the k best
    with the lowest index first on ties; -inf slots carry -1 and k is
    padded past the catalog, as in ``ops.scoring``."""
    scores = (q @ codes.float().T) * scales[None, :]
    n_items = codes.shape[0]
    k_eff = min(k, n_items)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    s = s[:, :k_eff].contiguous()
    i = torch.where(torch.isneginf(s), -1, i[:, :k_eff].to(torch.int32))
    if k_eff < k:
        pad = k - k_eff
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    return s, i


def top_k_quantized(user_factors, qtable: QuantizedTable, user_idx, k: int):
    """Top-k items scored from the codes: ``scores = (q @ codes^T) *
    scale`` (per-row scales factor out of the dot product), on the
    table's device. The user-row gather rides :func:`ragged_gather`.
    Same (scores [B, k], ids [B, k]) contract and (-inf, -1) sentinels as
    ``ops.scoring.top_k_for_users_fused``. Plain PyTorch (module
    docstring): no kernel launch is counted."""
    device = qtable.codes.device
    idx = torch.as_tensor(user_idx, device=device).long()
    q = ragged_gather(_on_device(user_factors, device), idx)
    return _topk_quant(q, qtable.codes, qtable.scales, int(k))


def default_probe_idx(n_rows: int, probes: int = 64) -> np.ndarray:
    """The probe set: evenly spaced user rows, deterministic (the gate
    must refuse reproducibly, not probabilistically)."""
    if n_rows <= 0:
        return np.zeros(0, dtype=np.int32)
    return np.unique(
        np.linspace(0, n_rows - 1, num=min(int(probes), n_rows))
        .round()
        .astype(np.int32)
    )


def topk_match_gate(
    user_factors, item_factors, qtable: QuantizedTable, probe_idx, k: int
) -> float:
    """Fraction of probe rows whose quantized top-k id SET equals the f32
    top-k id set (near-ties may reorder inside the set; membership is the
    serving contract). The f32 leg is ``top_k_for_users_fused`` on the
    table's device — on a CUDA device one launch of the streaming top-k
    kernel; both legs run on the table's device."""
    from ..ops.scoring import top_k_for_users_fused

    idx = np.asarray(probe_idx, dtype=np.int32)
    if idx.size == 0:
        return 1.0
    device = qtable.codes.device
    uf = _on_device(user_factors, device).contiguous()
    itf = _on_device(item_factors, device).contiguous()
    k = int(min(k, itf.shape[0]))
    idx_t = torch.from_numpy(idx).to(device)
    _, ref_ids = top_k_for_users_fused(uf, itf, idx_t, k=k, mode="auto")
    _, quant_ids = top_k_quantized(uf, qtable, idx_t, k=k)
    ref = np.sort(ref_ids.cpu().numpy(), axis=1)
    got = np.sort(quant_ids.cpu().numpy(), axis=1)
    return float(np.mean(np.all(ref == got, axis=1)))


def quantize_serving_table(
    item_factors,
    user_factors,
    *,
    dtype: str = "int8",
    probe_idx=None,
    k: int = 10,
    min_match: float = 1.0,
    device: DeviceLike = None,
) -> Tuple[QuantizedTable, dict]:
    """Quantize an item table FOR SERVING: quantize + exactness gate, on
    ``device`` (the item table's own when it is a tensor, else ``cuda:0``
    unless a caller passes another).

    The only constructor the serve path uses. Runs at model attach
    (train, fold-in, first serve of a loaded model) and proves the
    quantized top-k ids match the f32 top-k's on the probe set before any
    quantized answer is produced. Returns ``(table, gate_status)``;
    raises :class:`QuantGateError` on refusal, loud and counted
    (``pio_quant_gate_refusals_total``)."""
    device = _device_of(item_factors, device)
    item_factors = _as_host_table(item_factors)
    if dtype == "int8":
        # the narrowing cast and the gate that licenses it share one scope
        normalized, scales = _normalized_rows(item_factors, INT8_QMAX)
        qtable = QuantizedTable(
            codes=torch.from_numpy(_int8_codes(normalized)).to(device),
            scales=torch.from_numpy(scales).to(device), dtype="int8",
        )
    else:
        qtable = quantize_table(item_factors, dtype=dtype, device=device)
    if probe_idx is None:
        probe_idx = default_probe_idx(int(user_factors.shape[0]))
    probe_idx = np.asarray(probe_idx, dtype=np.int32)
    _gate_tally("runs")
    match_rate = topk_match_gate(
        user_factors, item_factors, qtable, probe_idx, k
    )
    gate_status = dict(qtable.status())
    gate_status.update(
        matchRate=round(match_rate, 4),
        probes=int(probe_idx.size),
        k=int(min(k, item_factors.shape[0])),
    )
    if match_rate < min_match:
        _gate_tally("refusals")
        raise QuantGateError(
            f"quantized serving REFUSED: top-k match rate "
            f"{match_rate:.4f} < required {min_match} (dtype="
            f"{qtable.dtype}, k={gate_status['k']}, probes="
            f"{gate_status['probes']}) — the model serves f32 or not at "
            "all; see docs/quantization.md#gate"
        )
    return qtable, gate_status
