"""Quantization subsystem of the port (counterpart of
``predictionio_tpu/quant``): quantized factor tables (int8 codes +
per-row f32 scales, fp8 behind a capability probe), the dedup
``ragged_gather`` the serving top-k gathers user rows with, and the
exactness gate that licenses serving from codes — quantized top-k ids
must match the f32 top-k on a probe set, a mismatch is a loud counted
refusal."""

from .ragged import ragged_gather
from .table import (
    FP8_QMAX,
    INT8_QMAX,
    QuantGateError,
    QuantizedTable,
    default_probe_idx,
    dequantize_rows,
    estimate_quant_topk_hbm_bytes,
    estimate_table_bytes,
    fp8_supported,
    gate_counts,
    quantize_serving_table,
    quantize_table,
    resolve_quantized_serving,
    top_k_quantized,
    topk_match_gate,
)

__all__ = [
    "FP8_QMAX",
    "INT8_QMAX",
    "QuantGateError",
    "QuantizedTable",
    "default_probe_idx",
    "dequantize_rows",
    "estimate_quant_topk_hbm_bytes",
    "estimate_table_bytes",
    "fp8_supported",
    "gate_counts",
    "quantize_serving_table",
    "quantize_table",
    "ragged_gather",
    "resolve_quantized_serving",
    "top_k_quantized",
    "topk_match_gate",
]
