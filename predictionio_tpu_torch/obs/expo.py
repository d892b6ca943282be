"""Prometheus text exposition (v0.0.4) — the ``GET /metrics`` body.

Trimmed copy of ``predictionio_tpu/obs/expo.py`` (rendering only; the
parser behind ``pio top`` waits): label values escape ``\\``, ``"`` and
newline, histogram buckets are cumulative and end with ``le="+Inf"``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from .metrics import Histogram, MetricsRegistry

__all__ = ["CONTENT_TYPE", "render"]

#: ``respond()`` appends "; charset=UTF-8" itself
CONTENT_TYPE = "text/plain; version=0.0.4"


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def render(registry: MetricsRegistry) -> str:
    """The full ``GET /metrics`` body, trailing newline included."""
    lines: List[str] = []
    for inst in registry.collect():
        lines.append(f"# HELP {inst.name} {inst.help}")
        lines.append(f"# TYPE {inst.name} {inst.kind}")
        if isinstance(inst, Histogram):
            for key, _child in inst.series():
                snap = inst.snapshot(**dict(zip(inst.labelnames, key)))
                for bound, cum in snap["buckets"]:
                    le = "+Inf" if math.isinf(bound) else _fmt_value(bound)
                    blabels = _fmt_labels(inst.labelnames + ("le",), key + (le,))
                    lines.append(f"{inst.name}_bucket{blabels} {cum}")
                base = _fmt_labels(inst.labelnames, key)
                lines.append(f"{inst.name}_sum{base} {_fmt_value(snap['sum'])}")
                lines.append(f"{inst.name}_count{base} {snap['count']}")
        else:
            for key, child in inst.series():
                base = _fmt_labels(inst.labelnames, key)
                lines.append(f"{inst.name}{base} {_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"
