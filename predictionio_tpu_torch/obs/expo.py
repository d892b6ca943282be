"""Prometheus text exposition (v0.0.4) — the ``GET /metrics`` body.

Trimmed copy of ``predictionio_tpu/obs/expo.py``: :func:`render` (label
values escape ``\\``, ``"`` and newline, histogram buckets are cumulative
and end with ``le="+Inf"``) and :func:`parse_text`, the scrapers' reader
(``pio quality --node``).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

from .metrics import Histogram, MetricsRegistry

__all__ = ["CONTENT_TYPE", "parse_text", "render"]

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


# -- parsing (the scrapers) -------------------------------------------------

#: the label body is quote-aware: a '}' INSIDE a quoted label value
#: (legal, unescaped per spec) must not terminate the group early
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[^"{}]|"(?:[^"\\]|\\.)*")*)\})?'
    r"\s+(?P<value>\S+)\s*$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(value: str) -> str:
    # single pass, not chained str.replace: 'a\\nb' (escaped backslash
    # before a literal n) must not have its '\\n' re-read as a newline
    return _UNESCAPE_RE.sub(
        lambda m: _UNESCAPES.get(m.group(1), m.group(0)), value
    )


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)


def parse_text(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Exposition text → ``{sample_name: [(labels, value), ...]}``.

    Histogram families appear under their sample names (``x_bucket``,
    ``x_sum``, ``x_count``) — the shape scraping code actually wants.
    Unparseable lines are skipped (a scraper must survive a newer peer).
    """
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        labels: Dict[str, str] = {}
        if m.group("labels"):
            for lm in _LABEL_PAIR_RE.finditer(m.group("labels")):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            continue
        out.setdefault(m.group("name"), []).append((labels, value))
    return out
