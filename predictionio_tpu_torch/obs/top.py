"""``pio trace``: one ``X-PIO-Trace`` id's spans across a node list.

Trimmed copy of ``predictionio_tpu/obs/top.py`` (``pio top`` itself is
ROADMAP.md queue 1 item 14): pull ``GET /traces.json`` from each node
and stitch every process's spans for one trace id into a single
start-time-ordered timeline. A read-only scraper: no storage, no torch.
"""

from __future__ import annotations

import http.client
import json
from typing import List, Optional, Sequence

#: default node list: one of each server on localhost (query, event,
#: storage) — the quickstart topology
DEFAULT_NODES = "localhost:8000,localhost:7070,localhost:7079"


def _split_nodes(spec: str) -> List[str]:
    return [n.strip() for n in spec.split(",") if n.strip()]


def _fetch(node: str, path: str, timeout: float = 5.0) -> Optional[str]:
    """One GET against ``host:port`` → body, or None for anything short
    of a 200 — a dead node, a garbled node spec, a non-HTTP peer. One
    bad fleet member must render as DOWN, never crash the whole table."""
    host, _, port = node.partition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port or 80), timeout=timeout)
    except (ValueError, OSError):  # 'host:abc', empty host, ...
        return None
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
        return body if resp.status == 200 else None
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        conn.close()


def collect_trace(trace_id: str, nodes: str = DEFAULT_NODES,
                  timeout: float = 5.0) -> List[dict]:
    """All spans for ``trace_id`` across the node list, start-ordered."""
    spans: List[dict] = []
    for node in _split_nodes(nodes):
        body = _fetch(node, "/traces.json", timeout=timeout)
        if body is None:
            continue
        try:
            doc = json.loads(body)
        except ValueError:
            continue
        for span in doc.get("spans", []):
            if span.get("traceId") == trace_id:
                span = dict(span)
                span.setdefault("node", node)
                spans.append(span)
    spans.sort(key=lambda s: (s.get("startMs", 0), s.get("spanId", "")))
    return spans


def render_trace(trace_id: str, spans: Sequence[dict]) -> str:
    if not spans:
        return f"trace {trace_id}: no spans found"
    t0 = min(s.get("startMs", 0) for s in spans)
    lines = [f"trace {trace_id}: {len(spans)} spans"]
    for s in spans:
        offset = s.get("startMs", 0) - t0
        err = f"  ERROR={s['error']}" if s.get("error") else ""
        tags = s.get("tags")
        tag_str = ("  " + " ".join(f"{k}={v}" for k, v in sorted(tags.items()))
                   if tags else "")
        lines.append(
            f"  +{offset:9.3f}ms  {s.get('durationMs', 0):9.3f}ms  "
            f"{s.get('service', '?'):<14} {s.get('name', '?')}"
            f"{tag_str}{err}"
        )
    return "\n".join(lines)


def run_trace(trace_id: str, nodes: str = DEFAULT_NODES, timeout: float = 5.0,
              as_json: bool = False) -> int:
    """``pio trace <id>``: exit 0 when a span was found, 1 when none."""
    spans = collect_trace(trace_id, nodes, timeout=timeout)
    if as_json:
        print(json.dumps(spans))
    else:
        print(render_trace(trace_id, spans))
    return 0 if spans else 1
