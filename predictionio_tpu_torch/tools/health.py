"""``pio health`` / ``pio alerts`` / ``pio blackbox`` — the fleet-health CLIs.

Copy of ``predictionio_tpu/tools/health.py``: read-only, storage-free
scrapers over the health plane's routes, which the console forwards
verbatim:

- ``pio health [--nodes ...]`` — every node's ``GET /health.json`` in one
  table: firing objectives, the worst fast-window burn, stalls,
  abstaining objectives. Exit **0** healthy, **1** any node firing or
  stalled, **2** no node reachable.
- ``pio alerts [--ledger FILE | --node H:P]`` — the alert ledger
  (``PIO_ALERT_LEDGER``) in time order, or a live node's alert states.
  Exit **1** when an objective's latest state is FIRING, **0** when all
  cleared, **2** on a missing or unreadable ledger.
- ``pio blackbox dump|show`` — a live node's flight-recorder ring
  (``GET /blackbox.json``) into a dump file, or a dump (the newest under
  ``PIO_FLIGHT_DIR`` by default) rendered as a timeline. Exit **2** when
  the source is unreachable or missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from ..obs.flight import FLIGHT_DIR_ENV, load_dump, write_dump
from ..obs.slo import ALERT_LEDGER_ENV, load_alerts

EXIT_OK = 0
EXIT_UNHEALTHY = 1
EXIT_ERROR = 2


# -- scraping -----------------------------------------------------------------


def _fetch_json(node: str, path: str, timeout: float = 5.0) -> Optional[dict]:
    from ..obs.top import _fetch

    body = _fetch(node, path, timeout=timeout)
    if body is None:
        return None
    try:
        doc = json.loads(body)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def node_health(node: str, timeout: float = 5.0) -> Optional[dict]:
    """One node's ``/health.json`` digested into a fleet-table row
    (None when the node is down)."""
    doc = _fetch_json(node, "/health.json", timeout=timeout)
    if doc is None:
        return None
    objectives = [
        o for o in doc.get("objectives", []) if isinstance(o, dict)
    ]
    stalls = doc.get("stalls") or {}
    burns = [
        o.get("burnFast")
        for o in objectives
        if isinstance(o.get("burnFast"), (int, float))
    ]
    return {
        "node": node,
        "up": True,
        "kind": doc.get("kind", "?"),
        "objectives": objectives,
        "firing": [
            o.get("name", "?")
            for o in objectives
            if o.get("state") == "FIRING"
        ],
        "abstaining": sum(1 for o in objectives if o.get("abstaining")),
        "worstBurnFast": max(burns) if burns else None,
        "stallsDetected": stalls.get("detected", 0),
        "stallsActive": stalls.get("active") or [],
        "inflight": stalls.get("inflight", 0),
        "lastDump": stalls.get("lastDump"),
    }


# -- pio health ---------------------------------------------------------------


def render_health_table(rows: Sequence[dict]) -> str:
    headers = ["NODE", "KIND", "HEALTH", "FIRING", "BURN", "STALLS",
               "ABSTAIN"]
    table: List[List[str]] = [headers]
    for row in rows:
        if not row.get("up"):
            table.append([str(row.get("node", "?")), "-", "DOWN", "-",
                          "-", "-", "-"])
            continue
        firing = row.get("firing") or []
        stalls_active = row.get("stallsActive") or []
        health = "ALERT" if firing else (
            "STALL" if stalls_active else "ok"
        )
        burn = row.get("worstBurnFast")
        table.append([
            str(row.get("node", "?")),
            str(row.get("kind", "?")),
            health,
            " ".join(firing) or "-",
            "-" if burn is None else f"{burn:.2f}",
            str(row.get("stallsDetected", 0)),
            str(row.get("abstaining", 0)),
        ])
    widths = [max(len(r[i]) for r in table) for i in range(len(headers))]
    return "\n".join(
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
        for row in table
    )


def run_health(
    nodes: str, timeout: float = 5.0, as_json: bool = False
) -> int:
    from ..obs.top import _split_nodes

    rows = []
    for node in _split_nodes(nodes):
        row = node_health(node, timeout=timeout)
        rows.append(row if row is not None else {"node": node, "up": False})
    if as_json:
        print(json.dumps(rows, default=str))
    else:
        print(render_health_table(rows))
    if not any(r.get("up") for r in rows):
        return EXIT_ERROR
    unhealthy = any(
        r.get("firing") or r.get("stallsActive") for r in rows
    )
    return EXIT_UNHEALTHY if unhealthy else EXIT_OK


# -- pio alerts ---------------------------------------------------------------


def _fmt_at(at) -> str:
    if not isinstance(at, (int, float)):
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(at))


def render_alerts(alerts: Sequence[dict]) -> str:
    if not alerts:
        return "(no alert transitions recorded)"
    lines = []
    for alert in alerts:
        burn_fast = alert.get("burnFast")
        burn = (
            f"{burn_fast:.2f}"
            if isinstance(burn_fast, (int, float))
            else "-"
        )
        lines.append(
            f"{_fmt_at(alert.get('at'))}  "
            f"{alert.get('state', '?'):<8} "
            f"{alert.get('node', '?'):<10} "
            f"{alert.get('objective', '?'):<14} "
            f"burnFast={burn} "
            f"({alert.get('metric', '?')})"
        )
    return "\n".join(lines)


def latest_states(alerts: Sequence[dict]) -> Dict[str, str]:
    """Last durable state per (node, objective) — the ledger's verdict
    on what is firing right now."""
    out: Dict[str, str] = {}
    for alert in alerts:
        key = f"{alert.get('node', '?')}/{alert.get('objective', '?')}"
        out[key] = str(alert.get("state", "?"))
    return out


def run_alerts(
    ledger: Optional[str],
    node: Optional[str],
    timeout: float = 5.0,
    as_json: bool = False,
) -> int:
    if node:
        row = node_health(node, timeout=timeout)
        if row is None:
            print(f"error: no /health.json at {node}", file=sys.stderr)
            return EXIT_ERROR
        if as_json:
            print(json.dumps(row, default=str))
        else:
            for obj in row["objectives"]:
                marker = obj.get("state", "?")
                burn = obj.get("burnFast")
                print(
                    f"{marker:<8} {obj.get('name', '?'):<14} "
                    + ("abstaining" if obj.get("abstaining") else
                       f"burnFast={burn}")
                )
        return EXIT_UNHEALTHY if row["firing"] else EXIT_OK
    if not ledger:
        print(
            "error: pass --ledger FILE or --node HOST:PORT "
            f"(or set {ALERT_LEDGER_ENV})",
            file=sys.stderr,
        )
        return EXIT_ERROR
    alerts = load_alerts(ledger)
    if not alerts:
        # distinguish "readable but empty" (exit 0) from "missing or
        # unreadable" (exit 2 — a monitoring script must never read a
        # broken evidence ledger as everything-cleared)
        try:
            with open(ledger, encoding="utf-8") as fh:
                fh.read(1)
        except OSError:
            print(
                f"error: no readable alert ledger at {ledger}",
                file=sys.stderr,
            )
            return EXIT_ERROR
        print("(no alert transitions recorded)")
        return EXIT_OK
    states = latest_states(alerts)
    if as_json:
        print(json.dumps({"alerts": alerts, "latest": states}))
    else:
        print(render_alerts(alerts))
    firing = [key for key, state in states.items() if state == "FIRING"]
    return EXIT_UNHEALTHY if firing else EXIT_OK


# -- pio blackbox -------------------------------------------------------------


def render_dump(events: Sequence[dict], title: str) -> str:
    if not events:
        return f"blackbox [{title}]: (empty ring)"
    t0 = min(e.get("t", 0) for e in events)
    lines = [f"blackbox [{title}]: {len(events)} events"]
    for event in events:
        details = event.get("details") or {}
        detail_str = " ".join(
            f"{k}={v}" for k, v in sorted(details.items())
        )
        trace = event.get("trace")
        lines.append(
            f"  +{event.get('t', 0) - t0:10.3f}s  "
            f"{event.get('kind', '?'):<10} {event.get('site', '?'):<24} "
            f"{detail_str}"
            + (f"  trace={trace}" if trace else "")
        )
    return "\n".join(lines)


def _latest_dump_path(directory: str) -> Optional[str]:
    try:
        candidates = [
            os.path.join(directory, name)
            for name in os.listdir(directory)
            if name.endswith(".jsonl")
            and (name.startswith("flight-") or name.startswith("stall-"))
        ]
    except OSError:
        return None
    if not candidates:
        return None
    return max(candidates, key=lambda p: os.path.getmtime(p))


def run_blackbox(
    action: str,
    node: Optional[str],
    file: Optional[str],
    out: Optional[str],
    timeout: float = 5.0,
    as_json: bool = False,
) -> int:
    if action == "dump":
        if not node:
            print("error: blackbox dump needs --node HOST:PORT",
                  file=sys.stderr)
            return EXIT_ERROR
        doc = _fetch_json(node, "/blackbox.json", timeout=timeout)
        if doc is None:
            print(f"error: no /blackbox.json at {node}", file=sys.stderr)
            return EXIT_ERROR
        events = doc.get("events", [])
        if out:
            write_dump(out, events, f"pio blackbox dump {node}")
            print(f"wrote {len(events)} events to {out}")
        elif as_json:
            print(json.dumps(doc, default=str))
        else:
            print(render_dump(events, node))
        return EXIT_OK
    # show: a dump file, or the freshest dump under PIO_FLIGHT_DIR
    path = file
    if path is None:
        directory = os.environ.get(FLIGHT_DIR_ENV)
        if directory:
            path = _latest_dump_path(directory)
    if path is None:
        print(
            "error: blackbox show needs --file DUMP (or a dump under "
            f"${FLIGHT_DIR_ENV})",
            file=sys.stderr,
        )
        return EXIT_ERROR
    doc = load_dump(path)
    if doc is None:
        print(f"error: no readable flight dump at {path}", file=sys.stderr)
        return EXIT_ERROR
    if as_json:
        print(json.dumps(doc, default=str))
    else:
        reason = doc["header"].get("reason", "?")
        print(render_dump(doc["events"], f"{path} ({reason})"))
    return EXIT_OK


# -- CLI glue -----------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio health",
        description="fleet health: SLO burn-rate alerts, stall "
        "forensics, flight-recorder dumps",
    )
    sub = p.add_subparsers(dest="command", required=True)

    he = sub.add_parser("health", help="scrape /health.json fleet-wide")
    he.add_argument("--nodes", default=None, metavar="HOST:PORT,...")
    he.add_argument("--timeout", type=float, default=5.0)
    he.add_argument("--json", action="store_true")

    al = sub.add_parser(
        "alerts", help="alert ledger / live alert states"
    )
    al.add_argument(
        "--ledger", default=None, metavar="FILE",
        help=f"alert-ledger JSONL (default: ${ALERT_LEDGER_ENV})",
    )
    al.add_argument(
        "--node", default=None, metavar="HOST:PORT",
        help="read a live node's alert states instead of the ledger",
    )
    al.add_argument("--timeout", type=float, default=5.0)
    al.add_argument("--json", action="store_true")

    bb = sub.add_parser(
        "blackbox", help="flight-recorder dump / timeline render"
    )
    bb.add_argument("action", choices=("dump", "show"))
    bb.add_argument("--node", default=None, metavar="HOST:PORT")
    bb.add_argument("--file", default=None, metavar="DUMP")
    bb.add_argument(
        "--out", default=None, metavar="FILE",
        help="with dump: write the fetched ring to this file",
    )
    bb.add_argument("--timeout", type=float, default=5.0)
    bb.add_argument("--json", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "health":
        from ..obs.top import DEFAULT_NODES

        return run_health(
            args.nodes or DEFAULT_NODES,
            timeout=args.timeout,
            as_json=args.json,
        )
    if args.command == "alerts":
        ledger = args.ledger or os.environ.get(ALERT_LEDGER_ENV)
        return run_alerts(
            ledger, args.node, timeout=args.timeout, as_json=args.json
        )
    return run_blackbox(
        args.action, args.node, args.file, args.out,
        timeout=args.timeout, as_json=args.json,
    )


if __name__ == "__main__":
    sys.exit(main())
