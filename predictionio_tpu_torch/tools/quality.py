"""``pio quality`` — model and data quality report, and the drift diff.

Copy of ``predictionio_tpu/tools/quality.py``. Three sources, one report:

- ``--node HOST:PORT`` — scrape a live server's ``/metrics`` and digest
  its ``pio_quality_*`` families: per-variant score PSI and quantiles,
  feedback hit rate and served rank, and (on an Event Server) per-app
  ingest violations and event-mix PSI.
- default — the latest snapshot of the JSONL file the query server
  appends to (``PIO_QUALITY_SNAPSHOTS``).
- ``--diff`` — the latest snapshot against its predecessor (or against
  ``--baseline FILE``'s latest) by PSI between their serving sketches.
  Exit codes: **0** stable, **1** drift beyond ``--max-psi``, **2**
  missing or unreadable snapshots.

A read-only, storage-free, torch-free CLI; the console forwards to it
verbatim.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from ..obs.quality import (
    QualityConfig,
    SNAPSHOTS_ENV,
    load_snapshots,
    snapshot_psi,
)
from ..obs.sketch import QuantileSketch

EXIT_OK = 0
EXIT_DRIFT = 1
EXIT_ERROR = 2

#: default drift bar for ``--diff`` — the conventional "real
#: distribution change" PSI threshold
DEFAULT_MAX_PSI = 0.25

_VARIANTS = ("baseline", "candidate")


# -- live-node report ---------------------------------------------------------


def node_report(node: str, timeout: float = 5.0) -> Optional[dict]:
    """Scrape one node's ``/metrics`` → quality digest (None when the
    node is down)."""
    from ..obs.top import fetch_metrics

    metrics = fetch_metrics(node, timeout=timeout)
    if metrics is None:
        return None
    out: dict = {"node": node, "up": True}

    def by_variant(name: str) -> Dict[str, float]:
        return {
            labels.get("variant", "-"): value
            for labels, value in metrics.get(name, [])
        }

    # -1 is the gauge's abstention sentinel (no pin / too few samples);
    # an abstaining variant is omitted, exactly like persisted snapshots
    psi = {
        variant: value
        for variant, value in by_variant("pio_quality_score_psi").items()
        if value >= 0
    }
    if psi:
        out["scorePsi"] = psi
    samples = by_variant("pio_quality_score_samples")
    if samples:
        out["scoreSamples"] = samples
    quantiles: Dict[str, Dict[str, float]] = {}
    for labels, value in metrics.get("pio_quality_score_quantile", []):
        variant = labels.get("variant", "-")
        quantiles.setdefault(variant, {})[labels.get("q", "?")] = value
    if quantiles:
        out["scoreQuantiles"] = quantiles

    feedback: dict = {}
    for labels, value in metrics.get(
        "pio_quality_feedback_events_total", []
    ):
        feedback[labels.get("outcome", "?")] = int(value)
    hit_rate = metrics.get("pio_quality_feedback_hit_rate")
    # a rate over zero joined events is undefined, not 0.0 — and only
    # hit/miss outcomes join; an unjoined backlog must not read as 0.0
    if hit_rate and (feedback.get("hit") or feedback.get("miss")):
        feedback["hitRate"] = hit_rate[0][1]
    mean_rank = metrics.get("pio_quality_feedback_mean_rank")
    if mean_rank and mean_rank[0][1]:
        feedback["meanServedRank"] = mean_rank[0][1]
    if feedback:
        out["feedback"] = feedback

    ingest: Dict[str, dict] = {}
    for labels, value in metrics.get(
        "pio_quality_ingest_events_total", []
    ):
        app = labels.get("app", "?")
        ingest.setdefault(app, {})["events"] = int(value)
    for labels, value in metrics.get(
        "pio_quality_ingest_violations_total", []
    ):
        app = labels.get("app", "?")
        ingest.setdefault(app, {}).setdefault("violations", {})[
            labels.get("kind", "?")
        ] = int(value)
    for labels, value in metrics.get("pio_quality_event_mix_psi", []):
        if value < 0:  # -1 sentinel: abstaining, not measured-stable
            continue
        app = labels.get("app", "?")
        ingest.setdefault(app, {})["mixPsi"] = value
    if ingest:
        out["ingest"] = ingest
    return out


# -- snapshot report ----------------------------------------------------------


def snapshot_report(snap: dict) -> dict:
    """One persisted snapshot → the same digest shape a node scrape
    yields (quantiles recomputed from the stored sketches)."""
    out: dict = {"source": snap.get("source", "?")}
    psi = snap.get("psi") or {}
    if psi:
        out["scorePsi"] = dict(psi)
    quantiles: Dict[str, Dict[str, float]] = {}
    samples: Dict[str, int] = {}
    for variant, doc in (snap.get("serving") or {}).items():
        try:
            sketch = QuantileSketch.from_dict(doc)
        except (TypeError, ValueError):
            continue
        samples[variant] = sketch.count
        quantiles[variant] = {
            f"{q:g}": round(sketch.quantile(q), 6)
            for q in (0.5, 0.9, 0.99)
        }
    if samples:
        out["scoreSamples"] = samples
    if quantiles:
        out["scoreQuantiles"] = quantiles
    feedback = snap.get("feedback") or {}
    if feedback:
        fb = dict(feedback)
        total = fb.get("total") or 0
        if total:
            fb["hitRate"] = round((fb.get("hits") or 0) / total, 4)
        out["feedback"] = fb
    return out


# -- rendering ---------------------------------------------------------------


def render_report(report: dict) -> str:
    lines: List[str] = []
    title = report.get("node") or report.get("source") or "quality"
    lines.append(f"quality [{title}]")
    psi = report.get("scorePsi") or {}
    samples = report.get("scoreSamples") or {}
    quantiles = report.get("scoreQuantiles") or {}
    for variant in _VARIANTS:
        if (
            variant not in psi
            and variant not in samples
            and variant not in quantiles
        ):
            continue
        qs = quantiles.get(variant, {})
        q_text = " ".join(
            f"p{float(q) * 100:g}={value:.4g}"
            for q, value in sorted(qs.items(), key=lambda kv: float(kv[0]))
        )
        value = psi.get(variant)
        psi_text = "-       " if value is None else f"{value:<8.4f}"
        lines.append(
            f"  {variant:<10} psi={psi_text} "
            f"samples={int(samples.get(variant, 0)):<7d} {q_text}".rstrip()
        )
    feedback = report.get("feedback")
    if feedback:
        hit_rate = feedback.get("hitRate")
        rank = feedback.get("meanServedRank")
        hits = feedback.get("hit", feedback.get("hits", 0))
        if "total" in feedback:  # snapshot shape: hits/total
            counts = f"hits={hits}/{feedback['total']} "
        else:  # node-scrape shape: hit/miss outcome counters
            counts = f"hits={hits} misses={feedback.get('miss', 0)} "
        lines.append(
            "  feedback   "
            + counts
            + (f"hitRate={hit_rate:.3f} " if hit_rate is not None else "")
            + (f"meanRank={rank:.2f}" if rank else "")
        )
    for app, stats in sorted((report.get("ingest") or {}).items()):
        violations = stats.get("violations") or {}
        v_text = " ".join(
            f"{kind}={n}" for kind, n in sorted(violations.items())
        )
        mix = stats.get("mixPsi")
        lines.append(
            f"  ingest app={app} events={stats.get('events', 0)} "
            + (f"mixPsi={mix:.4f} " if mix is not None else "")
            + v_text
        )
    if len(lines) == 1:
        lines.append("  (no quality signals yet)")
    return "\n".join(lines)


# -- diff (the CI drift gate) -------------------------------------------------


def run_diff(
    snapshots: Optional[str],
    baseline: Optional[str],
    max_psi: float,
    as_json: bool = False,
    min_samples: Optional[int] = None,
) -> int:
    """Latest snapshot vs its reference → 0 stable / 1 drift / 2 error."""
    if not snapshots:
        print(
            "error: --diff needs --snapshots FILE (or PIO_QUALITY_SNAPSHOTS)",
            file=sys.stderr,
        )
        return EXIT_ERROR
    current_all = load_snapshots(snapshots)
    if not current_all:
        print(
            f"error: no quality snapshots in {snapshots}", file=sys.stderr
        )
        return EXIT_ERROR
    current = current_all[-1]
    if baseline:
        reference_all = load_snapshots(baseline)
        if not reference_all:
            print(
                f"error: no quality snapshots in {baseline}",
                file=sys.stderr,
            )
            return EXIT_ERROR
        reference = reference_all[-1]
    else:
        if len(current_all) < 2:
            print(
                "error: --diff needs two snapshots (or --baseline FILE)",
                file=sys.stderr,
            )
            return EXIT_ERROR
        reference = current_all[-2]
    if min_samples is None:
        # the deployment's configured floor rides each snapshot; the
        # newest one speaks for the fleet's current config (older
        # snapshots may predate the field — fall back to the default)
        min_samples = (
            current.get("minPsiSamples")
            or reference.get("minPsiSamples")
            or QualityConfig.min_psi_samples
        )
    verdicts: dict = {}
    drifted = False
    for variant in _VARIANTS:
        value = snapshot_psi(
            reference, current, variant=variant, min_samples=min_samples
        )
        if value is None:
            continue
        verdicts[variant] = round(value, 6)
        if value > max_psi:
            drifted = True
    if not verdicts:
        print(
            "error: the snapshots share no comparable serving sketch",
            file=sys.stderr,
        )
        return EXIT_ERROR
    if as_json:
        print(
            json.dumps(
                {
                    "psi": verdicts,
                    "maxPsi": max_psi,
                    "drift": drifted,
                    "reference": reference.get("source"),
                    "current": current.get("source"),
                }
            )
        )
    else:
        for variant, value in sorted(verdicts.items()):
            marker = "DRIFT" if value > max_psi else "ok"
            print(
                f"{marker} {variant}: psi={value:.4f} "
                f"(bar {max_psi:.4f}) "
                f"{reference.get('source', '?')} -> "
                f"{current.get('source', '?')}"
            )
    return EXIT_DRIFT if drifted else EXIT_OK


# -- CLI glue ----------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio quality",
        description="model & data quality report + drift diff",
    )
    p.add_argument(
        "--node", default=None, metavar="HOST:PORT",
        help="scrape a live server's /metrics instead of snapshots",
    )
    p.add_argument(
        "--snapshots", default=None, metavar="FILE",
        help="quality-snapshot JSONL (default: $PIO_QUALITY_SNAPSHOTS)",
    )
    p.add_argument(
        "--diff", action="store_true",
        help="compare the two latest snapshots (or --baseline's latest "
        "vs --snapshots' latest); exit 1 on drift beyond --max-psi, "
        "2 on missing/unreadable snapshots",
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="with --diff: take the reference snapshot from this file",
    )
    p.add_argument(
        "--max-psi", type=float, default=DEFAULT_MAX_PSI,
        help="drift bar for --diff (default %(default)s)",
    )
    p.add_argument(
        "--min-samples", type=int, default=None, metavar="N",
        help="with --diff: abstention floor per sketch side (default: "
        "the floor recorded in the newest snapshot, else "
        f"{QualityConfig.min_psi_samples})",
    )
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--json", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    import os

    args = build_parser().parse_args(argv)
    snapshots = args.snapshots or os.environ.get(SNAPSHOTS_ENV)
    if args.diff:
        return run_diff(
            snapshots, args.baseline, args.max_psi, as_json=args.json,
            min_samples=args.min_samples,
        )
    if args.node:
        report = node_report(args.node, timeout=args.timeout)
        if report is None:
            print(f"error: no /metrics at {args.node}", file=sys.stderr)
            return EXIT_ERROR
    else:
        if not snapshots:
            print(
                "error: nothing to report — pass --node HOST:PORT or "
                "--snapshots FILE (or set PIO_QUALITY_SNAPSHOTS)",
                file=sys.stderr,
            )
            return EXIT_ERROR
        snaps = load_snapshots(snapshots)
        if not snaps:
            print(
                f"error: no quality snapshots in {snapshots}",
                file=sys.stderr,
            )
            return EXIT_ERROR
        report = snapshot_report(snaps[-1])
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(render_report(report))
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
