"""``pio ckpt`` — inspect, verify and garbage-collect checkpoints.

Copy of ``predictionio_tpu/ckpt/cli.py``. The console forwards its
arguments verbatim: pure filesystem reads plus the store's own GC, so it
needs neither torch nor the storage plane and works on an unconfigured
host (the one an operator logs into after a preemption).

    pio ckpt ls     --dir DIR [--json]
    pio ckpt verify --dir DIR [--step N] [--json]
    pio ckpt gc     --dir DIR [--keep-last K] [--keep-every J]
                    [--all] [--json]

``verify`` exits 1 when any committed step fails its checksums.
``gc --all`` clears the store entirely (the manual ``--no-resume``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from .settings import resolve_retention
from .store import CheckpointCorrupt, CheckpointStore


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio ckpt",
        description="checkpoint store operations",
    )
    sub = p.add_subparsers(dest="ckpt_command", required=True)

    ls = sub.add_parser("ls", help="committed steps, sizes, garbage")
    verify = sub.add_parser(
        "verify",
        help="re-hash every file against its manifest (exit 1 on any "
        "corrupt step)",
    )
    verify.add_argument(
        "--step", type=int, default=None,
        help="verify one step instead of all",
    )
    gc = sub.add_parser(
        "gc", help="apply the keep-last-k / keep-every-j retention policy"
    )
    gc.add_argument("--keep-last", type=int, default=None, metavar="K",
                    help="newest committed steps to keep (default: "
                    "PIO_CKPT_KEEP_LAST, else 3)")
    gc.add_argument("--keep-every", type=int, default=None, metavar="J",
                    help="also keep steps divisible by J (default: "
                    "PIO_CKPT_KEEP_EVERY, else off)")
    gc.add_argument("--all", action="store_true",
                    help="clear the store entirely (train fresh next run)")
    for sp in (ls, verify, gc):
        sp.add_argument("--dir", required=True, metavar="DIR",
                        help="checkpoint root (the trainer's store dir)")
        sp.add_argument("--json", action="store_true",
                        help="machine-readable output")
    return p


def _emit(args, obj: dict, lines) -> None:
    if args.json:
        print(json.dumps(obj, indent=2, sort_keys=True))
    else:
        for line in lines:
            print(line)


def run(args: argparse.Namespace) -> int:
    if not os.path.isdir(args.dir):
        # a typo'd --dir must not read as "no checkpoints": the empty
        # answer and the wrong-path answer are different facts
        raise ValueError(f"checkpoint dir does not exist: {args.dir}")
    keep_last, keep_every = resolve_retention(
        getattr(args, "keep_last", None), getattr(args, "keep_every", None)
    )
    store = CheckpointStore(args.dir, keep_last=keep_last,
                            keep_every=keep_every)

    if args.ckpt_command == "ls":
        report = store.verify()
        garbage = store.uncommitted()
        obj = {"dir": args.dir, "steps": report, "uncommitted": garbage}
        lines = [
            f"{r['step']:>10}  "
            + (f"ok  {r['files']} files  {r['bytes']} bytes"
               if r["ok"] else f"CORRUPT  {r['error']}")
            for r in report
        ] or ["(no committed checkpoints)"]
        lines += [f"{'':>10}  garbage: {g} (no manifest)" for g in garbage]
        _emit(args, obj, lines)
        return 0

    if args.ckpt_command == "verify":
        if args.step is not None:
            try:
                manifest = store.verify_step(args.step)
                report = [{"step": args.step, "ok": True,
                           "files": len(manifest["files"]),
                           "bytes": sum(r.get("bytes", 0) for r in
                                        manifest["files"].values())}]
            except CheckpointCorrupt as exc:
                report = [{"step": args.step, "ok": False,
                           "error": str(exc)}]
        else:
            report = store.verify()
        bad = [r for r in report if not r["ok"]]
        _emit(
            args, {"dir": args.dir, "steps": report, "ok": not bad},
            [
                f"{r['step']:>10}  " + ("ok" if r["ok"]
                                        else f"CORRUPT  {r['error']}")
                for r in report
            ] or ["(no committed checkpoints)"],
        )
        return 1 if bad else 0

    if args.ckpt_command == "gc":
        if args.all:
            before = store.steps()
            store.clear()
            _emit(args, {"dir": args.dir, "removed": before, "kept": []},
                  [f"removed {len(before)} checkpoint(s); store cleared"])
            return 0
        removed = store.gc(prune_uncommitted=True)
        kept = store.steps()
        _emit(
            args,
            {"dir": args.dir, "removed": removed, "kept": kept,
             "keepLast": keep_last, "keepEvery": keep_every},
            [f"removed: {removed or '[]'}", f"kept:    {kept or '[]'}"],
        )
        return 0

    return 2  # unreachable: argparse requires a subcommand


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        return run(build_parser().parse_args(argv))
    except (ValueError, OSError) as exc:
        print(json.dumps({"error": str(exc)}), file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
