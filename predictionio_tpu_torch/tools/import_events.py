"""Event import: JSON-lines file → an app's event store.

Trimmed copy of ``predictionio_tpu/tools/import_events.py`` (a rebuild
of ``tools/.../imprt/FileToEvents.scala``): each line is one event
document, and an invalid line aborts the import with its line number.
Events go through the store's bulk ``write``, one batch at a time (on
the native log a columnar append). The parquet format is not ported
(ROADMAP.md, queue 1 item 14).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, Optional, Sequence

from ..storage import Event, StorageRegistry, get_registry, validate_event

PARQUET_NOT_PORTED = (
    "the parquet format is not ported to the PyTorch package yet "
    "(ROADMAP.md, queue 1 item 14); use --format json"
)


class ImportError_(ValueError):
    """A line failed to parse or validate."""


def _parse_lines(lines: Iterable[str]) -> Iterable[Event]:
    for lineno, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            event = Event.from_json_dict(json.loads(line))
            validate_event(event)
        except Exception as exc:
            raise ImportError_(f"line {lineno}: {exc}") from exc
        yield event


def import_events(registry: StorageRegistry, app_id: int, lines: Iterable[str],
                  batch_size: int = 1000) -> int:
    """Bulk-insert events in batches; returns the number imported."""
    store = registry.get_events()
    store.init(app_id)
    batch: list = []
    count = 0
    for event in _parse_lines(lines):
        batch.append(event)
        if len(batch) >= batch_size:
            store.write(batch, app_id)
            count += len(batch)
            batch = []
    if batch:
        store.write(batch, app_id)
        count += len(batch)
    return count


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="import_events")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--format", choices=("json", "parquet"), default="json")
    args = p.parse_args(argv)
    if args.format == "parquet":
        raise NotImplementedError(PARQUET_NOT_PORTED)
    with open(args.input, "r", encoding="utf-8") as fh:
        n = import_events(get_registry(), args.appid, fh)
    print(json.dumps({"appId": args.appid, "events": n, "input": args.input}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
