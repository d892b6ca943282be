"""Event export: an app's events → JSON lines.

Trimmed copy of ``predictionio_tpu/tools/export_events.py`` (a rebuild
of ``tools/.../export/EventsToFile.scala``): one JSON document per line,
the format that round-trips with :mod:`.import_events` and with the
reference. The parquet format is not ported (ROADMAP.md, queue 1 item
14).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence, TextIO

from ..storage import EventFilter, StorageRegistry, get_registry
from .import_events import PARQUET_NOT_PORTED


def export_events(registry: StorageRegistry, app_id: int, out: TextIO,
                  event_filter: Optional[EventFilter] = None) -> int:
    """Stream every matching event as one JSON object per line; returns
    the number of events written."""
    count = 0
    for event in registry.get_events().find(app_id, event_filter or EventFilter()):
        out.write(json.dumps(event.to_json_dict(), separators=(",", ":")))
        out.write("\n")
        count += 1
    return count


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="export_events")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--format", choices=("json", "parquet"), default="json")
    args = p.parse_args(argv)
    if args.format == "parquet":
        raise NotImplementedError(PARQUET_NOT_PORTED)
    with open(args.output, "w", encoding="utf-8") as fh:
        n = export_events(get_registry(), args.appid, fh)
    print(json.dumps({"appId": args.appid, "events": n, "output": args.output}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
