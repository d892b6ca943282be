"""Durable performance ledger: one JSON line per training run.

Trimmed copy of ``predictionio_tpu/obs/perfledger.py``: the record
schema, the fsynced append and the loader. A training run appends one
schema-versioned record (value, device, phases) to the file that
``PIO_PERF_LEDGER`` names. Records are dicts, the file is line-delimited
JSON, unparseable lines are skipped on load (an append torn by a crash
must not eat the history), and appends fsync: the ledger is evidence,
not a cache.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

__all__ = ["LEDGER_ENV", "SCHEMA_VERSION", "append_record", "load_ledger", "make_record"]

SCHEMA_VERSION = 1

#: env naming the ledger file training runs append to
LEDGER_ENV = "PIO_PERF_LEDGER"


def make_record(
    source: str,
    metric: str,
    value: float,
    unit: str = "s",
    device: Optional[str] = None,
    scale: Optional[float] = None,
    levers: Optional[Dict[str, object]] = None,
    rmse: Optional[float] = None,
    vs_baseline: Optional[float] = None,
    phases: Optional[Dict[str, float]] = None,
    extra: Optional[dict] = None,
    recorded_at: Optional[float] = None,
) -> dict:
    """One schema-versioned ledger record (the JAX package's schema).
    ``unit == "s"`` and ``unit == "bytes"`` mean lower is better."""
    record: dict = {
        "schema": SCHEMA_VERSION,
        "source": source,
        "metric": metric,
        "value": float(value),
        "unit": unit,
    }
    if recorded_at is not None:
        record["recorded_at_unix"] = float(recorded_at)
    if device is not None:
        record["device"] = device
    if scale is not None:
        record["scale"] = scale
    if levers:
        record["levers"] = dict(levers)
    if rmse is not None:
        record["rmse"] = rmse
    if vs_baseline is not None:
        record["vs_baseline"] = vs_baseline
    if phases:
        record["phases"] = dict(phases)
    if extra:
        record["extra"] = dict(extra)
    return record


def append_record(path: str, record: dict) -> None:
    """Append one record as a JSON line, fsynced: a torn tail costs at
    most one line."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    line = json.dumps(record, sort_keys=True) + "\n"
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(line)
        fh.flush()
        os.fsync(fh.fileno())


def load_ledger(path: str) -> List[dict]:
    """Every parseable record in file order; unparseable lines (a torn
    append, hand-editing damage) are skipped, never fatal."""
    records: List[dict] = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    parsed = json.loads(line)
                except ValueError:
                    continue
                if isinstance(parsed, dict) and "value" in parsed:
                    records.append(parsed)
    except OSError:
        return []
    return records
