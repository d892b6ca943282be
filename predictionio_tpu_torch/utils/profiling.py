"""Profiling hooks: phase timers and device traces.

Trimmed copy of ``predictionio_tpu/utils/profiling.py``. Every workflow
run carries a :class:`StepTimer` (phase wall-clock, logged and persisted
with the engine instance), and :func:`device_trace` wraps
``torch.profiler.profile`` so a run writes a TensorBoard-loadable trace
of the host and, where there is one, the card (``PIO_PROFILE_DIR``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Iterator, Optional

import torch


class StepTimer:
    """Accumulates named phase timings (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[str, list] = {}

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._records.setdefault(name, []).append(float(seconds))

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": len(vals),
                    "total_s": sum(vals),
                    "mean_s": sum(vals) / len(vals),
                    "max_s": max(vals),
                }
                for name, vals in self._records.items()
                if vals
            }

    def format_summary(self) -> str:
        parts = [
            f"{name}: {s['total_s']:.3f}s"
            + (f" ({s['count']}x, mean {s['mean_s']:.3f}s)" if s["count"] > 1 else "")
            for name, s in sorted(self.summary().items())
        ]
        return "; ".join(parts) or "(no phases recorded)"


#: instance-env key of a completed run's phase summary (phase → total
#: seconds): a StepTimer dies with its process, the timings belong to the
#: instance
TRAIN_PHASES_ENV_KEY = "PIO_TRAIN_PHASES"


def phases_to_env(summary: Dict[str, Dict[str, float]]) -> str:
    """``StepTimer.summary()`` → the compact JSON stored in the engine
    instance env (phase → total seconds)."""
    return json.dumps(
        {name: round(s["total_s"], 6) for name, s in sorted(summary.items())}
    )


def phases_from_env(env: Optional[Dict[str, str]]) -> Dict[str, float]:
    """Inverse of :func:`phases_to_env`; {} on absence or garbage (an old
    instance record must not break a reader)."""
    raw = (env or {}).get(TRAIN_PHASES_ENV_KEY)
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
        return {
            str(k): float(v)
            for k, v in parsed.items()
            if isinstance(v, (int, float))
        }
    except (ValueError, AttributeError):
        return {}


#: instance-env key of a completed run's profile (``{"train_wall_s": …}``)
TRAIN_PROFILE_ENV_KEY = "PIO_TRAIN_PROFILE"


def profile_to_env(snapshot: Dict) -> str:
    """A JSON-safe profile dict → the instance-env string."""
    return json.dumps(snapshot, sort_keys=True)


def profile_from_env(env: Optional[Dict[str, str]]) -> Dict:
    """Inverse of :func:`profile_to_env`; {} on absence or garbage."""
    raw = (env or {}).get(TRAIN_PROFILE_ENV_KEY)
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
        return parsed if isinstance(parsed, dict) else {}
    except ValueError:
        return {}


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler.profile`` over the block, written to ``logdir`` by
    ``tensorboard_trace_handler`` (``<worker>.<time>.pt.trace.json``): CPU
    activity, and CUDA activity where CUDA is present. A falsy ``logdir``
    makes it a no-op. A trace that was asked for and cannot be written
    raises."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ):
        yield
