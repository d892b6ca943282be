"""Injectable fake monotonic clock (copy of ``predictionio_tpu/testing/clock.py``).

Every plane with time-based decisions (breakers, retries, deadlines, the
SLO windows, the stall watchdog) takes an injected ``clock`` callable;
tests drive them with this one instead of sleeping.
"""

from __future__ import annotations

__all__ = ["FakeClock"]


class FakeClock:
    """A monotonic clock that only moves when told to."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds
