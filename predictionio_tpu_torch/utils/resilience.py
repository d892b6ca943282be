"""Resilience primitives of the online data plane.

Copy of ``predictionio_tpu/utils/resilience.py``:

- :class:`Deadline` — a request's time budget, carried across processes
  as the *remaining* milliseconds in ``X-PIO-Deadline-Ms`` and checked at
  every stage (admission, then again before the micro-batcher dispatch,
  so an expired query never takes a slot on the card);
- :class:`RetryPolicy` — bounded retries, exponential backoff with full
  jitter (delay ~ U(0, min(cap, base·2^i))); rng, sleep and clock
  injectable;
- :class:`CircuitBreaker` — closed → open after ``failure_threshold``
  consecutive failures, open → half-open after ``reset_timeout_s``,
  half-open admits ``half_open_probes`` probes whose outcome closes or
  re-opens it. A query server whose feedback or error-log sink trips one
  keeps answering from the tables already on the card.

Environment (:meth:`CircuitBreaker.from_env`): ``PIO_BREAKER_FAILURES``
(default 5), ``PIO_BREAKER_RESET_S`` (30), ``PIO_BREAKER_HALF_OPEN_PROBES``
(1).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from typing import Any, Callable, Iterator, Optional, Tuple, Type

__all__ = [
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "RetryPolicy",
    "CircuitBreaker",
    "CircuitOpen",
    "current_deadline",
    "deadline_scope",
]

#: Wire header carrying a request's REMAINING budget in milliseconds.
#: Relative, not absolute: the sender computes ``remaining_ms()`` at send
#: time, so the receiver needs no clock agreement with the sender.
DEADLINE_HEADER = "X-PIO-Deadline-Ms"


class DeadlineExceeded(RuntimeError):
    """A request overran its deadline. ``stage`` names where it was
    caught (admission / dispatch / downstream), for the status counters
    and the error body."""

    def __init__(self, message: str, stage: str = ""):
        super().__init__(message)
        self.stage = stage


class Deadline:
    """A monotonic-clock expiry point with an injectable clock.

    Created from a millisecond budget (:meth:`after_ms`) or an incoming
    header (:meth:`from_header`); consumed via :meth:`check` (raise when
    expired), :meth:`remaining_s` (cap a socket timeout) and
    :meth:`header_value` (propagate downstream).
    """

    __slots__ = ("_expires_at", "_clock")

    def __init__(
        self, expires_at: float, clock: Callable[[], float] = time.monotonic
    ):
        self._expires_at = expires_at
        self._clock = clock

    @classmethod
    def after_ms(
        cls, budget_ms: float, clock: Callable[[], float] = time.monotonic
    ) -> "Deadline":
        return cls(clock() + budget_ms / 1000.0, clock)

    @classmethod
    def from_header(
        cls,
        value: Optional[str],
        clock: Callable[[], float] = time.monotonic,
    ) -> Optional["Deadline"]:
        """Parse an ``X-PIO-Deadline-Ms`` header. Absent or malformed →
        ``None`` (no deadline): a garbled header from a buggy client must
        degrade to today's unbounded behavior, never to a 500."""
        if value is None:
            return None
        try:
            budget_ms = float(value.strip())
        except (ValueError, AttributeError):
            return None
        if budget_ms < 0:
            budget_ms = 0.0
        return cls.after_ms(budget_ms, clock)

    def remaining_s(self) -> float:
        """Seconds left; negative when already expired."""
        return self._expires_at - self._clock()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0

    def check(self, stage: str) -> None:
        """Raise :class:`DeadlineExceeded` when the budget is gone —
        call at every stage boundary so an expired request stops at the
        *next* checkpoint instead of riding the whole pipeline."""
        remaining = self.remaining_s()
        if remaining <= 0:
            raise DeadlineExceeded(
                f"deadline exceeded at {stage} "
                f"({-remaining * 1000.0:.1f} ms past budget)",
                stage=stage,
            )

    def cap_timeout(self, timeout_s: float) -> float:
        """A socket timeout never longer than the remaining budget (with
        a floor: a non-positive socket timeout means 'non-blocking' to
        the stdlib, which is never what a deadline means)."""
        return max(0.001, min(timeout_s, self.remaining_s()))

    def header_value(self) -> str:
        return str(max(0, int(self.remaining_ms())))


# -- ambient propagation ------------------------------------------------------
#
# The serving request path crosses module boundaries whose signatures
# predate deadlines (engine `supplement`/`serve` hooks calling into the
# event store at query time). A context-local carries the live request's
# deadline to those depths without threading a parameter through every
# engine API. NOTE: contextvars do not cross thread boundaries, so work
# handed to the MicroBatcher's worker threads must be deadline-checked
# BEFORE submission (which the query server does).

_ambient_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "pio_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    """The deadline of the request this thread is serving, if any."""
    return _ambient_deadline.get()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[None]:
    """Make ``deadline`` ambient for the dynamic extent of a request."""
    token = _ambient_deadline.set(deadline)
    try:
        yield
    finally:
        _ambient_deadline.reset(token)


class RetryPolicy:
    """Bounded retries with exponential backoff and full jitter.

    ``attempts`` is the TOTAL number of tries (1 = no retry). Delay
    before retry *i* (0-based) is drawn uniformly from
    ``[0, min(max_delay_s, base_delay_s * 2**i)]`` — AWS-style full
    jitter, so a fleet of clients retrying the same dead dependency
    spreads out instead of stampeding in lockstep.

    ``rng``, ``sleep`` and ``clock`` are injectable: tests pin the rng
    and capture sleeps, so every schedule asserts deterministically with
    zero wall-clock cost.

    ``on_retry`` (optional) fires once per retry actually taken, with
    the 0-based retry index — the hook the serving metrics use to count
    retries without wrapping every call site. It must not raise.
    """

    def __init__(
        self,
        attempts: int = 3,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        on_retry: Optional[Callable[[int], None]] = None,
    ):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.retry_on = retry_on
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._clock = clock
        self._on_retry = on_retry

    def delay_for(self, retry_index: int) -> float:
        """The (jittered) delay before retry ``retry_index`` (0-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** retry_index))
        return self._rng.uniform(0.0, cap)

    def call(
        self,
        fn: Callable[[], Any],
        should_retry: Optional[Callable[[BaseException], bool]] = None,
        deadline: Optional[Deadline] = None,
    ) -> Any:
        """Run ``fn`` under the policy.

        Retries only exceptions matching ``retry_on`` (and, when given,
        the ``should_retry`` predicate — e.g. "lockfile contention only").
        A live ``deadline`` bounds the whole schedule: no retry is
        attempted once the budget cannot cover its backoff delay."""
        last: Optional[BaseException] = None
        for attempt in range(self.attempts):
            if deadline is not None and attempt > 0:
                deadline.check("retry")
            try:
                return fn()
            except self.retry_on as exc:
                if should_retry is not None and not should_retry(exc):
                    raise
                last = exc
                if attempt == self.attempts - 1:
                    raise
                delay = self.delay_for(attempt)
                if deadline is not None and deadline.remaining_s() <= delay:
                    raise  # the budget can't cover the backoff: fail now
                if self._on_retry is not None:
                    self._on_retry(attempt)
                self._sleep(delay)
        raise last  # pragma: no cover — loop always returns or raises


class CircuitOpen(RuntimeError):
    """Fast-fail: the protected dependency's circuit is open. Carries
    ``retry_after_s`` so callers (and HTTP 503 responses) can surface a
    meaningful Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Classic three-state circuit breaker with probe-limited half-open.

    - **closed**: calls flow; ``failure_threshold`` *consecutive*
      failures open the circuit.
    - **open**: calls raise :class:`CircuitOpen` instantly (no socket
      work, no timeout wait) until ``reset_timeout_s`` has elapsed.
    - **half-open**: up to ``half_open_probes`` in-flight probe calls
      are admitted; a probe success closes the circuit, a probe failure
      re-opens it (and restarts the cooldown).

    Thread-safe; the clock is injectable so open→half-open transitions
    are testable without waiting out a cooldown.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    #: numeric encoding for the metrics plane: a breaker-state *gauge*
    #: must be orderable (alert on > 0) — 0 closed, 1 half-open, 2 open
    STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(
        self,
        name: str = "",
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._open_count = 0  # lifetime open transitions (status page)
        self._probes_in_flight = 0

    @classmethod
    def from_env(
        cls,
        name: str,
        env: Optional[dict] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> "CircuitBreaker":
        env = os.environ if env is None else env
        return cls(
            name=name,
            failure_threshold=int(env.get("PIO_BREAKER_FAILURES", "5")),
            reset_timeout_s=float(env.get("PIO_BREAKER_RESET_S", "30")),
            half_open_probes=int(env.get("PIO_BREAKER_HALF_OPEN_PROBES", "1")),
            clock=clock,
        )

    # -- state machine ----------------------------------------------------
    def before_call(self) -> None:
        """Admission check; raises :class:`CircuitOpen` when the call
        must not be attempted. Admitted half-open calls are counted as
        probes until their success/failure is recorded."""
        with self._lock:
            if self._state == self.OPEN:
                elapsed = self._clock() - self._opened_at
                if elapsed < self.reset_timeout_s:
                    raise CircuitOpen(
                        f"circuit {self.name or '(anonymous)'} open; "
                        f"retry in {self.reset_timeout_s - elapsed:.1f}s",
                        retry_after_s=self.reset_timeout_s - elapsed,
                    )
                self._state = self.HALF_OPEN
                self._probes_in_flight = 0
            if self._state == self.HALF_OPEN:
                if self._probes_in_flight >= self.half_open_probes:
                    raise CircuitOpen(
                        f"circuit {self.name or '(anonymous)'} half-open; "
                        "probe already in flight",
                        retry_after_s=self.reset_timeout_s,
                    )
                self._probes_in_flight += 1

    def record_success(self) -> None:
        closed = False
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._state = self.CLOSED
                closed = True
            self._consecutive_failures = 0
        if closed:
            self._flight("closed")

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            if self._state == self.HALF_OPEN:
                # a failed probe re-opens immediately: the dependency is
                # still down, restart the cooldown
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
                self._trip()
                tripped = True
            else:
                self._consecutive_failures += 1
                if (
                    self._state == self.CLOSED
                    and self._consecutive_failures >= self.failure_threshold
                ):
                    self._trip()
                    tripped = True
        if tripped:
            self._flight("open")

    def _trip(self) -> None:  # caller holds the lock
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._open_count += 1
        self._consecutive_failures = 0

    def _flight(self, to_state: str) -> None:
        """Breaker transitions are exactly the events a post-mortem
        needs on the timeline — tap the process flight recorder,
        OUTSIDE the breaker lock, best-effort (a
        forensics fault must never affect the breaker)."""
        try:
            from ..obs.flight import record

            record(
                "breaker", f"breaker.{self.name or 'anonymous'}",
                state=to_state, opens=self._open_count,
            )
        except Exception:
            pass

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Run ``fn`` under the breaker: admission check, then outcome
        recording. One ``call`` is one logical operation — wrap the
        *whole* retried attempt in it, so a retry schedule that
        eventually succeeds counts as a success, not N-1 failures."""
        self.before_call()
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    # -- introspection ----------------------------------------------------
    @property
    def state(self) -> str:
        """Current state, with the open→half-open time transition applied
        (so a status page polled after the cooldown reads "half-open",
        matching what the next call would experience)."""
        with self._lock:
            if (
                self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s
            ):
                return self.HALF_OPEN
            return self._state

    @property
    def state_value(self) -> int:
        """:attr:`state` as its gauge encoding (0/1/2)."""
        return self.STATE_VALUES[self.state]

    @property
    def open_count(self) -> int:
        """Lifetime closed→open transitions (monotonic — exposed as the
        ``pio_breaker_opens`` gauge)."""
        with self._lock:
            return self._open_count

    def snapshot(self) -> dict:
        """Status-page JSON shape."""
        state = self.state
        with self._lock:
            out = {
                "state": state,
                "consecutiveFailures": self._consecutive_failures,
                "openCount": self._open_count,
            }
            if self._state == self.OPEN:
                out["retryAfterS"] = round(
                    max(
                        0.0,
                        self.reset_timeout_s
                        - (self._clock() - self._opened_at),
                    ),
                    3,
                )
            return out
