"""Always-on flight recorder and stall watchdog: post-mortem forensics.

Copy of ``predictionio_tpu/obs/flight.py``:

1. :class:`FlightRecorder` — a bounded ring of structured events (breaker
   opens and closes, deploys and reloads, alert fires, stalls) tagged
   with the ambient trace id. An append is one ``deque.append``, so the
   recorder stays armed in production; disabled (``PIO_FLIGHT=0``) it
   touches no clock. The ring dumps on demand (``GET /blackbox.json``,
   ``pio blackbox``), on a stall, and at process death: :func:`arm`
   installs an atexit dump, ``faulthandler`` and, for the server entry
   points, a SIGTERM dump that chains to the handler it replaces.
2. :class:`StallWatchdog` — an in-flight request that has outlived a
   multiple of its deadline budget, or a watched loop that stopped
   beating, is a stall: it counts ``pio_stall_detected_total{site}``,
   records a flight event and dumps the ring under ``PIO_FLIGHT_DIR``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from .trace import current_context

__all__ = [
    "FLIGHT_ENV",
    "FLIGHT_DIR_ENV",
    "FlightRecorder",
    "StallWatchdog",
    "arm",
    "default_recorder",
    "load_dump",
    "record",
    "write_dump",
]

#: set to "0" to disable the process flight recorder entirely
FLIGHT_ENV = "PIO_FLIGHT"

#: directory crash/stall dumps land in (unset = no durable dumps)
FLIGHT_DIR_ENV = "PIO_FLIGHT_DIR"

#: ring capacity — one screenful of history per subsystem at typical
#: transition rates, bounded regardless of uptime
DEFAULT_CAPACITY = 2048

DUMP_SCHEMA = 1


def _env_enabled() -> bool:
    return os.environ.get(FLIGHT_ENV, "1") != "0"


class FlightRecorder:
    """Bounded append-only ring of structured events.

    ``record`` relies on ``deque.append`` with a ``maxlen`` being atomic
    under the GIL — the hot path takes no lock, so an event from inside
    a breaker transition (recorded while the breaker's own lock is
    held) can never deadlock against a concurrent dump. ``dump`` reads
    a snapshot copy.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        enabled: Optional[bool] = None,
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
    ):
        self.enabled = _env_enabled() if enabled is None else enabled
        self.clock = clock
        self.wall = wall
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0  # approximate: ring length is the honest bound

    def record(self, kind: str, site: str, **details) -> None:
        """Append one event. Disabled, this is ONE attribute check and a
        return — no clock read, no allocation beyond the call frame."""
        if not self.enabled:
            return
        ctx = current_context()
        self._ring.append(
            {
                "t": self.clock(),
                "wall": self.wall(),
                "kind": kind,
                "site": site,
                "trace": ctx.trace_id if ctx is not None else None,
                "details": details or None,
            }
        )

    def dump(self) -> List[dict]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    def dump_to(self, path: str, reason: str = "on-demand") -> str:
        """Durable dump of the ring (see :func:`write_dump`)."""
        return write_dump(path, self.dump(), reason, at=self.wall())


def write_dump(
    path: str, events, reason: str, at: Optional[float] = None
) -> str:
    """THE flight-dump file format — header line + one JSONL line per
    event, fsynced (the evidence-ledger discipline: a dump a crash can
    tear is not a flight recorder). One owner: the recorder's own
    dumps, the watchdog's stall dumps and ``pio blackbox dump --out``
    all write through here, so the schema can never fork."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(
            json.dumps(
                {
                    "schema": DUMP_SCHEMA,
                    "kind": "flight-dump",
                    "reason": reason,
                    "pid": os.getpid(),
                    "events": len(events),
                    "at": time.time() if at is None else at,
                },
                sort_keys=True,
            )
            + "\n"
        )
        for event in events:
            fh.write(json.dumps(event, sort_keys=True, default=str) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    return path


def load_dump(path: str) -> Optional[dict]:
    """A dump file → ``{"header": ..., "events": [...]}``; torn lines
    are skipped, a missing/foreign file is None, never a traceback."""
    header: Optional[dict] = None
    events: List[dict] = []
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
                if not isinstance(parsed, dict):
                    continue
                if parsed.get("kind") == "flight-dump":
                    header = parsed
                else:
                    events.append(parsed)
    except OSError:
        return None
    if header is None and not events:
        return None
    return {"header": header or {}, "events": events}


# -- process-wide default ------------------------------------------------------

_default_lock = threading.Lock()
_default: Optional[FlightRecorder] = None


def default_recorder() -> FlightRecorder:
    """The process flight recorder: every subsystem records into one
    ring, so a dump interleaves breaker opens, rollout transitions and
    alert fires on one timeline — which is the whole point."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def record(kind: str, site: str, **details) -> None:
    """Record into the process recorder (the convenience every tap
    uses; a recorder fault must never take down the recording site)."""
    try:
        default_recorder().record(kind, site, **details)
    except Exception:
        pass


_armed = False


def arm(
    dump_dir: Optional[str] = None, signals: bool = False
) -> Optional[str]:
    """Arm the crash path: an atexit dump of the process recorder into
    ``dump_dir`` (default ``PIO_FLIGHT_DIR``; None = disarmed) plus
    ``faulthandler`` into ``<dir>/faulthandler-<pid>.txt`` so a hard
    crash leaves both the interpreter stacks and the event timeline.
    ``signals=True`` additionally dumps on SIGTERM, calls the handler
    it replaced (when that is a function) and then re-raises the signal
    under the default action — only the server entry points set it (a
    library import must never steal signal dispositions). Idempotent."""
    global _armed
    directory = dump_dir or os.environ.get(FLIGHT_DIR_ENV)
    if not directory:
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"flight-{os.getpid()}.jsonl")
    with _default_lock:
        if _armed:
            return path
        _armed = True
    import atexit

    recorder = default_recorder()
    atexit.register(
        lambda: _safe_dump(recorder, path, "atexit")
    )
    try:
        import faulthandler

        fh_path = os.path.join(
            directory, f"faulthandler-{os.getpid()}.txt"
        )
        _fh_file = open(fh_path, "w")  # held open for process lifetime
        faulthandler.enable(file=_fh_file)
    except (OSError, RuntimeError):
        pass
    if signals:
        import signal as _signal

        try:
            previous = _signal.getsignal(_signal.SIGTERM)

            def on_term(signum, frame):
                _safe_dump(recorder, path, f"signal-{signum}")
                # chain: a handler the process installed before keeps
                # its say; the default action (or a handler that
                # returns) still ends the process
                if callable(previous):
                    previous(signum, frame)
                _signal.signal(signum, _signal.SIG_DFL)
                _signal.raise_signal(signum)

            _signal.signal(_signal.SIGTERM, on_term)
        except (ValueError, OSError):
            pass  # non-main thread / platform without SIGTERM
    return path


def _safe_dump(recorder: FlightRecorder, path: str, reason: str) -> None:
    try:
        recorder.dump_to(path, reason=reason)
    except Exception:
        pass


# -- stall watchdog -----------------------------------------------------------

#: default budget for a tracked request that carries no deadline
DEFAULT_BUDGET_S = 10.0


class StallWatchdog:
    """Detects wedged requests and wedged subsystem ticks.

    Request path: :meth:`enter`/:meth:`exit` bracket each in-flight
    request with its deadline budget; a request still in flight after
    ``stall_factor x budget`` is a stall. Subsystem path: loops declare
    themselves with :meth:`expect` and call :meth:`beat` every
    iteration; a beat older than the declared gap is a stall.

    :meth:`check` (called by the health ticker, or directly by drills
    on injected clocks) fires each NEW stall once — counter + flight
    event + a durable ring dump naming the site — and records recovery
    when the condition goes away, so a transient wedge leaves a
    complete fire/recover timeline."""

    def __init__(
        self,
        metrics,
        clock: Callable[[], float] = time.monotonic,
        flight: Optional[FlightRecorder] = None,
        stall_factor: float = 4.0,
        min_stall_s: float = 1.0,
        dump_dir: Optional[str] = None,
    ):
        self.clock = clock
        self.flight = flight
        self.stall_factor = stall_factor
        self.min_stall_s = min_stall_s
        self._dump_dir = dump_dir
        self._lock = threading.Lock()
        self._inflight: Dict[int, tuple] = {}  # token -> (site, t0, budget)
        self._next_token = 0
        self._beats: Dict[str, float] = {}
        self._expected: Dict[str, float] = {}  # site -> max gap
        self._flagged: Dict[str, float] = {}  # site -> stall-detected t
        self._stalls_total = 0
        self._last_dump: Optional[str] = None
        self._stalls = metrics.counter(
            "pio_stall_detected_total",
            "Stalls detected by the watchdog, by site",
            labelnames=("site",),
        )
        metrics.gauge_callback(
            "pio_stall_inflight",
            self._inflight_count,
            "Requests currently tracked by the stall watchdog",
        )

    # -- request tracking --------------------------------------------------
    def enter(self, site: str, budget_s: Optional[float] = None) -> int:
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._inflight[token] = (
                site,
                self.clock(),
                budget_s if budget_s and budget_s > 0 else DEFAULT_BUDGET_S,
            )
            return token

    def exit(self, token: int) -> None:
        with self._lock:
            self._inflight.pop(token, None)

    def _inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    # -- subsystem heartbeats ----------------------------------------------
    def expect(self, site: str, max_gap_s: float) -> None:
        """Declare a watched loop; the declaration time counts as the
        first beat (a loop that never runs at all must still stall)."""
        with self._lock:
            self._expected[site] = max_gap_s
            self._beats.setdefault(site, self.clock())

    def unexpect(self, site: str) -> None:
        with self._lock:
            self._expected.pop(site, None)
            self._beats.pop(site, None)
            self._flagged.pop(site, None)

    def beat(self, site: str) -> None:
        with self._lock:
            self._beats[site] = self.clock()

    # -- detection ---------------------------------------------------------
    def check(self) -> List[dict]:
        """One detection round; returns the stalls NEWLY fired."""
        now = self.clock()
        fired: List[dict] = []
        with self._lock:
            stalled_sites: Dict[str, dict] = {}
            for site, t0, budget in self._inflight.values():
                bar = max(self.min_stall_s, self.stall_factor * budget)
                elapsed = now - t0
                if elapsed > bar:
                    info = stalled_sites.setdefault(
                        site,
                        {"site": site, "stallKind": "request",
                         "worstElapsedS": 0.0, "count": 0},
                    )
                    info["count"] += 1
                    info["worstElapsedS"] = max(
                        info["worstElapsedS"], round(elapsed, 3)
                    )
            for site, max_gap in self._expected.items():
                age = now - self._beats.get(site, now)
                if age > max_gap:
                    stalled_sites[site] = {
                        "site": site, "stallKind": "tick",
                        "beatAgeS": round(age, 3),
                        "maxGapS": max_gap,
                    }
            new = [
                info
                for site, info in stalled_sites.items()
                if site not in self._flagged
            ]
            for info in new:
                self._flagged[info["site"]] = now
                self._stalls_total += 1
            recovered = [
                site for site in self._flagged if site not in stalled_sites
            ]
            for site in recovered:
                del self._flagged[site]
        for info in new:
            fired.append(info)
            # site is a closed code-defined vocabulary (serving.request,
            # continuous.tick, replica.tail, ...), never request data
            self._stalls.inc(1, site=info["site"])
            if self.flight is not None:
                self.flight.record("stall", info["site"], **{
                    k: v for k, v in info.items() if k != "site"
                })
                self._dump_for(info["site"])
        for site in recovered:
            if self.flight is not None:
                self.flight.record("stall-recovered", site)
        return fired

    def _dump_for(self, site: str) -> None:
        directory = self._dump_dir or os.environ.get(FLIGHT_DIR_ENV)
        if not directory or self.flight is None:
            return
        safe = "".join(
            c if c.isalnum() or c in "._-" else "_" for c in site
        )
        path = os.path.join(
            directory, f"stall-{safe}-{os.getpid()}.jsonl"
        )
        try:
            self.flight.dump_to(path, reason=f"stall:{site}")
            self._last_dump = path
        except OSError:
            pass  # a read-only dir degrades to in-memory forensics

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            return {
                "detected": self._stalls_total,
                "active": sorted(self._flagged),
                "inflight": len(self._inflight),
                "watched": sorted(self._expected),
                "lastDump": self._last_dump,
            }
