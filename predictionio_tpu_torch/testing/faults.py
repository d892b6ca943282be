"""Deterministic fault injection for the online data plane.

Copy of ``predictionio_tpu/testing/faults.py``. Production code marks
its I/O boundaries with :func:`fault_point` (a ``None`` check when no
plan is active); a test, or a live server started with ``PIO_FAULTS``,
activates a plan that makes those boundaries fail in scripted ways:

- ``refuse``       raise ``ConnectionRefusedError``
- ``close``        raise ``http.client.RemoteDisconnected``
- ``reset``        raise ``ConnectionResetError``
- ``latency:<ms>`` wait ``<ms>`` through the injectable ``sleep``

Each kind takes an optional ``*N``: fire on the first N hits, then stop
(N failures, then ok). ``PIO_FAULTS="serving.feedback=refuse*3"`` is the
environment's syntax. The port's sites: ``serving.feedback`` (query
server → Event Server), ``serving.error_log`` (→ ``--log-url``) and
``serving.predict`` (just before the batched dispatch). No randomness,
no wall-clock reads.
"""

from __future__ import annotations

import dataclasses
import http.client
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "FaultSpec",
    "FaultInjector",
    "activate",
    "deactivate",
    "active",
    "fault_point",
    "inject",
    "parse",
]

_KINDS = ("refuse", "close", "reset", "latency")


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault: fire ``kind`` at ``site``, ``times`` times
    (``None`` = every hit). ``when`` optionally filters on the call
    site's keyword info (e.g. only non-fresh connections)."""

    site: str
    kind: str
    arg: float = 0.0  # latency ms for kind="latency"
    times: Optional[int] = None
    when: Optional[Callable[[Dict[str, Any]], bool]] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {_KINDS}"
            )


def parse(text: str) -> List[FaultSpec]:
    """``site=kind[:arg][*times][;site=kind...]`` → specs. The format of
    ``PIO_FAULTS`` and ``loadgen --fault``."""
    specs: List[FaultSpec] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        try:
            site, rhs = chunk.split("=", 1)
        except ValueError:
            raise ValueError(
                f"bad fault spec {chunk!r}: expected site=kind[:arg][*times]"
            ) from None
        times: Optional[int] = None
        if "*" in rhs:
            rhs, times_s = rhs.rsplit("*", 1)
            times = int(times_s)
        arg = 0.0
        if ":" in rhs:
            rhs, arg_s = rhs.split(":", 1)
            arg = float(arg_s)
        specs.append(
            FaultSpec(site=site.strip(), kind=rhs.strip(), arg=arg,
                      times=times)
        )
    return specs


class FaultInjector:
    """The active fault plan: matches sites, counts hits, fires faults."""

    def __init__(
        self,
        specs: Sequence[FaultSpec],
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._specs = list(specs)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._fired: Dict[int, int] = {}  # spec index -> times fired
        self._hits: Dict[str, int] = {}  # site -> times reached (any spec)

    def fired(self, site: Optional[str] = None) -> int:
        """How many faults actually fired (optionally at one site)."""
        with self._lock:
            if site is None:
                return sum(self._fired.values())
            return sum(
                count
                for idx, count in self._fired.items()
                if self._specs[idx].site == site
            )

    def hits(self, site: str) -> int:
        """How many times ``site`` was reached while this plan was
        active (fired or not) — the 'did production code actually route
        through the harness' assertion."""
        with self._lock:
            return self._hits.get(site, 0)

    def fire(self, site: str, info: Dict[str, Any]) -> None:
        to_fire: Optional[FaultSpec] = None
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            for idx, spec in enumerate(self._specs):
                if spec.site != site:
                    continue
                if spec.when is not None and not spec.when(info):
                    continue
                if (
                    spec.times is not None
                    and self._fired.get(idx, 0) >= spec.times
                ):
                    continue  # budget exhausted: N-failures-then-ok
                self._fired[idx] = self._fired.get(idx, 0) + 1
                to_fire = spec
                break
        if to_fire is None:
            return
        if to_fire.kind == "refuse":
            raise ConnectionRefusedError(
                f"[injected] connection refused at {site}"
            )
        if to_fire.kind == "close":
            raise http.client.RemoteDisconnected(
                f"[injected] server closed connection at {site}"
            )
        if to_fire.kind == "reset":
            raise ConnectionResetError(f"[injected] connection reset at {site}")
        if to_fire.kind == "latency":
            self._sleep(to_fire.arg / 1000.0)


# -- module-level activation --------------------------------------------------

_injector: Optional[FaultInjector] = None
_activation_lock = threading.Lock()


def activate(
    *specs: FaultSpec, sleep: Callable[[float], None] = time.sleep
) -> FaultInjector:
    """Install a fault plan process-wide (replacing any active one)."""
    global _injector
    with _activation_lock:
        _injector = FaultInjector(specs, sleep=sleep)
        return _injector


def deactivate() -> None:
    global _injector
    with _activation_lock:
        _injector = None


def active() -> Optional[FaultInjector]:
    return _injector


def fault_point(site: str, **info: Any) -> None:
    """The production-side hook: a no-op unless a plan is active.

    Placed at I/O boundaries so an injected ``ConnectionRefusedError``
    (etc.) flows through exactly the ``except`` clauses a real one
    would."""
    injector = _injector
    if injector is not None:
        injector.fire(site, info)


class inject:
    """``with faults.inject(spec, ...) as plan:`` — scoped activation."""

    def __init__(
        self, *specs: FaultSpec, sleep: Callable[[float], None] = time.sleep
    ):
        self._specs = specs
        self._sleep = sleep
        self.plan: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        self.plan = activate(*self._specs, sleep=self._sleep)
        return self.plan

    def __exit__(self, *exc: Any) -> None:
        deactivate()


def _install_from_env() -> None:
    """Env activation for live servers: ``PIO_FAULTS`` set in a server's
    environment arms the harness at import time."""
    text = os.environ.get("PIO_FAULTS", "")
    if text:
        activate(*parse(text))


_install_from_env()
