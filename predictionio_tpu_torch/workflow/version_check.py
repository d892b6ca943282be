"""Upgrade check: the ``UpgradeCheckRunner`` analogue, opt-in.

Copy of ``predictionio_tpu/workflow/version_check.py``. The reference
fires a background thread from every train/eval/deploy/build that
fetches ``<host>/<version>/<component>.json`` and ignores the result
(``core/src/main/scala/io/prediction/workflow/WorkflowUtils.scala:392-413``,
invoked from ``CoreWorkflow.scala:51,108``). Here, when the version index
answers with a newer release, an INFO line says so; every failure (no
network, 404, bad JSON, a slow host) is a DEBUG line at most, and the
caller never waits (daemon thread, short timeout).

The check is **opt-in**: it runs only when ``PIO_VERSIONS_HOST`` names
an index the operator controls (the reference's hard-coded host belongs
to a defunct project), and ``PIO_NO_UPGRADE_CHECK=1`` disables it even
then. With neither set, no request is made.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.request
from typing import Optional, Tuple

log = logging.getLogger(__name__)

_TIMEOUT_S = 3.0
#: the index is a tiny JSON document: never buffer a large body
_MAX_BODY = 1 << 16


def _parse_version(v: str) -> Optional[Tuple[int, ...]]:
    """Dotted version → int tuple; None when unparseable (a pre-release
    tag compares as its numeric prefix: "0.9.2-SNAPSHOT" → (0, 9, 2))."""
    parts = []
    for piece in str(v).split("."):
        digits = ""
        for ch in piece:
            if not ch.isdigit():
                break
            digits += ch
        if not digits:
            break
        parts.append(int(digits))
    return tuple(parts) if parts else None


def check_url(component: str, engine: str = "", version: str = "",
              host: str = "") -> str:
    """The reference's URL scheme (``WorkflowUtils.scala:399-404``)."""
    if not version:
        from .. import __version__ as version
    host = (host or os.environ.get("PIO_VERSIONS_HOST", "")).rstrip("/")
    if engine:
        return f"{host}/{version}/{component}/{engine}.json"
    return f"{host}/{version}/{component}.json"


def _run_check(component: str, engine: str) -> Optional[str]:
    """Fetch and compare. Returns the newer version when the index
    advertises one, else None. Never raises."""
    from .. import __version__

    url = check_url(component, engine, __version__)
    try:
        with urllib.request.urlopen(url, timeout=_TIMEOUT_S) as resp:
            data = json.loads(resp.read(_MAX_BODY).decode("utf-8"))
    except Exception as exc:  # any failure: a debug line, nothing more
        log.debug("upgrade metainfo not available (%s): %s", url, exc)
        return None
    latest = data.get("version") if isinstance(data, dict) else None
    if not latest:
        return None
    # printable ASCII only, clamped, before it reaches a log line
    latest = "".join(ch for ch in str(latest)[:64] if ch.isprintable() and ord(ch) < 128)
    cur, new = _parse_version(__version__), _parse_version(latest)
    if cur is not None and new is not None and new > cur:
        log.info("A newer version %s is available (running %s) — component %s",
                 latest, __version__, component or "core")
        return latest
    return None


def check_upgrade(component: str = "core", engine: str = "") -> Optional[threading.Thread]:
    """Fire-and-forget upgrade check (``WorkflowUtils.checkUpgrade``).

    Returns the daemon thread (tests join it), or None when skipped: no
    ``PIO_VERSIONS_HOST``, or ``PIO_NO_UPGRADE_CHECK=1``."""
    if os.environ.get("PIO_NO_UPGRADE_CHECK") == "1":
        return None
    if not os.environ.get("PIO_VERSIONS_HOST"):
        return None
    t = threading.Thread(target=_run_check, args=(component, engine),
                         name="pio-upgrade-check", daemon=True)
    t.start()
    return t
