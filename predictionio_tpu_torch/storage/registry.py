"""Storage registry: environment-driven backend wiring.

Trimmed copy of ``predictionio_tpu/storage/registry.py`` — the event,
metadata and model repositories, read from the same variables:
``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ ``_PATH``) declares a source and
``PIO_STORAGE_REPOSITORIES_{EVENTDATA,METADATA,MODELDATA}_SOURCE`` binds
a repository to it. Source types: ``sqlite`` and ``localfs`` (events in
``events.db``), ``memory``, and ``native`` (events only: the C++ event
log under ``<path>/events_native``), and ``remote`` (all three over a
storage primary's HTTP API, ``_URL`` or ``_HOST``/``_PORT``:
``storage/remote.py``). With no configuration a single SQLite source
under ``$PIO_FS_BASEDIR`` (default ``~/.predictionio_tpu``) backs all
three, so the port reads and writes the same files as the JAX package.
The partitioned and high-availability remote sets wait (ROADMAP.md queue
1 item 12).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Callable, Dict, Optional

from .events import EventStore
from .metadata import MetadataStore
from .model_store import LocalFSModelStore, ModelStore, SqliteModelStore
from .sqlite_events import SqliteEventStore

_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_TYPE$")

REPO_METADATA = "METADATA"
REPO_MODELDATA = "MODELDATA"
REPO_EVENTDATA = "EVENTDATA"


class StorageError(Exception):
    """Configuration or client-construction failure (``Storage.scala:61``)."""


def base_dir(env: Optional[Dict[str, str]] = None) -> str:
    e = env if env is not None else os.environ
    return e.get(
        "PIO_FS_BASEDIR", os.path.join(os.path.expanduser("~"), ".predictionio_tpu")
    )


def _sqlite_metadata(root: str) -> MetadataStore:
    return MetadataStore(os.path.join(root, "metadata.db"))


def _sqlite_events(root: str) -> EventStore:
    return SqliteEventStore(os.path.join(root, "events.db"))


def _native_events(root: str) -> EventStore:
    from .native_events import NativeEventStore

    return NativeEventStore(os.path.join(root, "events_native"))


#: per source type, the store factory of each repository kind, over the
#: source's root directory (the JAX package's file layout)
_FAMILIES: Dict[str, Dict[str, Callable[[str], object]]] = {
    "sqlite": {
        "events": _sqlite_events,
        "metadata": _sqlite_metadata,
        "models": lambda root: SqliteModelStore(os.path.join(root, "models.db")),
    },
    "localfs": {
        "events": _sqlite_events,
        "metadata": _sqlite_metadata,
        "models": lambda root: LocalFSModelStore(os.path.join(root, "models")),
    },
    "memory": {
        "events": lambda root: SqliteEventStore(":memory:"),
        "metadata": lambda root: MetadataStore(":memory:"),
        "models": lambda root: SqliteModelStore(":memory:"),
    },
    "native": {"events": _native_events},
}


class StorageRegistry:
    """Lazily-constructed, cached storage clients keyed by source name."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        self._env = dict(env) if env is not None else dict(os.environ)
        self._lock = threading.RLock()
        self._event_stores: Dict[str, EventStore] = {}
        self._metadata_stores: Dict[str, MetadataStore] = {}
        self._model_stores: Dict[str, ModelStore] = {}
        self._sources = self._parse_sources()

    def _parse_sources(self) -> Dict[str, Dict[str, str]]:
        sources: Dict[str, Dict[str, str]] = {}
        for key in self._env:
            m = _SOURCE_RE.match(key)
            if not m:
                continue
            name = m.group(1)
            prefix = f"PIO_STORAGE_SOURCES_{name}_"
            sources[name] = {
                k[len(prefix):].lower(): v
                for k, v in self._env.items()
                if k.startswith(prefix)
            }
        if not sources:
            sources["LOCAL"] = {"type": "sqlite", "path": base_dir(self._env)}
        return sources

    def _repo_source_name(self, repo: str) -> str:
        name = self._env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
        if name is None:
            if len(self._sources) == 1:
                return next(iter(self._sources))
            raise StorageError(
                f"Repository {repo} has no PIO_STORAGE_REPOSITORIES_{repo}_SOURCE "
                f"and multiple sources are configured: {sorted(self._sources)}"
            )
        if name not in self._sources:
            raise StorageError(
                f"Repository {repo} references undefined source {name!r} "
                f"(defined: {sorted(self._sources)})"
            )
        return name

    def _get_store(self, repo: str, kind: str, cache: Dict[str, object]):
        name = self._repo_source_name(repo)
        with self._lock:
            if name not in cache:
                conf = self._sources[name]
                stype = conf.get("type", "sqlite")
                if stype == "remote":
                    # imported on first use: the HTTP client is the
                    # remote family's alone
                    from . import remote

                    cache[name] = remote.FAMILY[kind](remote.base_url(conf))
                    return cache[name]
                family = _FAMILIES.get(stype)
                if family is None:
                    raise StorageError(
                        f"source {name}: storage type {stype!r} is not "
                        f"available in the port (have {sorted([*_FAMILIES, 'remote'])})"
                    )
                if kind not in family:
                    raise StorageError(
                        f"source {name}: storage type {stype!r} holds no "
                        f"{kind} repository"
                    )
                cache[name] = family[kind](
                    conf.get("path") or base_dir(self._env)
                )
            return cache[name]

    def get_events(self) -> EventStore:
        return self._get_store(REPO_EVENTDATA, "events", self._event_stores)

    def get_metadata(self) -> MetadataStore:
        return self._get_store(REPO_METADATA, "metadata", self._metadata_stores)

    def get_models(self) -> ModelStore:
        return self._get_store(REPO_MODELDATA, "models", self._model_stores)


_default_registry: Optional[StorageRegistry] = None
_default_lock = threading.Lock()


def get_registry(refresh: bool = False) -> StorageRegistry:
    """Process-wide registry built from ``os.environ`` (``Storage``
    object); ``refresh=True`` rebuilds it from the current environment."""
    global _default_registry
    with _default_lock:
        if _default_registry is None or refresh:
            _default_registry = StorageRegistry()
        return _default_registry
