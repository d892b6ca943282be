"""Engine project registration.

Copy of ``predictionio_tpu/tools/register.py``, a rebuild of
``tools/.../RegisterEngine.scala:30-120`` plus the console's
``manifest.json`` keyed by a SHA-1 of the project directory
(``console/Console.scala:1017-1061``). "Build" means checking that the
engine factory imports; registration records the project directory in
the manifest so train and deploy can import it again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import List, Optional

from ..storage import EngineManifest, StorageRegistry
from ..utils.durability import atomic_write_bytes

logger = logging.getLogger(__name__)

MANIFEST_JSON = "manifest.json"
ENGINE_JSON = "engine.json"


class EngineDirError(Exception):
    """Missing/invalid engine.json or manifest (``Console.scala:1063-1077``)."""


@dataclasses.dataclass
class EngineDir:
    """A resolved engine project directory."""

    path: str
    manifest: EngineManifest
    variant: dict
    variant_path: str

    @property
    def engine_factory(self) -> str:
        factory = self.variant.get("engineFactory", "")
        if not factory:
            raise EngineDirError(
                f"{self.variant_path}: missing required key 'engineFactory'"
            )
        return factory


def _cwd_sha1(path: str) -> str:
    """``Console.scala:1027``: the manifest id is a SHA-1 of the project path."""
    return hashlib.sha1(os.path.abspath(path).encode("utf-8")).hexdigest()


def _source_version(path: str) -> str:
    """Version = digest of the engine's Python sources and engine.json, so
    a build after an edit gives a new version."""
    h = hashlib.sha1()
    names: List[str] = []
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__pycache__"))]
        for f in sorted(files):
            if f.endswith(".py") or f == ENGINE_JSON:
                names.append(os.path.join(root, f))
    for name in sorted(names):
        h.update(name.encode("utf-8"))
        with open(name, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12] or "0"


def load_engine_dir(path: str) -> EngineDir:
    """Resolve a project's manifest and variant without writing anything
    (train and eval call this on every run; only ``register_engine``
    writes)."""
    path = os.path.abspath(path)
    variant_path = os.path.join(path, ENGINE_JSON)
    if not os.path.exists(variant_path):
        raise EngineDirError(f"{variant_path} not found; not an engine project?")
    with open(variant_path, "r", encoding="utf-8") as fh:
        variant = json.load(fh)
    manifest = EngineManifest(
        id=_cwd_sha1(path),
        version=_source_version(path),
        name=os.path.basename(path),
        description=variant.get("description", ""),
        files=[path],
        engine_factory=variant.get("engineFactory", ""),
    )
    return EngineDir(path=path, manifest=manifest, variant=variant,
                     variant_path=variant_path)


def _write_manifest(ed: EngineDir) -> EngineManifest:
    m = ed.manifest
    body = {"id": m.id, "version": m.version, "name": m.name,
            "description": m.description, "files": list(m.files),
            "engineFactory": m.engine_factory}
    atomic_write_bytes(os.path.join(ed.path, MANIFEST_JSON),
                       json.dumps(body, indent=2).encode("utf-8"))
    return m


def generate_manifest(path: str) -> EngineManifest:
    """Regenerate ``manifest.json`` on disk (``Console.scala:1019-1061``)."""
    return _write_manifest(load_engine_dir(path))


def register_engine(registry: StorageRegistry, path: str,
                    verify_import: bool = True) -> EngineDir:
    """``pio build``: check that the factory imports, upsert the manifest
    (``RegisterEngine.registerEngine``, ``RegisterEngine.scala:46-120``)."""
    ed = load_engine_dir(path)
    _write_manifest(ed)
    if verify_import:
        from ..workflow.loader import get_engine

        get_engine(ed.engine_factory, search_dir=ed.path)
        logger.info("Engine factory %s imports cleanly", ed.engine_factory)
    registry.get_metadata().manifest_update(ed.manifest, upsert=True)
    logger.info("Registered engine %s %s (%s)", ed.manifest.id, ed.manifest.version, ed.path)
    return ed


def registered_manifest(registry: StorageRegistry, path: str) -> Optional[EngineManifest]:
    """``Console.withRegisteredManifest`` lookup (``Console.scala:1079-1100``)."""
    ed = load_engine_dir(path)
    return registry.get_metadata().manifest_get(ed.manifest.id, ed.manifest.version)
