"""JSON wire codec for metadata records.

Copy of ``predictionio_tpu/storage/wire.py``: the remote storage family
(``storage/remote.py`` ↔ ``storage/storage_server.py``) ships
MetadataStore arguments and results as JSON, and the changefeed logs
metadata mutations the same way. One generic dataclass codec covers all
record types: a tagged envelope ``{"__dc__": "EngineInstance",
...fields}`` for dataclasses and ``{"__dt__": iso8601}`` for datetimes,
everything else plain JSON. The record names are the JAX package's, so
either package decodes what the other encoded.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Dict, Type

from .metadata import (
    AccessKey,
    App,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    RolloutPlan,
)

_RECORD_TYPES: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (App, AccessKey, EngineManifest, EngineInstance, EvaluationInstance,
                RolloutPlan)
}


def encode(obj: Any) -> Any:
    """Python value → JSON-safe value."""
    if dataclasses.is_dataclass(obj) and type(obj).__name__ in _RECORD_TYPES:
        out = {"__dc__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = encode(getattr(obj, f.name))
        return out
    if isinstance(obj, _dt.datetime):
        return {"__dt__": obj.isoformat()}
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    return obj


def decode(obj: Any) -> Any:
    """JSON value → Python value (inverse of :func:`encode`)."""
    if isinstance(obj, dict):
        if "__dt__" in obj and len(obj) == 1:
            return _dt.datetime.fromisoformat(obj["__dt__"])
        if "__dc__" in obj:
            cls = _RECORD_TYPES[obj["__dc__"]]
            # sequence fields (AccessKey.events, EngineManifest.files) come
            # back as lists; the dataclasses accept any Sequence
            return cls(**{k: decode(v) for k, v in obj.items() if k != "__dc__"})
        return {k: decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    return obj
