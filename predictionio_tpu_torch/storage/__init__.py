"""Storage plane of the port: id maps, engine-instance metadata, model
blobs and the environment-driven registry (deploy side only)."""

from .bimap import BiMap, IdsLike
from .metadata import (
    STATUS_COMPLETED,
    STATUS_EVALCOMPLETED,
    STATUS_EVALUATING,
    STATUS_INIT,
    STATUS_TRAINING,
    EngineInstance,
    MetadataStore,
    new_engine_instance,
    utcnow,
)
from .model_store import LocalFSModelStore, Model, ModelStore, SqliteModelStore
from .registry import StorageError, StorageRegistry, base_dir, get_registry

__all__ = [
    "BiMap",
    "EngineInstance",
    "IdsLike",
    "LocalFSModelStore",
    "MetadataStore",
    "Model",
    "ModelStore",
    "STATUS_COMPLETED",
    "STATUS_EVALCOMPLETED",
    "STATUS_EVALUATING",
    "STATUS_INIT",
    "STATUS_TRAINING",
    "SqliteModelStore",
    "StorageError",
    "StorageRegistry",
    "base_dir",
    "get_registry",
    "new_engine_instance",
    "utcnow",
]
