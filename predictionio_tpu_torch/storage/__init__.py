"""Storage plane of the port: the event model and event stores (SQLite
and the native C++ log), id maps, app/access-key, manifest, engine- and
evaluation-instance metadata, model blobs and the environment-driven
registry."""

from .aggregator import aggregate_properties, aggregate_single
from .bimap import BiMap, IdsLike
from .data_map import DataMap, DataMapException, PropertyMap
from .event import Event, EventValidationError, validate_event
from .events import EventFilter, EventStore
from .metadata import (
    STATUS_COMPLETED,
    STATUS_EVALCOMPLETED,
    STATUS_EVALUATING,
    STATUS_INIT,
    STATUS_TRAINING,
    AccessKey,
    App,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    MetadataStore,
    new_engine_instance,
    utcnow,
)
from .model_store import LocalFSModelStore, Model, ModelStore, SqliteModelStore
from .native_events import NativeEventStore, NativeScanUnsupported
from .registry import StorageError, StorageRegistry, base_dir, get_registry
from .sqlite_events import SqliteEventStore, make_event_id

__all__ = [
    "AccessKey",
    "App",
    "BiMap",
    "DataMap",
    "DataMapException",
    "EngineInstance",
    "EngineManifest",
    "EvaluationInstance",
    "Event",
    "EventFilter",
    "EventStore",
    "EventValidationError",
    "IdsLike",
    "LocalFSModelStore",
    "MetadataStore",
    "Model",
    "ModelStore",
    "NativeEventStore",
    "NativeScanUnsupported",
    "PropertyMap",
    "STATUS_COMPLETED",
    "STATUS_EVALCOMPLETED",
    "STATUS_EVALUATING",
    "STATUS_INIT",
    "STATUS_TRAINING",
    "SqliteEventStore",
    "SqliteModelStore",
    "StorageError",
    "StorageRegistry",
    "aggregate_properties",
    "aggregate_single",
    "base_dir",
    "get_registry",
    "make_event_id",
    "new_engine_instance",
    "utcnow",
    "validate_event",
]
