"""Workflow runtime of the port: context, the training infeed, the
train and evaluation workflows, model persistence, the micro-batcher and
the query server."""

from .context import WorkflowContext, pio_env_vars
from .core_workflow import (
    ForeignModelError,
    load_models,
    persist_instance,
    run_evaluation,
    run_train,
)
from .infeed import RatingBatch, StreamingIndexer, stream_ratings
from .serving import (
    Deployment,
    QueryServer,
    ServerConfig,
    create_query_server,
    prepare_deployment,
)

__all__ = [
    "Deployment",
    "ForeignModelError",
    "QueryServer",
    "RatingBatch",
    "ServerConfig",
    "StreamingIndexer",
    "WorkflowContext",
    "create_query_server",
    "load_models",
    "persist_instance",
    "pio_env_vars",
    "prepare_deployment",
    "run_evaluation",
    "run_train",
    "stream_ratings",
]
