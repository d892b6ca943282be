"""Workflow runtime of the port: context, the train workflow, model
persistence, the micro-batcher and the query server."""

from .context import WorkflowContext, pio_env_vars
from .core_workflow import ForeignModelError, load_models, persist_instance, run_train
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
    "ServerConfig",
    "WorkflowContext",
    "create_query_server",
    "load_models",
    "persist_instance",
    "pio_env_vars",
    "prepare_deployment",
    "run_train",
]
