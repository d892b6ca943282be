"""DASE controller API of the port."""

from .dase import (
    Algorithm,
    Controller,
    DataSource,
    FirstServing,
    Preparator,
    Serving,
    doer,
    run_sanity_check,
)
from .engine import (
    Engine,
    EngineParams,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
    serialize_engine_params,
)
from .params import EmptyParams, Params, ParamsError, extract_params, params_to_json

__all__ = [
    "Algorithm",
    "Controller",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "FirstServing",
    "Params",
    "ParamsError",
    "Preparator",
    "Serving",
    "StopAfterPrepareInterruption",
    "StopAfterReadInterruption",
    "WorkflowParams",
    "doer",
    "extract_params",
    "params_to_json",
    "run_sanity_check",
    "serialize_engine_params",
]
