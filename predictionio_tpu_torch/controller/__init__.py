"""DASE controller API of the port (deploy side)."""

from .dase import (
    Algorithm,
    Controller,
    DataSource,
    FirstServing,
    Preparator,
    Serving,
    doer,
)
from .engine import Engine, EngineParams, serialize_engine_params
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
    "doer",
    "extract_params",
    "params_to_json",
    "serialize_engine_params",
]
