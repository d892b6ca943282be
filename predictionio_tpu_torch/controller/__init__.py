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
from .evaluation import EngineParamsGenerator, Evaluation
from .fast_eval import FastEvalEngine
from .metrics import (
    AverageMetric,
    Metric,
    MetricEvaluator,
    MetricEvaluatorResult,
    MetricScores,
    OptionAverageMetric,
    SumMetric,
    ZeroMetric,
)
from .params import EmptyParams, Params, ParamsError, extract_params, params_to_json

__all__ = [
    "Algorithm",
    "AverageMetric",
    "Controller",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "EngineParamsGenerator",
    "Evaluation",
    "FastEvalEngine",
    "FirstServing",
    "Metric",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "MetricScores",
    "OptionAverageMetric",
    "Params",
    "ParamsError",
    "Preparator",
    "Serving",
    "StopAfterPrepareInterruption",
    "StopAfterReadInterruption",
    "SumMetric",
    "WorkflowParams",
    "ZeroMetric",
    "doer",
    "extract_params",
    "params_to_json",
    "run_sanity_check",
    "serialize_engine_params",
]
