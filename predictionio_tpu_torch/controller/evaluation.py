"""Evaluation: couples an engine with an evaluator; hyperparameter grids.

Copy of ``predictionio_tpu/controller/evaluation.py``, a rebuild of
``core/src/main/scala/io/prediction/controller/Evaluation.scala:59-124``
and ``Engine.scala:698-714`` (``EngineParamsGenerator``): an
``Evaluation`` names the engine + evaluator pair a ``pio eval`` run
uses, and a generator supplies the candidate EngineParams grid.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .engine import Engine, EngineParams
from .metrics import Metric, MetricEvaluator


class Evaluation:
    """Subclass and set ``engine_metric`` (sugar building a MetricEvaluator,
    ``Evaluation.scala:93-116``) or ``engine_evaluator`` directly."""

    def __init__(self):
        self._engine: Optional[Engine] = None
        self._evaluator: Optional[MetricEvaluator] = None

    @property
    def engine_evaluator(self) -> Tuple[Engine, MetricEvaluator]:
        if self._engine is None or self._evaluator is None:
            raise ValueError(
                "Evaluation has no engine/evaluator; set engine_metric or "
                "engine_evaluator first."
            )
        return (self._engine, self._evaluator)

    @engine_evaluator.setter
    def engine_evaluator(self, pair: Tuple[Engine, MetricEvaluator]) -> None:
        self._engine, self._evaluator = pair

    @property
    def engine_metric(self) -> Tuple[Engine, Metric]:
        raise NotImplementedError("engine_metric is write-only")

    @engine_metric.setter
    def engine_metric(self, pair: Tuple[Engine, Metric]) -> None:
        engine, metric = pair
        self.engine_evaluator = (engine, MetricEvaluator(metric))

    @property
    def engine_metrics(self):
        raise NotImplementedError("engine_metrics is write-only")

    @engine_metrics.setter
    def engine_metrics(self, triple: Tuple[Engine, Metric, Sequence[Metric]]) -> None:
        engine, metric, others = triple
        self.engine_evaluator = (engine, MetricEvaluator(metric, others))

    @property
    def engine(self) -> Engine:
        return self.engine_evaluator[0]

    @property
    def evaluator(self) -> MetricEvaluator:
        return self.engine_evaluator[1]


class EngineParamsGenerator:
    """Supplies the hyperparameter grid (``Engine.scala:698-714``)."""

    def __init__(self, engine_params_list: Sequence[EngineParams] = ()):
        self._list: Optional[Sequence[EngineParams]] = (
            tuple(engine_params_list) if engine_params_list else None
        )

    @property
    def engine_params_list(self) -> Sequence[EngineParams]:
        if self._list is None:
            raise ValueError("engine_params_list is empty")
        return self._list

    @engine_params_list.setter
    def engine_params_list(self, value: Sequence[EngineParams]) -> None:
        self._list = tuple(value)
