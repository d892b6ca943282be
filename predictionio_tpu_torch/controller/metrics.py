"""Metrics and the metric evaluator.

Copy of ``predictionio_tpu/controller/metrics.py``, a rebuild of
``core/src/main/scala/io/prediction/controller/Metric.scala:35-160`` and
``MetricEvaluator.scala:55-241``: metrics score the (query, prediction,
actual) sets an evaluation produces; the evaluator scores every
candidate EngineParams, picks the best by the metric's ordering, and can
write the winning variant's JSON (``best.json``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

from ..utils.durability import atomic_write_bytes
from .engine import EngineParams
from .params import params_to_json

logger = logging.getLogger(__name__)

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")
R = TypeVar("R")

#: evaluation output: per engine-params, per fold, the (Q, P, A) set
EvalDataSet = Sequence[Tuple[EI, Sequence[Tuple[Q, P, A]]]]


class Metric(Generic[EI, Q, P, A, R]):
    """Scores one evaluation data set (``Metric.scala:35-45``)."""

    @property
    def header(self) -> str:
        return type(self).__name__

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> R:
        raise NotImplementedError

    def compare(self, r0: R, r1: R) -> int:
        """Ordering on results; larger is better by default."""
        if r0 == r1:
            return 0
        return 1 if r0 > r1 else -1  # type: ignore[operator]

    def __str__(self) -> str:
        return self.header


class AverageMetric(Metric[EI, Q, P, A, float]):
    """Global average of per-tuple scores (``Metric.scala:56-76``)."""

    def calculate_point(self, q: Q, p: P, a: A) -> float:
        raise NotImplementedError

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        total, count = 0.0, 0
        for _, qpa in eval_data_set:
            for q, p, a in qpa:
                total += self.calculate_point(q, p, a)
                count += 1
        return total / count if count else float("-inf")


class OptionAverageMetric(Metric[EI, Q, P, A, float]):
    """Average of non-None per-tuple scores; -inf when none
    (``Metric.scala:87-120``)."""

    def calculate_point(self, q: Q, p: P, a: A) -> Optional[float]:
        raise NotImplementedError

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        total, count = 0.0, 0
        for _, qpa in eval_data_set:
            for q, p, a in qpa:
                score = self.calculate_point(q, p, a)
                if score is not None:
                    total += score
                    count += 1
        return total / count if count else float("-inf")


class SumMetric(Metric[EI, Q, P, A, float]):
    """Global sum of per-tuple scores (``Metric.scala:122-142``)."""

    def calculate_point(self, q: Q, p: P, a: A) -> float:
        raise NotImplementedError

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return sum(
            self.calculate_point(q, p, a)
            for _, qpa in eval_data_set
            for q, p, a in qpa
        )


class ZeroMetric(Metric[EI, Q, P, A, float]):
    """Always 0 (``Metric.scala:144-152``) — placeholder metric."""

    def calculate(self, ctx, eval_data_set: EvalDataSet) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class MetricScores(Generic[R]):
    """Primary + other metric scores for one EngineParams
    (``MetricEvaluator.scala:43-53``)."""

    score: R
    other_scores: Tuple[Any, ...] = ()


@dataclasses.dataclass(frozen=True)
class MetricEvaluatorResult(Generic[R]):
    """Sweep outcome (``MetricEvaluator.scala:55-107``)."""

    best_score: MetricScores[R]
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: Tuple[str, ...]
    engine_params_scores: Tuple[Tuple[EngineParams, MetricScores[R]], ...]
    output_path: Optional[str] = None

    def one_liner(self) -> str:
        return f"[{self.best_score.score}] {self.metric_header}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "bestScore": _json_safe(self.best_score.score),
                "bestIdx": self.best_idx,
                "bestEngineParams": _engine_params_json(self.best_engine_params),
                "otherMetricHeaders": list(self.other_metric_headers),
                "scores": [
                    {
                        "engineParams": _engine_params_json(ep),
                        "score": _json_safe(ms.score),
                        "otherScores": [_json_safe(s) for s in ms.other_scores],
                    }
                    for ep, ms in self.engine_params_scores
                ],
            },
            indent=2,
        )

    def to_html(self) -> str:
        rows = "\n".join(
            f"<tr><td>{i}</td><td>{_json_safe(ms.score)}</td>"
            f"<td><pre>{json.dumps(_engine_params_json(ep), indent=1)}</pre></td></tr>"
            for i, (ep, ms) in enumerate(self.engine_params_scores)
        )
        return (
            f"<html><body><h1>{self.metric_header}</h1>"
            f"<p>Best score: {_json_safe(self.best_score.score)} "
            f"(iteration {self.best_idx})</p>"
            f"<table border=1><tr><th>#</th><th>score</th><th>params</th></tr>"
            f"{rows}</table></body></html>"
        )


def _json_safe(value: Any) -> Any:
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            return str(value)
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return repr(value)


def _engine_params_json(ep: EngineParams) -> dict:
    """EngineParams → engine-variant-shaped JSON (``MetricEvaluator``'s
    ``EngineVariant``, ``MetricEvaluator.scala:120-158``)."""

    def name_params(pair):
        name, params = pair
        return {"name": name, "params": params_to_json(params)}

    return {
        "datasource": name_params(ep.data_source_params),
        "preparator": name_params(ep.preparator_params),
        "algorithms": [name_params(p) for p in ep.algorithm_params_list],
        "serving": name_params(ep.serving_params),
    }


class MetricEvaluator(Generic[EI, Q, P, A, R]):
    """Scores every EngineParams and selects the max
    (``MetricEvaluator.scala:163-241``)."""

    def __init__(
        self,
        metric: Metric[EI, Q, P, A, R],
        other_metrics: Sequence[Metric[EI, Q, P, A, Any]] = (),
        output_path: Optional[str] = None,
    ):
        self.metric = metric
        self.other_metrics = tuple(other_metrics)
        self.output_path = output_path

    def evaluate_base(
        self,
        ctx,
        evaluation,
        engine_eval_data_set: Sequence[Tuple[EngineParams, EvalDataSet]],
        workflow_params=None,
        parallelism: int = 0,
    ) -> MetricEvaluatorResult[R]:
        def score_one(pair) -> Tuple[EngineParams, MetricScores[R]]:
            ep, eval_data_set = pair
            return ep, MetricScores(
                score=self.metric.calculate(ctx, eval_data_set),
                other_scores=tuple(
                    m.calculate(ctx, eval_data_set) for m in self.other_metrics
                ),
            )

        # candidates are scored concurrently, as the reference does with a
        # parallel collection (MetricEvaluator.scala:202-211); metrics must
        # be thread-safe across candidates. Scoring is host work: the pool
        # is capped however wide the sweep itself ran.
        n = min(parallelism if parallelism > 0 else 8, 8, len(engine_eval_data_set))
        if n > 1:
            with ThreadPoolExecutor(max_workers=n, thread_name_prefix="metric") as pool:
                scored: List[Tuple[EngineParams, MetricScores[R]]] = list(
                    pool.map(score_one, engine_eval_data_set)
                )
        else:
            scored = [score_one(pair) for pair in engine_eval_data_set]
        for idx, (ep, r) in enumerate(scored):
            logger.info("Iteration %d: score %s", idx, r.score)

        best_idx = 0
        for idx in range(1, len(scored)):
            # strict > keeps the earliest best, matching reduce with >= 0
            if self.metric.compare(scored[idx][1].score, scored[best_idx][1].score) > 0:
                best_idx = idx
        best_ep, best_scores = scored[best_idx]

        if self.output_path:
            self._save_engine_json(evaluation, best_ep, self.output_path)

        return MetricEvaluatorResult(
            best_score=best_scores,
            best_engine_params=best_ep,
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=tuple(m.header for m in self.other_metrics),
            engine_params_scores=tuple(scored),
            output_path=self.output_path,
        )

    def _save_engine_json(
        self, evaluation, engine_params: EngineParams, path: str
    ) -> None:
        """Write the winning variant (``saveEngineJson``,
        ``MetricEvaluator.scala:169-191``)."""
        factory = type(evaluation).__name__ if evaluation is not None else ""
        variant = {
            "id": factory,
            "description": "",
            "engineFactory": factory,
            **_engine_params_json(engine_params),
        }
        atomic_write_bytes(path, json.dumps(variant, indent=2).encode("utf-8"))
        logger.info("Best variant params written to %s", path)
