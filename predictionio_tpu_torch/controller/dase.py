"""DASE component contracts.

Trimmed copy of ``predictionio_tpu/controller/dase.py``: the
``Controller`` base, the ``doer`` constructor, ``run_sanity_check``, and
the contracts that training, evaluation and a deployed engine exercise
(``DataSource.read_training``/``read_eval``, ``Preparator.prepare``,
``Algorithm.train``/``predict``/``batch_predict``,
``Serving.serve``/``supplement``, ``FirstServing``). Persistent-model
manifests and ``RETRAIN`` wait (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import inspect
from typing import Any, Generic, List, Optional, Sequence, Tuple, Type, TypeVar

from .params import EmptyParams, Params

TD = TypeVar("TD")  # training data
EI = TypeVar("EI")  # evaluation info
A = TypeVar("A")  # actual result
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")  # model
Q = TypeVar("Q")  # query
P = TypeVar("P")  # predicted result


def run_sanity_check(obj: Any, label: str) -> None:
    """Invoke ``sanity_check`` if the object opts in (duck-typed, like the
    reference's ``isInstanceOf[SanityCheck]`` test)."""
    check = getattr(obj, "sanity_check", None)
    if callable(check):
        check()


class Controller:
    """Common base: every DASE component holds its ``Params``
    (``controller/Params.scala:23``; instantiation via :func:`doer`)."""

    params: Params = EmptyParams()


def doer(cls: Type, params: Params) -> Any:
    """Instantiate a controller class with or without params (the
    ``Doer`` reflection constructor, ``core/AbstractDoer.scala:30-53``):
    prefer a 1-arg ``(params)`` constructor, fall back to zero-arg."""
    try:
        sig = inspect.signature(cls.__init__)
        accepts_params = len(
            [
                p
                for name, p in sig.parameters.items()
                if name != "self"
                and p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)
                and p.default is p.empty
            ]
        ) >= 1 or "params" in sig.parameters
    except (TypeError, ValueError):
        accepts_params = False
    if accepts_params:
        instance = cls(params)
    else:
        instance = cls()
        instance.params = params
    if getattr(instance, "params", None) is None:
        instance.params = params
    return instance


class DataSource(Controller, Generic[TD, EI, Q, A]):
    """Reads training data (``controller/DataSource.scala:38-107``)."""

    def read_training(self, ctx) -> TD:
        raise NotImplementedError

    def read_eval(self, ctx) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
        """Evaluation path: (train split, eval info, (query, actual) set) per
        fold (``PDataSource.readEval``, ``DataSource.scala:48-56``)."""
        return []


class Preparator(Controller, Generic[TD, PD]):
    """Transforms training data for algorithms
    (``controller/Preparator.scala:38-74``)."""

    def prepare(self, ctx, training_data: TD) -> PD:
        raise NotImplementedError


class Algorithm(Controller, Generic[PD, M, Q, P]):
    """Train + predict (``controller/Algorithm.scala``). Device
    algorithms override ``batch_predict`` with one batched device call;
    the default maps ``predict``."""

    def train(self, ctx, prepared_data: PD) -> M:
        raise NotImplementedError

    def predict(self, model: M, query: Q) -> P:
        raise NotImplementedError

    def batch_predict(
        self, model: M, indexed_queries: Sequence[Tuple[int, Q]]
    ) -> List[Tuple[int, P]]:
        return [(i, self.predict(model, q)) for i, q in indexed_queries]

    def prepare_serving(self, model: M, ctx) -> None:
        """Deploy-time hook, run once per live model before the first
        query: device algorithms move the model's tables to
        ``ctx.device`` here. The default does nothing."""

    def query_class(self) -> Optional[Type[Q]]:
        """Query dataclass for JSON decoding at the query server (the
        per-algorithm ``querySerializer``, ``CreateServer.scala:475-478``)."""
        return None


class Serving(Controller, Generic[Q, P]):
    """Combines per-algorithm predictions into one response
    (``controller/Serving.scala:34-60``)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        raise NotImplementedError

    def supplement(self, query: Q) -> Q:
        """Pre-predict query enrichment hook (``Serving.scala`` supplement)."""
        return query


class FirstServing(Serving[Q, P]):
    """Returns the first algorithm's prediction (``LFirstServing``,
    ``Serving.scala:62-81``)."""

    def serve(self, query: Q, predictions: Sequence[P]) -> P:
        return predictions[0]
