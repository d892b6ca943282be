"""DASE component contracts.

Trimmed copy of ``predictionio_tpu/controller/dase.py``: the
``Controller`` base, the ``doer`` constructor, ``SanityCheck`` and
``run_sanity_check``, the contracts that training, evaluation and a
deployed engine exercise (``DataSource.read_training``/``read_eval``,
``Preparator.prepare``, ``IdentityPreparator``,
``Algorithm.train``/``predict``/``batch_predict``,
``Serving.serve``/``supplement``, ``FirstServing``, ``AverageServing``),
and the persistence protocol of ``makeSerializableModels``
(``Engine.scala:254-272``): an algorithm's ``make_persistent`` returns a
:class:`PersistentModelManifest` for a :class:`PersistentModel` that saved
itself (``IPersistentModel.scala:60-137``), :data:`RETRAIN` to store
nothing and retrain at deploy (the ``Unit`` model of
``Algorithm.scala:80-101``), or the model itself, which the workflow
pickles into the model store.
"""

from __future__ import annotations

import abc
import importlib
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


class _RetrainSentinel:
    """Marker: model not persisted; retrain at deploy (``Engine.scala:180``)."""

    def __repr__(self) -> str:
        return "RETRAIN"

    def __reduce__(self):
        # unpickles as the module-level singleton (through this module's
        # own path), so ``is RETRAIN`` survives the model store
        return (_retrain_instance, ())


def _retrain_instance() -> "_RetrainSentinel":
    return RETRAIN


#: Return this from ``make_persistent`` to request deploy-time retraining.
RETRAIN = _RetrainSentinel()

#: top-level modules a manifest may never import: the JAX package (its
#: classes import jax) and jax itself
FOREIGN_ROOTS = ("predictionio_tpu", "jax", "jaxlib")


class ForeignModelError(ValueError):
    """A stored model names the JAX package (or jax): the port cannot load
    it without importing jax."""


class SanityCheck(abc.ABC):
    """Optional hook run on data and models after each stage unless
    skipped (``controller/SanityCheck.scala``; ``Engine.scala:526-582``)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise on inconsistent data."""


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


class IdentityPreparator(Preparator[TD, TD]):
    """Pass-through (``IdentityPreparator``, ``Preparator.scala:76-96``)."""

    def prepare(self, ctx, training_data: TD) -> TD:
        return training_data


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

    def make_persistent(self, instance_id: str, model: M, ctx) -> Any:
        """How the trained model persists (``Engine.scala:254-272``):

        - a :class:`PersistentModel` saves itself, and its
          :class:`PersistentModelManifest` is stored instead of its bytes
          (:data:`RETRAIN` when its ``save`` declines);
        - :data:`RETRAIN`: nothing is stored, deploy trains again;
        - anything else is pickled into the model store by the workflow.
        """
        if isinstance(model, PersistentModel):
            if model.save(instance_id, self.params, ctx):
                return PersistentModelManifest.of(model)
            return RETRAIN
        return model

    def prepare_serving(self, model: M, ctx) -> None:
        """Deploy-time hook, run once per live model before the first
        query: device algorithms move the model's tables to
        ``ctx.device`` here. The default does nothing."""

    def query_class(self) -> Optional[Type[Q]]:
        """Query dataclass for JSON decoding at the query server (the
        per-algorithm ``querySerializer``, ``CreateServer.scala:475-478``)."""
        return None


class PersistentModel(abc.ABC):
    """Self-persisting model (``IPersistentModel.scala:60-96``), with a
    ``load`` classmethod (the ``IPersistentModelLoader`` companion,
    ``IPersistentModel.scala:98-117``)."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Params, ctx) -> bool:
        """Persist; return False to fall back to deploy-time retraining."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Params, ctx) -> "PersistentModel":
        ...


class PersistentModelManifest:
    """The class path of a self-persisted model
    (``workflow/PersistentModelManifest.scala``), stored in its place."""

    def __init__(self, class_path: str):
        self.class_path = class_path

    @staticmethod
    def of(model: PersistentModel) -> "PersistentModelManifest":
        cls = type(model)
        return PersistentModelManifest(f"{cls.__module__}:{cls.__qualname__}")

    def resolve(self) -> Type[PersistentModel]:
        """Import the model class by name. A path into the JAX package or
        jax is refused before any import (:class:`ForeignModelError`): a
        manifest written by the JAX package would import jax here."""
        module_name, _, qualname = self.class_path.partition(":")
        if module_name.split(".")[0] in FOREIGN_ROOTS:
            raise ForeignModelError(
                f"persistent-model manifest {self.class_path!r} names a class of "
                "the JAX package; the port loads only its own models"
            )
        obj: Any = importlib.import_module(module_name)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj

    def __repr__(self) -> str:
        return f"PersistentModelManifest({self.class_path!r})"

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, PersistentModelManifest)
                and self.class_path == other.class_path)


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


class AverageServing(Serving[Q, float]):
    """Averages numeric predictions (``LAverageServing``,
    ``Serving.scala:83-102``)."""

    def serve(self, query: Q, predictions: Sequence[float]) -> float:
        return sum(predictions) / len(predictions)
