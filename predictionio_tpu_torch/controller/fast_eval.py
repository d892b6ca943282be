"""FastEvalEngine: prefix-memoized hyperparameter sweeps.

Copy of ``predictionio_tpu/controller/fast_eval.py``, a rebuild of
``core/src/main/scala/io/prediction/controller/FastEvalEngine.scala:52-344``:
when a grid varies only the later DASE stages, the earlier stages'
results are cached keyed by the *params prefix*, so a sweep over
algorithm params reads and prepares the data exactly once.

Caches use value equality on params (``FastEvalEngine.scala:299-302``).
A params class without value ``__eq__`` (not a dataclass) falls back to
identity and never hits the cache across distinct instances, as in the
reference (``FastEvalEngineTest.scala:146``). Predictions are cached per
algorithm-params prefix, so a serving-params-only sweep reuses
everything upstream.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Generic, List, Optional, Sequence, Tuple, TypeVar

from .dase import doer
from .engine import Engine, EngineParams, WorkflowParams, serve_eval_queries
from .params import Params

K = TypeVar("K")
V = TypeVar("V")


class AssocCache(Generic[K, V]):
    """Equality-keyed cache (params need not be hashable) with
    exactly-once compute under concurrency.

    ``get_or_compute`` registers an in-flight Future under the lock, so a
    second thread asking for the same prefix waits for the first
    thread's result instead of invoking the component again: the
    memoization counts of a threaded sweep equal a serial one's
    (``FastEvalEngineTest.scala:30-146``)."""

    def __init__(self):
        self._items: List[Tuple[K, Future]] = []
        self._lock = threading.Lock()

    def get_or_compute(self, key: K, compute: Callable[[], V]) -> V:
        with self._lock:
            for k, fut in self._items:
                if k == key:
                    found: Optional[Future] = fut
                    break
            else:
                found = None
                mine: Future = Future()
                self._items.append((key, mine))
        if found is not None:
            return found.result()  # blocks if another thread is computing
        try:
            value = compute()
        except BaseException as exc:
            mine.set_exception(exc)
            with self._lock:  # failed computes are not cached
                self._items.remove((key, mine))
            raise
        mine.set_result(value)
        return value


# Prefix keys (FastEvalEngine.scala:52-87)
@dataclasses.dataclass(frozen=True)
class DataSourcePrefix:
    data_source_params: Tuple[str, Params]


@dataclasses.dataclass(frozen=True)
class PreparatorPrefix:
    data_source_params: Tuple[str, Params]
    preparator_params: Tuple[str, Params]


@dataclasses.dataclass(frozen=True)
class AlgorithmsPrefix:
    data_source_params: Tuple[str, Params]
    preparator_params: Tuple[str, Params]
    algorithm_params_list: Tuple[Tuple[str, Params], ...]


@dataclasses.dataclass(frozen=True)
class ServingPrefix:
    data_source_params: Tuple[str, Params]
    preparator_params: Tuple[str, Params]
    algorithm_params_list: Tuple[Tuple[str, Params], ...]
    serving_params: Tuple[str, Params]


class FastEvalEngineWorkflow:
    """Holds the per-sweep caches (``FastEvalEngineWorkflow``,
    ``FastEvalEngine.scala:89-344``)."""

    def __init__(self, engine: "FastEvalEngine", ctx, workflow_params: WorkflowParams,
                 train_slices=None):
        self.engine = engine
        self.ctx = ctx
        self.workflow_params = workflow_params
        #: optional SlicePool: the training stage checks a free slice out
        #: per distinct algorithms-prefix. Only that stage acquires
        #: (nested acquisition would deadlock).
        self._train_slices = train_slices
        self.data_source_cache: AssocCache = AssocCache()
        self.preparator_cache: AssocCache = AssocCache()
        self.algorithms_cache: AssocCache = AssocCache()
        self.serving_cache: AssocCache = AssocCache()

    # each stage computes through the previous stage's cached result,
    # exactly once per distinct prefix even under concurrent sweeps
    def get_data_source_result(self, prefix: DataSourcePrefix):
        def compute():
            name, params = prefix.data_source_params
            data_source = doer(self.engine.data_source_class_map[name], params)
            return data_source.read_eval(self.ctx)

        return self.data_source_cache.get_or_compute(prefix, compute)

    def get_preparator_result(self, prefix: PreparatorPrefix):
        def compute():
            eval_sets = self.get_data_source_result(
                DataSourcePrefix(prefix.data_source_params)
            )
            name, params = prefix.preparator_params
            preparator = doer(self.engine.preparator_class_map[name], params)
            return [(preparator.prepare(self.ctx, td), ei, qa) for td, ei, qa in eval_sets]

        return self.preparator_cache.get_or_compute(prefix, compute)

    def get_algorithms_result(self, prefix: AlgorithmsPrefix):
        """Per fold: per algorithm, its indexed predictions
        (``computeAlgorithmsResult``, ``FastEvalEngine.scala:170-242``).
        Each model is attached (``prepare_serving``) before its
        ``batch_predict``, as in ``Engine.eval``."""

        def compute_with(ctx):
            prepared_sets = self.get_preparator_result(
                PreparatorPrefix(prefix.data_source_params, prefix.preparator_params)
            )
            algos = [
                doer(self.engine.algorithm_class_map[name], params)
                for name, params in prefix.algorithm_params_list
            ]
            out = []
            for pd, ei, qa in prepared_sets:
                models = [a.train(ctx, pd) for a in algos]
                indexed = list(enumerate(q for q, _ in qa))
                per_algo = []
                for a, m in zip(algos, models):
                    a.prepare_serving(m, ctx)
                    per_algo.append(a.batch_predict(m, indexed))
                out.append((per_algo, ei, qa))
            return out

        def compute():
            if self._train_slices is not None:
                with self._train_slices.acquire() as sliced:
                    return compute_with(sliced)
            return compute_with(self.ctx)

        return self.algorithms_cache.get_or_compute(prefix, compute)

    def get_serving_result(self, prefix: ServingPrefix):
        def compute():
            algo_sets = self.get_algorithms_result(
                AlgorithmsPrefix(
                    prefix.data_source_params,
                    prefix.preparator_params,
                    prefix.algorithm_params_list,
                )
            )
            name, params = prefix.serving_params
            serving = doer(self.engine.serving_class_map[name], params)
            return [(ei, serve_eval_queries(serving, qa, per_algo))
                    for per_algo, ei, qa in algo_sets]

        return self.serving_cache.get_or_compute(prefix, compute)


class FastEvalEngine(Engine):
    """Engine whose ``batch_eval`` memoizes by params prefix
    (``FastEvalEngine.scala:310-344``)."""

    def batch_eval(
        self,
        ctx,
        engine_params_list: Sequence[EngineParams],
        workflow_params: WorkflowParams = WorkflowParams(),
        parallelism: int = 1,
    ):
        """Memoized sweep; ``parallelism > 1`` evaluates candidates on
        sweep threads (one per slice of the context) while the
        exactly-once caches keep the invocation counts those of a serial
        sweep (``FastEvalEngineTest.scala:30-146``)."""
        prefixes = [
            ServingPrefix(
                ep.data_source_params,
                ep.preparator_params,
                tuple(ep.algorithm_params_list),
                ep.serving_params,
            )
            for ep in engine_params_list
        ]
        if parallelism > 1 and len(engine_params_list) > 1:
            from ..parallel.sweep import SlicePool

            pool = SlicePool(ctx, parallelism)
            workflow = FastEvalEngineWorkflow(self, ctx, workflow_params, train_slices=pool)
            with ThreadPoolExecutor(
                max_workers=pool.n_slices, thread_name_prefix="sweep"
            ) as executor:
                futs = [executor.submit(workflow.get_serving_result, p) for p in prefixes]
                return [(ep, fut.result()) for ep, fut in zip(engine_params_list, futs)]
        workflow = FastEvalEngineWorkflow(self, ctx, workflow_params)
        return [
            (ep, workflow.get_serving_result(p))
            for ep, p in zip(engine_params_list, prefixes)
        ]
