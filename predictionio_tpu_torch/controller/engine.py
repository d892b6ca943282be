"""Engine: DASE class maps, the train and eval dataflows and the deploy
side.

Trimmed copy of ``predictionio_tpu/controller/engine.py``:
``WorkflowParams``, ``EngineParams``, component instantiation,
``Engine.train`` (read → sanity → prepare → sanity → train each
algorithm → sanity, ``Engine.scala:499-586``), ``Engine.eval`` and
``batch_eval`` (per fold: train on the split, one ``batch_predict`` per
algorithm, serve each query, ``Engine.scala:588-672``),
``make_serializable_models`` (each algorithm's ``make_persistent``),
``prepare_deploy`` (manifests loaded, ``RETRAIN`` trained again, blobbed
models passed through), the engine-variant
JSON parser ``json_to_engine_params`` (``Engine.scala:313-370``) and the
rebuild of ``EngineParams`` from a stored engine instance
(``Engine.scala:372-425``), plus ``serialize_engine_params`` to write
one. ``Engine.train`` times ``read``, ``prepare`` and each ``train[i]``
on the context's phase timer (``WorkflowContext.timer``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
from collections import defaultdict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Type, Union

from .dase import (
    RETRAIN,
    Algorithm,
    DataSource,
    PersistentModelManifest,
    Preparator,
    Serving,
    doer,
    run_sanity_check,
)
from .params import EmptyParams, Params, ParamsError, extract_params, params_to_json

logger = logging.getLogger(__name__)

ClassMap = Dict[str, Type]


def _null_phase(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class WorkflowParams:
    """Per-run workflow knobs (``workflow/WorkflowParams.scala``; CLI
    flags in ``CreateWorkflow.scala:87-140``)."""

    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    #: hyperparameter-sweep parallelism: 0 = auto (one sweep thread per
    #: candidate, bounded by ``WorkflowContext.slices``), 1 = serial
    eval_parallelism: int = 0
    #: per-run checkpoint cadence (``pio train --checkpoint-every``); it
    #: sits between the engine params and ``PIO_CKPT_EVERY``
    checkpoint_every: Optional[int] = None


class StopAfterReadInterruption(Exception):
    """``--stop-after-read`` (``Engine.scala:530-536``)."""


class StopAfterPrepareInterruption(Exception):
    """``--stop-after-prepare`` (``Engine.scala:548-554``)."""


def _as_class_map(spec: Union[Type, Mapping[str, Type]]) -> ClassMap:
    if isinstance(spec, Mapping):
        return dict(spec)
    return {"": spec}


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Named (component-name, Params) bindings for one engine variant
    (``controller/EngineParams.scala:56-144``)."""

    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: Sequence[Tuple[str, Params]] = (("", EmptyParams()),)
    serving_params: Tuple[str, Params] = ("", EmptyParams())

    def __post_init__(self):
        object.__setattr__(
            self, "algorithm_params_list", tuple(self.algorithm_params_list)
        )


class Engine:
    """The DASE engine (``Engine.scala:81-128``)."""

    def __init__(
        self,
        data_source_class_map: Union[Type, Mapping[str, Type]],
        preparator_class_map: Union[Type, Mapping[str, Type]],
        algorithm_class_map: Union[Type, Mapping[str, Type]],
        serving_class_map: Union[Type, Mapping[str, Type]],
    ):
        self.data_source_class_map = _as_class_map(data_source_class_map)
        self.preparator_class_map = _as_class_map(preparator_class_map)
        self.algorithm_class_map = _as_class_map(algorithm_class_map)
        self.serving_class_map = _as_class_map(serving_class_map)

    def _data_source(self, ep: EngineParams) -> DataSource:
        name, params = ep.data_source_params
        if name not in self.data_source_class_map:
            raise KeyError(f"Unknown datasource name {name!r}")
        return doer(self.data_source_class_map[name], params)

    def _preparator(self, ep: EngineParams) -> Preparator:
        name, params = ep.preparator_params
        if name not in self.preparator_class_map:
            raise KeyError(f"Unknown preparator name {name!r}")
        return doer(self.preparator_class_map[name], params)

    def _algorithms(self, ep: EngineParams) -> List[Algorithm]:
        algos = []
        for name, params in ep.algorithm_params_list:
            if name not in self.algorithm_class_map:
                raise KeyError(f"Unknown algorithm name {name!r}")
            algos.append(doer(self.algorithm_class_map[name], params))
        return algos

    def _serving(self, ep: EngineParams) -> Serving:
        name, params = ep.serving_params
        if name not in self.serving_class_map:
            raise KeyError(f"Unknown serving name {name!r}")
        return doer(self.serving_class_map[name], params)

    def train(
        self,
        ctx,
        engine_params: EngineParams,
        workflow_params: WorkflowParams = WorkflowParams(),
    ) -> List[Any]:
        """Run read → sanity → prepare → sanity → train(each algo) →
        sanity; returns one trained model per algorithm."""
        data_source = self._data_source(engine_params)
        preparator = self._preparator(engine_params)
        algorithms = self._algorithms(engine_params)
        timer = getattr(ctx, "timer", None)
        timed = timer.time if timer is not None else _null_phase
        try:
            with timed("read"):
                training_data = data_source.read_training(ctx)
        except Exception as exc:
            # Engine.scala:517-524 wraps read errors with a storage hint
            raise RuntimeError(
                "Data is incomplete or data source reported an error. "
                f"(reading training data failed: {exc})"
            ) from exc
        if not workflow_params.skip_sanity_check:
            run_sanity_check(training_data, "training data")
        if workflow_params.stop_after_read:
            raise StopAfterReadInterruption()

        with timed("prepare"):
            prepared_data = preparator.prepare(ctx, training_data)
        if not workflow_params.skip_sanity_check:
            run_sanity_check(prepared_data, "prepared data")
        if workflow_params.stop_after_prepare:
            raise StopAfterPrepareInterruption()

        models = []
        for i, algo in enumerate(algorithms):
            if ctx is not None:
                # lets an algorithm namespace its per-run resources
                # (checkpoints) by its slot
                ctx.algorithm_index = i
            with timed(f"train[{i}]"):
                model = algo.train(ctx, prepared_data)
            if not workflow_params.skip_sanity_check:
                run_sanity_check(model, "model")
            models.append(model)
        return models

    def make_serializable_models(
        self, ctx, engine_params: EngineParams, instance_id: str,
        models: Sequence[Any],
    ) -> List[Any]:
        """The models as the blob stores them (``Engine.scala:254-272``),
        one per algorithm: a :class:`PersistentModelManifest`,
        :data:`RETRAIN`, or the model to pickle, as each algorithm's
        ``make_persistent`` decides."""
        algorithms = self._algorithms(engine_params)
        return [
            algo.make_persistent(instance_id, model, ctx)
            for algo, model in zip(algorithms, models)
        ]

    def prepare_deploy(
        self,
        ctx,
        engine_params: EngineParams,
        instance_id: str,
        persisted_models: Sequence[Any],
    ) -> List[Any]:
        """Persisted models → live ones (``Engine.scala:168-237``): a
        manifest's class loads its model, a blobbed model passes through,
        and if any entry is :data:`RETRAIN` the engine trains once on
        ``ctx`` (its device, the DataSource's store, the stored params and
        their seed; ``Engine.scala:180-198``) and each such entry takes
        its algorithm's retrained model. An instance whose blob does not
        hold one entry per algorithm is refused."""
        n_algos = len(engine_params.algorithm_params_list)
        if len(persisted_models) != n_algos:
            raise ValueError(
                f"engine instance {instance_id} persisted "
                f"{len(persisted_models)} models for {n_algos} algorithms"
            )
        algorithms = self._algorithms(engine_params)
        retrained: Optional[List[Any]] = None
        if any(m is RETRAIN for m in persisted_models):
            logger.info("Engine instance %s stored RETRAIN: training again at deploy",
                        instance_id)
            retrained = self.train(ctx, engine_params)
        live = []
        for i, (algo, pm) in enumerate(zip(algorithms, persisted_models)):
            if isinstance(pm, PersistentModelManifest):
                live.append(pm.resolve().load(instance_id, algo.params, ctx))
            elif pm is RETRAIN:
                live.append(retrained[i])
            else:
                live.append(pm)
        return live

    def eval(
        self,
        ctx,
        engine_params: EngineParams,
        workflow_params: WorkflowParams = WorkflowParams(),
    ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per eval fold: train on the split, batch-predict all algorithms,
        combine per query through serving → (eval info, [(q, p, a)]).

        Each trained model is attached with ``prepare_serving`` before its
        ``batch_predict``, so device algorithms score on ``ctx.device``
        (the deploy path's attach; the JAX package has no such step)."""
        data_source = self._data_source(engine_params)
        preparator = self._preparator(engine_params)
        algorithms = self._algorithms(engine_params)
        serving = self._serving(engine_params)

        results = []
        for training_data, eval_info, qa_pairs in data_source.read_eval(ctx):
            prepared_data = preparator.prepare(ctx, training_data)
            models = [algo.train(ctx, prepared_data) for algo in algorithms]
            # serving.supplement is a serve-time hook and is not applied
            # here, as in the reference's eval dataflow
            indexed = list(enumerate(q for q, _ in qa_pairs))
            per_algo = []
            for algo, model in zip(algorithms, models):
                algo.prepare_serving(model, ctx)
                per_algo.append(algo.batch_predict(model, indexed))
            results.append((eval_info, serve_eval_queries(serving, qa_pairs, per_algo)))
        return results

    def batch_eval(
        self,
        ctx,
        engine_params_list: Sequence[EngineParams],
        workflow_params: WorkflowParams = WorkflowParams(),
        parallelism: int = 1,
    ) -> List[Tuple[EngineParams, List[Tuple[Any, List[Tuple[Any, Any, Any]]]]]]:
        """Evaluate every EngineParams (``BaseEngine.batchEval``,
        ``core/BaseEngine.scala:47-55``); ``FastEvalEngine`` overrides it
        with prefix memoization. ``parallelism > 1`` runs the candidates
        on the sweep threads of :func:`..parallel.sweep.run_sliced`, one
        per slice of the context (one, on one card)."""
        if parallelism > 1 and len(engine_params_list) > 1:
            from ..parallel.sweep import run_sliced

            tasks = [
                (lambda sliced, ep=ep: self.eval(sliced, ep, workflow_params))
                for ep in engine_params_list
            ]
            return list(zip(engine_params_list, run_sliced(ctx, tasks, parallelism)))
        return [(ep, self.eval(ctx, ep, workflow_params)) for ep in engine_params_list]

    def json_to_engine_params(self, variant: Mapping[str, Any]) -> EngineParams:
        """Parse an engine-variant JSON object into typed EngineParams."""
        ds = _named_params(variant, "datasource", self.data_source_class_map)
        prep = _named_params(variant, "preparator", self.preparator_class_map)
        serv = _named_params(variant, "serving", self.serving_class_map)
        algorithms = variant.get("algorithms")
        if algorithms is None:
            algo_list: List[Tuple[str, Params]] = [
                ("", _default_params(self.algorithm_class_map, ""))
            ]
        else:
            algo_list = []
            for block in algorithms:
                name = block.get("name", "")
                if name not in self.algorithm_class_map:
                    raise ParamsError(
                        f"Unable to find algorithm class with name {name!r} "
                        "defined in Engine."
                    )
                params_cls = _component_params_class(self.algorithm_class_map[name])
                algo_list.append((name, extract_params(params_cls, block.get("params"))))
        return EngineParams(
            data_source_params=ds,
            preparator_params=prep,
            algorithm_params_list=algo_list,
            serving_params=serv,
        )

    def engine_instance_to_engine_params(self, instance) -> EngineParams:
        """Rebuild EngineParams from a stored EngineInstance row
        (``Engine.scala:372-425``) — the deploy path's parameter source."""

        def parse(text: str, class_map: ClassMap, stage: str) -> Tuple[str, Params]:
            if not text:
                return ("", _default_params(class_map, ""))
            obj = json.loads(text)
            name = obj.get("name", "")
            if name not in class_map:
                raise ParamsError(
                    f"Unable to find {stage} class with name {name!r} defined "
                    "in Engine (stored engine instance refers to a renamed or "
                    "removed component)."
                )
            cls = class_map[name]
            return (name, extract_params(_component_params_class(cls), obj.get("params")))

        algo_list: List[Tuple[str, Params]] = []
        if instance.algorithms_params:
            for block in json.loads(instance.algorithms_params):
                name = block.get("name", "")
                if name not in self.algorithm_class_map:
                    raise ParamsError(
                        f"Unable to find algorithm class with name {name!r} "
                        "defined in Engine (stored engine instance refers to "
                        "a renamed or removed component)."
                    )
                cls = self.algorithm_class_map[name]
                algo_list.append(
                    (name, extract_params(_component_params_class(cls), block.get("params")))
                )
        else:
            algo_list = [("", _default_params(self.algorithm_class_map, ""))]
        return EngineParams(
            data_source_params=parse(
                instance.data_source_params, self.data_source_class_map, "datasource"
            ),
            preparator_params=parse(
                instance.preparator_params, self.preparator_class_map, "preparator"
            ),
            algorithm_params_list=algo_list,
            serving_params=parse(
                instance.serving_params, self.serving_class_map, "serving"
            ),
        )


def serialize_engine_params(ep: EngineParams) -> Dict[str, str]:
    """EngineParams → the four JSON-text columns of an EngineInstance row
    (``CreateWorkflow.scala:245-253``)."""

    def enc(pair: Tuple[str, Params]) -> str:
        return json.dumps({"name": pair[0], "params": params_to_json(pair[1])})

    return {
        "data_source_params": enc(ep.data_source_params),
        "preparator_params": enc(ep.preparator_params),
        "algorithms_params": json.dumps(
            [
                {"name": name, "params": params_to_json(params)}
                for name, params in ep.algorithm_params_list
            ]
        ),
        "serving_params": enc(ep.serving_params),
    }


def serve_eval_queries(serving: Serving, qa_pairs, per_algo) -> List[Tuple[Any, Any, Any]]:
    """Combine one fold's per-algorithm indexed predictions into
    ``(query, served prediction, actual)`` triples, in query order
    (``Engine.scala:636-660``). ``per_algo`` holds, per algorithm, the
    ``(query index, prediction)`` pairs its ``batch_predict`` returned."""
    by_query: Dict[int, Dict[int, Any]] = defaultdict(dict)
    for ai, indexed_preds in enumerate(per_algo):
        for qi, p in indexed_preds:
            by_query[qi][ai] = p
    qpa = []
    for qi, (q, a) in enumerate(qa_pairs):
        preds = by_query.get(qi, {})
        qpa.append((q, serving.serve(q, [preds[ai] for ai in sorted(preds)]), a))
    return qpa


def _component_params_class(component_cls: Type) -> Type:
    """A component's Params dataclass: its ``params_class``, else
    EmptyParams."""
    return getattr(component_cls, "params_class", EmptyParams)


def _named_params(
    variant: Mapping[str, Any], field: str, class_map: ClassMap
) -> Tuple[str, Params]:
    """``WorkflowUtils.getParamsFromJsonByFieldAndClass``
    (``WorkflowUtils.scala:169-209``)."""
    block = variant.get(field)
    if block is None:
        return ("", _default_params(class_map, ""))
    name = block.get("name", "")
    if name not in class_map:
        raise ParamsError(
            f"Unable to find {field} class with name {name!r} defined in Engine."
        )
    params_json = block.get("params")
    if params_json is None:
        return (name, _default_params(class_map, name))
    return (name, extract_params(_component_params_class(class_map[name]), params_json))


def _default_params(class_map: ClassMap, name: str) -> Params:
    """An absent params block means the component's declared defaults."""
    cls = class_map.get(name)
    if cls is None:
        return EmptyParams()
    params_cls = _component_params_class(cls)
    try:
        return params_cls()
    except TypeError:  # params class with required fields: caller must supply
        return EmptyParams()
