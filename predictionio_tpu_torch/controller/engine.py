"""Engine: DASE class maps and the deploy-time dataflow.

Trimmed copy of ``predictionio_tpu/controller/engine.py`` — the deploy
side: ``EngineParams``, component instantiation (``_algorithms``,
``_serving``), ``prepare_deploy`` and the rebuild of ``EngineParams``
from a stored engine instance (``Engine.scala:372-425``), plus
``serialize_engine_params`` to write one. The train and eval dataflows
wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Type, Union

from .dase import Algorithm, Serving, doer
from .params import EmptyParams, Params, ParamsError, extract_params, params_to_json

ClassMap = Dict[str, Type]


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

    def prepare_deploy(
        self,
        ctx,
        engine_params: EngineParams,
        instance_id: str,
        persisted_models: Sequence[Any],
    ) -> List[Any]:
        """Persisted models → live ones (``Engine.scala:168-237``). The
        port deploys blobbed models as they are; an instance whose blob
        does not hold one model per algorithm is refused."""
        n_algos = len(engine_params.algorithm_params_list)
        if len(persisted_models) != n_algos:
            raise ValueError(
                f"engine instance {instance_id} persisted "
                f"{len(persisted_models)} models for {n_algos} algorithms"
            )
        return list(persisted_models)

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


def _component_params_class(component_cls: Type) -> Type:
    """A component's Params dataclass: its ``params_class``, else
    EmptyParams."""
    return getattr(component_cls, "params_class", EmptyParams)


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
