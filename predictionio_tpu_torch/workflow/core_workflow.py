"""Model persistence for deployment.

Counterpart of ``predictionio_tpu/workflow/core_workflow.py``, deploy
side: :func:`load_models` reads an engine instance's pickled model list,
and :func:`persist_instance` writes one as a COMPLETED instance (the
persistence tail of ``run_train``, used to deploy models whose weights
were carried over from the JAX package — see
``models.recommendation.als_model_from_numpy``). Training and
evaluation runs wait for the training slice.

A blob pickled by the JAX package names ``predictionio_tpu.`` classes,
and unpickling it would import jax; :func:`load_models` refuses such a
blob with an error that names the module. Models cross between the
packages as arrays, never as pickles.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, List, Sequence

from ..controller.engine import EngineParams, serialize_engine_params
from ..storage import (
    STATUS_COMPLETED,
    Model,
    StorageRegistry,
    new_engine_instance,
    utcnow,
)
from .context import pio_env_vars

#: top-level modules a port model blob may never load: the JAX package
#: (its classes import jax) and jax itself
_FOREIGN_ROOTS = ("predictionio_tpu", "jax", "jaxlib")


class ForeignModelError(ValueError):
    """The model blob was written by the JAX package (or holds jax
    arrays); the port cannot unpickle it without importing jax."""


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN_ROOTS:
            raise ForeignModelError(
                f"model blob references {module}.{name}: it was pickled by "
                f"the JAX package ({module}); carry the arrays over instead "
                "(models.recommendation.als_model_from_numpy)"
            )
        return super().find_class(module, name)


def load_models(registry: StorageRegistry, instance_id: str) -> List[Any]:
    """Persisted model list for an instance (``CreateServer.scala:196-198``)."""
    blob = registry.get_models().get(instance_id)
    if blob is None:
        raise KeyError(f"No model data for engine instance {instance_id}")
    return _PortUnpickler(io.BytesIO(blob.models)).load()


def persist_instance(
    registry: StorageRegistry,
    engine_params: EngineParams,
    models: Sequence[Any],
    engine_id: str = "default",
    engine_version: str = "1",
    engine_variant: str = "engine.json",
    engine_factory: str = "",
    batch: str = "",
) -> str:
    """Store ``models`` (one per algorithm) as a COMPLETED engine
    instance and return its id: the instance row goes in first (INIT),
    then the model blob, then the row flips to COMPLETED — a deploy
    never finds a COMPLETED instance without its models
    (``CoreWorkflow.scala:43-93``)."""
    md = registry.get_metadata()
    instance = new_engine_instance(
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=batch,
        env=pio_env_vars(),
        **serialize_engine_params(engine_params),
    )
    instance_id = md.engine_instance_insert(instance)
    registry.get_models().insert(
        Model(id=instance_id, models=pickle.dumps(list(models)))
    )
    stored = md.engine_instance_get(instance_id)
    md.engine_instance_update(
        dataclasses.replace(stored, status=STATUS_COMPLETED, end_time=utcnow())
    )
    return instance_id
