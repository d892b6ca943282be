"""The train and evaluation workflows and model persistence for
deployment.

Counterpart of ``predictionio_tpu/workflow/core_workflow.py``:
:func:`run_train` trains an engine on the run's device and stores it as
an engine instance (INIT → models → COMPLETED); :func:`run_evaluation`
sweeps an evaluation's candidate grid and stores the evaluator's result
as an evaluation instance (EVALUATING → EVALCOMPLETED); :func:`load_models`
reads an instance's pickled model list; :func:`persist_instance` writes
models trained elsewhere (weights carried over from the JAX package, see
``models.recommendation.als_model_from_numpy`` and
``models.sequencerec.seqrec_model_from_numpy``) as a COMPLETED instance.
What the blob holds for each algorithm is its ``make_persistent``'s
answer: the model, a persistent-model manifest, or ``RETRAIN``.

The end of a training run is the JAX package's: the phase summary goes
into the instance env (``PIO_TRAIN_PHASES``), with the run's profile
(``PIO_TRAIN_PROFILE``); ``PIO_PERF_LEDGER`` names a ledger file that
gets one record; ``PIO_PROFILE_DIR`` has ``engine.train`` traced by
``torch.profiler``; the run's checkpoint directory is ``PIO_CKPT_DIR``
(kept) or one derived under the storage base directory (deleted after a
successful run); ``ctx.stop()`` runs in ``finally``.

A blob pickled by the JAX package names ``predictionio_tpu.`` classes,
and unpickling it would import jax; :func:`load_models` refuses such a
blob with an error that names the module. Models cross between the
packages as arrays, never as pickles.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import pickle
import re
import shutil
import time
from typing import Any, List, Optional, Sequence

from ..ckpt import DIR_ENV
from ..controller.dase import FOREIGN_ROOTS, ForeignModelError
from ..controller.engine import (
    Engine,
    EngineParams,
    WorkflowParams,
    serialize_engine_params,
)
from ..controller.evaluation import EngineParamsGenerator, Evaluation
from ..obs import perfledger
from ..storage import (
    STATUS_COMPLETED,
    STATUS_EVALCOMPLETED,
    STATUS_EVALUATING,
    EvaluationInstance,
    Model,
    StorageRegistry,
    new_engine_instance,
    utcnow,
)
from ..storage.registry import base_dir
from ..utils.profiling import (
    TRAIN_PHASES_ENV_KEY,
    TRAIN_PROFILE_ENV_KEY,
    device_trace,
    phases_to_env,
    profile_to_env,
)
from .context import WorkflowContext, pio_env_vars
from .version_check import check_upgrade

logger = logging.getLogger(__name__)

#: env naming the directory ``engine.train`` is traced into
PROFILE_DIR_ENV = "PIO_PROFILE_DIR"

class _PortUnpickler(pickle.Unpickler):
    """Unpickles the port's own blobs (models, the ``RETRAIN`` sentinel,
    persistent-model manifests) and refuses any class of the JAX package
    or jax before importing it."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in FOREIGN_ROOTS:
            raise ForeignModelError(
                f"model blob references {module}.{name}: it was pickled by "
                f"the JAX package ({module}); carry the arrays over instead "
                "(models.recommendation.als_model_from_numpy, "
                "models.sequencerec.seqrec_model_from_numpy)"
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


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    registry: StorageRegistry,
    engine_id: str = "default",
    engine_version: str = "1",
    engine_variant: str = "engine.json",
    engine_factory: str = "",
    workflow_params: WorkflowParams = WorkflowParams(),
    ctx: Optional[WorkflowContext] = None,
) -> str:
    """Train and persist; returns the engine instance id
    (``CoreWorkflow.runTrain``, ``CoreWorkflow.scala:43-93``).

    The context (default: a training context on ``cuda:0``, which raises
    where there is no CUDA) is resolved before the instance row is
    written. The row goes in as INIT; the models are trained
    (``Engine.train``, traced into ``PIO_PROFILE_DIR`` when it is set)
    and pickled into the model store; the row flips to COMPLETED with
    the phase summary (``PIO_TRAIN_PHASES``) and ``{"train_wall_s": …}``
    (``PIO_TRAIN_PROFILE``; the port keeps no jit-compile telemetry, so
    the JAX package's compile counts have no counterpart) in its env; a
    ledger record goes to ``PIO_PERF_LEDGER`` when it is set.

    ``ctx.checkpoint_every`` comes from ``workflow_params`` unless the
    caller set it. ``ctx.checkpoint_dir`` is ``PIO_CKPT_DIR`` when set
    (never deleted), else ``<base>/checkpoints/<engine id>/<engine
    version>/<batch>``, stable across reruns of one workflow so that a
    crashed run's rerun resumes from it, and deleted after a successful
    run. An interrupted run leaves the INIT row and its checkpoints
    behind (``CoreWorkflow.scala:83-88``). ``ctx.stop()`` runs in
    ``finally``."""
    ctx = ctx or WorkflowContext(mode="Training", batch=workflow_params.batch)
    try:
        check_upgrade("training", engine_factory)  # CoreWorkflow.scala:51
        if ctx.checkpoint_every is None:
            ctx.checkpoint_every = workflow_params.checkpoint_every
        derived_checkpoint_dir = False
        if ctx.checkpoint_dir is None:
            pinned = os.environ.get(DIR_ENV)
            if pinned:
                ctx.checkpoint_dir = pinned
            else:
                slug = re.sub(r"[^A-Za-z0-9_.-]", "_", workflow_params.batch) or "default"
                ctx.checkpoint_dir = os.path.join(
                    base_dir(), "checkpoints", engine_id, engine_version, slug)
                derived_checkpoint_dir = True
        md = registry.get_metadata()
        instance = new_engine_instance(
            engine_id=engine_id,
            engine_version=engine_version,
            engine_variant=engine_variant,
            engine_factory=engine_factory,
            batch=workflow_params.batch,
            env=pio_env_vars(),
            **serialize_engine_params(engine_params),
        )
        instance_id = md.engine_instance_insert(instance)
        try:
            t0 = time.monotonic()
            with device_trace(os.environ.get(PROFILE_DIR_ENV)):
                models = engine.train(ctx, engine_params, workflow_params)
            train_wall_s = time.monotonic() - t0
            logger.info("train phases: %s", ctx.timer.format_summary())
            persisted = engine.make_serializable_models(
                ctx, engine_params, instance_id, models
            )
            registry.get_models().insert(
                Model(id=instance_id, models=pickle.dumps(persisted))
            )
            stored = md.engine_instance_get(instance_id)
            phases = ctx.timer.summary()
            profile = {"train_wall_s": round(train_wall_s, 3)}
            env = dict(stored.env)
            env[TRAIN_PHASES_ENV_KEY] = phases_to_env(phases)
            env[TRAIN_PROFILE_ENV_KEY] = profile_to_env(profile)
            md.engine_instance_update(
                dataclasses.replace(
                    stored, status=STATUS_COMPLETED, end_time=utcnow(), env=env
                )
            )
            _append_perf_ledger(ctx, instance_id, train_wall_s, phases, profile)
            logger.info("Training completed; engine instance %s", instance_id)
            if derived_checkpoint_dir:
                # resume data serves a crashed run's rerun only; a caller's
                # PIO_CKPT_DIR may be shared and is left alone
                shutil.rmtree(ctx.checkpoint_dir, ignore_errors=True)
            return instance_id
        except KeyboardInterrupt:
            logger.warning("Training interrupted; instance %s stays INIT", instance_id)
            raise
    finally:
        ctx.stop()


def _append_perf_ledger(ctx: WorkflowContext, instance_id: str, train_wall_s: float,
                        phases: dict, profile: dict) -> None:
    """One ``train_wall_s`` record for this run in the ledger that
    ``PIO_PERF_LEDGER`` names. Best-effort: ledger trouble never fails a
    finished training run."""
    path = os.environ.get(perfledger.LEDGER_ENV)
    if not path:
        return
    try:
        device = "cpu"
        if ctx.device.type == "cuda":
            import torch

            device = f"{ctx.device} ({torch.cuda.get_device_name(ctx.device)})"
        perfledger.append_record(path, perfledger.make_record(
            source="train",
            metric="train_wall_s",
            value=train_wall_s,
            device=device,
            phases={name: round(s["total_s"], 4) for name, s in phases.items()},
            extra={"instanceId": instance_id, "profile": profile},
        ))
    except Exception:
        logger.exception("perf-ledger append failed (ignored)")


def run_evaluation(
    evaluation: Evaluation,
    engine_params_generator: EngineParamsGenerator,
    registry: StorageRegistry,
    workflow_params: WorkflowParams = WorkflowParams(),
    ctx: Optional[WorkflowContext] = None,
) -> str:
    """Full evaluation run; returns the evaluation instance id
    (``CoreWorkflow.runEvaluation``, ``CoreWorkflow.scala:95-144`` +
    ``EvaluationWorkflow.scala:68-81``).

    The context (default: an evaluation context on ``cuda:0``, which
    raises where there is no CUDA) is resolved before the instance row
    is written. The row goes in as EVALUATING; every candidate of the
    generator is evaluated (``Engine.batch_eval``, ``eval_parallelism``
    sweep threads, 0 = one per candidate), the evaluator scores them and
    picks the best, and the row flips to EVALCOMPLETED with the result's
    one-liner, HTML and JSON. A failed run leaves the EVALUATING row.
    An evaluation assigns no checkpoint directory, so its candidates
    train without checkpoints whatever the cadence says. ``ctx.stop()``
    runs in ``finally``."""
    ctx = ctx or WorkflowContext(mode="Evaluation", batch=workflow_params.batch)
    try:
        check_upgrade("evaluation", type(evaluation).__name__)  # CoreWorkflow.scala:108
        md = registry.get_metadata()
        now = utcnow()
        instance_id = md.evaluation_instance_insert(EvaluationInstance(
            id="",
            status=STATUS_EVALUATING,
            start_time=now,
            end_time=now,
            evaluation_class=type(evaluation).__name__,
            engine_params_generator_class=type(engine_params_generator).__name__,
            batch=workflow_params.batch,
            env=pio_env_vars(),
        ))
        engine, evaluator = evaluation.engine_evaluator
        params_list = engine_params_generator.engine_params_list
        parallelism = (workflow_params.eval_parallelism
                       if workflow_params.eval_parallelism > 0 else len(params_list))
        engine_eval_data = engine.batch_eval(ctx, params_list, workflow_params,
                                             parallelism=parallelism)
        result = evaluator.evaluate_base(ctx, evaluation, engine_eval_data,
                                         workflow_params, parallelism=parallelism)
        stored = md.evaluation_instance_get(instance_id)
        md.evaluation_instance_update(dataclasses.replace(
            stored,
            status=STATUS_EVALCOMPLETED,
            end_time=utcnow(),
            evaluator_results=result.one_liner(),
            evaluator_results_html=result.to_html(),
            evaluator_results_json=result.to_json(),
        ))
        logger.info("Evaluation completed; instance %s", instance_id)
        return instance_id
    finally:
        ctx.stop()
