"""Train/eval workflow process — the ``CreateWorkflow`` analogue.

Copy of ``predictionio_tpu/tools/run_workflow.py``, a rebuild of
``core/src/main/scala/io/prediction/workflow/CreateWorkflow.scala``: the
``main`` of every ``pio train`` / ``pio eval``. Run it as
``python -m predictionio_tpu_torch.tools.run_workflow --engine-dir DIR``
to train the engine of ``DIR/engine.json``, or with
``--evaluation-class`` (and ``--engine-params-generator-class``) to sweep
an evaluation; or call :func:`run` in process. It prints
``{"engineInstanceId": ..., "kernelLaunches": {...}}`` (the evaluation
instance's id for an evaluation; the launches of each CUDA kernel in
the run).

``--device`` picks the card or the host (default: ``cuda:0``, which
raises where there is no CUDA; ``--device cpu`` runs on the host). The
JAX package's platform and compilation-cache plumbing has no
counterpart. ``--shards`` above 1 and ``--checkpoint-every`` above 0 are
refused (sharded ALS and checkpointed training are not ported);
``--resume`` sets ``PIO_CKPT_RESUME`` as the JAX package does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional, Sequence

from ..ckpt import RESUME_ENV
from ..controller.engine import WorkflowParams
from ..controller.evaluation import EngineParamsGenerator
from ..device import DeviceLike
from ..ops.cuda_kernels import kernel_launches
from ..ops.als_sharded import SHARDS_ENV
from ..storage import StorageRegistry, get_registry
from ..workflow import loader
from ..workflow.context import WorkflowContext
from ..workflow.core_workflow import run_evaluation, run_train
from .register import ENGINE_JSON, load_engine_dir

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    """Flag grammar (``CreateWorkflow.scala:87-140``)."""
    p = argparse.ArgumentParser(prog="run_workflow")
    p.add_argument("--engine-dir", default=".", help="engine project directory")
    p.add_argument("--engine-id", default=None)
    p.add_argument("--engine-version", default=None)
    p.add_argument("--engine-variant", default="engine.json")
    p.add_argument("--engine-factory", default=None)
    p.add_argument("--engine-params-key", default=None)
    p.add_argument("--evaluation-class", default=None)
    p.add_argument("--engine-params-generator-class", default=None)
    p.add_argument("--batch", default="")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="where the run computes: 'cuda', 'cuda:N' or 'cpu' "
             "(default: cuda:0, which raises without CUDA)",
    )
    p.add_argument(
        "--eval-parallelism", type=int, default=0,
        help="sweep threads (0 = one per candidate, bounded by the "
             "context's slices: one on one card; 1 = serial)",
    )
    p.add_argument(
        "--shards", type=int, default=None, metavar="N",
        help="sets PIO_TRAIN_SHARDS for this run; above 1 the port refuses "
             "(sharded ALS is not ported)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="N",
        help="the run's checkpoint cadence; above 0 the port refuses "
             "(checkpointed training is not ported)",
    )
    p.add_argument(
        "--resume", default=None, action=argparse.BooleanOptionalAction,
        help="sets PIO_CKPT_RESUME for this run (1 or 0)",
    )
    return p


def run(args: argparse.Namespace, registry: Optional[StorageRegistry] = None,
        device: DeviceLike = None) -> str:
    """Execute one train or eval run; returns the instance id
    (``CreateWorkflow.main``, ``CreateWorkflow.scala:142-279``).
    ``device`` (else ``args.device``, else ``cuda:0``) is the run's
    device. ``--shards`` and ``--resume`` reach the algorithm through the
    environment, scoped to this run, as in the JAX package."""
    loader.modify_logging(args.verbose)
    env = {}
    if args.resume is not None:
        env[RESUME_ENV] = "1" if args.resume else "0"
    if args.shards is not None:
        # an explicit 0 must reach resolve_shards and fail there
        env[SHARDS_ENV] = str(args.shards)
    prior = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return _run_inner(args, registry, device if device is not None else args.device)
    finally:
        for key, value in prior.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _run_inner(args: argparse.Namespace, registry: Optional[StorageRegistry],
               device: DeviceLike) -> str:
    wp = WorkflowParams(
        batch=args.batch,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
        eval_parallelism=args.eval_parallelism,
        checkpoint_every=args.checkpoint_every,
    )
    # runtimeConf binds to every run, train and eval (WorkflowUtils.scala:
    # 321-339). An evaluation may come without an engine.json (its class
    # carries the engine); a present one is always applied.
    ed = None
    if not args.evaluation_class or os.path.exists(
            os.path.join(args.engine_dir, ENGINE_JSON)):
        ed = load_engine_dir(args.engine_dir)
        loader.apply_runtime_conf(ed.variant)
    registry = registry or get_registry()

    if args.evaluation_class:
        # the eval path (CreateWorkflow.scala:180-199,264-277)
        evaluation = loader.get_evaluation(args.evaluation_class, args.engine_dir)
        if args.engine_params_generator_class:
            generator = loader.get_engine_params_generator(
                args.engine_params_generator_class, args.engine_dir)
        else:
            # an Evaluation may carry its engine's default params
            # (Evaluation.scala:59-124)
            generator = EngineParamsGenerator(
                [evaluation.engine.default_engine_params()]
                if hasattr(evaluation.engine, "default_engine_params") else []
            )
        ctx = WorkflowContext(mode="Evaluation", batch=wp.batch, device=device)
        return run_evaluation(evaluation, generator, registry, workflow_params=wp, ctx=ctx)

    # the train path (CreateWorkflow.scala:219-263)
    factory = args.engine_factory or ed.engine_factory
    engine = loader.get_engine(factory, search_dir=ed.path)
    if args.engine_params_key:
        # programmatic params: the factory object exposes engine_params(key)
        # (CreateWorkflow.scala:227-231)
        engine_params = loader.load_object(factory, ed.path).engine_params(
            args.engine_params_key)
    else:
        engine_params = engine.json_to_engine_params(ed.variant)
    ctx = WorkflowContext(mode="Training", batch=wp.batch, device=device)
    return run_train(
        engine,
        engine_params,
        registry,
        engine_id=args.engine_id or ed.manifest.id,
        engine_version=args.engine_version or ed.manifest.version,
        engine_variant=args.engine_variant,
        engine_factory=factory,
        workflow_params=wp,
        ctx=ctx,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    instance_id = run(args)
    # this process's kernel launches: the run's own (a fresh process)
    print(json.dumps({"engineInstanceId": instance_id, "kernelLaunches": kernel_launches()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
