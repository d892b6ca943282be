"""WorkflowContext: per-run compute context.

Counterpart of ``predictionio_tpu/workflow/context.py``: where the JAX
package hands every DASE component a device mesh, the port hands it one
``torch.device`` (resolved once, with no fallback: see
:func:`..device.resolve_device`), plus the mode/batch labels, the
``PIO_*`` env passthrough of ``WorkflowContext.scala:78-97``, the run's
phase timer and its checkpoint directory.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..device import DeviceLike, resolve_device
from ..utils.profiling import StepTimer


def pio_env_vars(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Env vars starting with PIO_ (``WorkflowUtils.scala:212-217``)."""
    source = env if env is not None else dict(os.environ)
    return {k: v for k, v in source.items() if k.startswith("PIO_")}


class WorkflowContext:
    """Compute context: mode + batch labels, env, and the device."""

    def __init__(
        self,
        mode: str = "Training",
        batch: str = "",
        executor_env: Optional[Dict[str, str]] = None,
        device: DeviceLike = None,
    ):
        self.mode = mode
        self.batch = batch
        self.env = dict(executor_env if executor_env is not None else pio_env_vars())
        #: where this run's tensors live (``cuda:0`` unless asked otherwise)
        self.device = resolve_device(device)
        #: set to a dict to have the trainer record its timings in it
        #: (host prep, synchronised per-iteration seconds, kernel launches;
        #: see ``ops.als.als_train``)
        self.profile: Optional[dict] = None
        #: the workflow run's checkpoint cadence (``run_train`` sets it
        #: from ``WorkflowParams``); it sits between the engine params and
        #: ``PIO_CKPT_EVERY`` in ``ckpt.resolve_every``
        self.checkpoint_every: Optional[int] = None
        #: per-run phase timings (read, prepare, train[i], ...)
        self.timer = StepTimer()
        #: set by the training workflow to the run's checkpoint directory;
        #: a trainer with step checkpoints calls :meth:`checkpoint_manager`
        #: (single device) or :meth:`checkpoint_store` (the manifest-last
        #: store)
        self.checkpoint_dir: Optional[str] = None
        #: the index of the algorithm ``Engine.train`` is training, so each
        #: algorithm of one engine keeps its own checkpoints
        self.algorithm_index = 0

    def checkpoint_manager(self, subdir: Optional[str] = None, keep: int = 3):
        """A ``CheckpointManager`` for this run, or None when the workflow
        assigned no checkpoint directory (a bare ``Engine.train``, an
        evaluation). ``subdir`` namespaces independent training loops of
        one run (each algorithm of a multi-algorithm engine), so one loop
        never resumes from another's state."""
        if not self.checkpoint_dir:
            return None
        from .checkpoint import CheckpointManager

        d = self.checkpoint_dir
        if subdir:
            d = os.path.join(d, subdir)
        return CheckpointManager(d, keep=keep)

    def checkpoint_store(self, subdir: Optional[str] = None,
                         keep_last: Optional[int] = None,
                         keep_every: Optional[int] = None):
        """A ``ckpt.CheckpointStore`` for this run, or None when the
        workflow assigned no checkpoint directory. ``subdir`` as in
        :meth:`checkpoint_manager`; retention resolves from
        ``PIO_CKPT_KEEP_LAST`` / ``PIO_CKPT_KEEP_EVERY`` unless given."""
        if not self.checkpoint_dir:
            return None
        from ..ckpt import CheckpointStore, resolve_retention

        keep_last, keep_every = resolve_retention(keep_last, keep_every)
        d = self.checkpoint_dir
        if subdir:
            d = os.path.join(d, subdir)
        return CheckpointStore(d, keep_last=keep_last, keep_every=keep_every)

    def stop(self) -> None:
        """End of the run (``SparkContext.stop``; the workflows call it in
        ``finally``, on success and on failure). The context holds no mesh
        and no tensors; what a run leaves behind is device memory that
        PyTorch's caching allocator keeps after the run's tensors died (the
        staged buckets, a slice's systems, a sweep's tables). On a CUDA
        device those unused cached blocks go back to the card
        (``torch.cuda.empty_cache``, which frees only blocks no tensor
        uses); on the CPU there is nothing to release. The timer, the
        profile dict and the checkpoint settings stay readable."""
        if self.device.type == "cuda":
            import torch

            with torch.cuda.device(self.device):
                torch.cuda.empty_cache()

    @property
    def app_name(self) -> str:
        # "PredictionIO <mode>: <batch>" (WorkflowContext.scala:82-84)
        return f"PredictionIO {self.mode}: {self.batch}"

    def slices(self, n: int) -> list:
        """Up to ``n`` contexts over disjoint devices for a parallel
        hyperparameter sweep (``parallel.sweep``). One context holds one
        card, so this is ``[self]`` — what the JAX package returns for a
        one-device mesh — and a sweep with ``parallelism > 1`` runs its
        candidates one after another on one sweep thread. Slicing across
        several cards waits for sharded ALS (ROADMAP.md, queue 1 item
        11)."""
        return [self]
