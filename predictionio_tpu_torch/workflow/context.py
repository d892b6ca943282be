"""WorkflowContext: per-run compute context.

Counterpart of ``predictionio_tpu/workflow/context.py``: where the JAX
package hands every DASE component a device mesh, the port hands it one
``torch.device`` (resolved once, with no fallback: see
:func:`..device.resolve_device`), plus the mode/batch labels and the
``PIO_*`` env passthrough of ``WorkflowContext.scala:78-97``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..device import DeviceLike, resolve_device


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
