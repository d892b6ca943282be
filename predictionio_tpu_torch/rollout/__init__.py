"""Rollout plane: shadow serving, canary splits, metric-gated promotion.

Copy of ``predictionio_tpu/rollout``: a candidate ``EngineInstance`` goes
trained → SHADOW → CANARY → LIVE through a durable
:class:`~..storage.metadata.RolloutPlan`, and rolls back at any stage
when a promotion gate (error-rate delta, p99 ratio, shadow divergence,
served-score PSI over sliding windows) fails. Both deployments are
resident on the card and every query of either goes through the top-k
kernel.

- :mod:`.plan` — gate config, deterministic sticky splits, divergence
- :mod:`.controller` — sliding windows and promote/hold/rollback verdicts
- :mod:`.manager` — the query server's lifecycle state machine
"""

from .controller import RolloutController, VariantWindow
from .manager import RolloutError, RolloutManager
from .plan import (
    BASELINE,
    CANDIDATE,
    VARIANT_HEADER,
    GateConfig,
    prediction_divergence,
    sticky_key,
    variant_for_key,
)

__all__ = [
    "BASELINE",
    "CANDIDATE",
    "GateConfig",
    "RolloutController",
    "RolloutError",
    "RolloutManager",
    "VARIANT_HEADER",
    "VariantWindow",
    "prediction_divergence",
    "sticky_key",
    "variant_for_key",
]
