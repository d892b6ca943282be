"""Observability plane of the port: the metrics registry and its
Prometheus exposition (``GET /metrics``)."""

from .metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]
