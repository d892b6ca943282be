"""Observability plane of the port: the metrics registry and its
Prometheus exposition (``GET /metrics``), request tracing
(``/traces.json``), the flight recorder and stall watchdog
(``/blackbox.json``), the SLO engine and health plane (``/health.json``)
and the ``pio trace`` scraper."""

from .metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]
