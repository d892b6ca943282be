"""REST plumbing of the port: the shared JSON HTTP server and the Event
Server (the query server lives in ``workflow/serving.py``)."""

from .event_server import (
    EventServer,
    EventServerConfig,
    StatsTracker,
    create_event_server,
)

__all__ = ["EventServer", "EventServerConfig", "StatsTracker", "create_event_server"]
