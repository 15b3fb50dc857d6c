"""Observability: the metrics registry and phase profiler, the request
trace and the streaming carbon feed (copies of the reference's
``obs/metrics.py``, ``obs/profile.py``, ``obs/trace.py`` and
``obs/carbon_feed.py``), and the :class:`Telemetry` bundle a serving
engine carries."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.carbon_feed import CarbonFeed, CarbonSnapshot
from repro_torch.obs.metrics import CATALOG, MetricsRegistry
from repro_torch.obs.profile import PHASES, PhaseProfiler
from repro_torch.obs.trace import TraceRecorder, validate_chrome_events, \
    validate_trace

__all__ = ["CATALOG", "CarbonFeed", "CarbonSnapshot", "MetricsRegistry",
           "PHASES", "PhaseProfiler", "Telemetry", "TraceRecorder",
           "validate_chrome_events", "validate_trace"]


@dataclasses.dataclass
class Telemetry:
    """The bundle a serving backend carries: its metrics registry plus the
    optional trace recorder and carbon feed.

    Lifecycle contract: ``tracer`` and ``feed`` are *persistent* — a probe
    loop reuses them across serve sessions so traces concatenate and the
    feed streams continuously.  ``registry`` is *per session* on the real
    engine (each serve session opens a fresh standard registry and
    ``stats()`` reads the last one)."""

    registry: MetricsRegistry = None
    tracer: Optional[TraceRecorder] = None
    feed: Optional[CarbonFeed] = None
    backend: str = "backend"

    def __post_init__(self) -> None:
        if self.registry is None:
            self.registry = MetricsRegistry.standard(self.backend)
