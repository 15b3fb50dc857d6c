"""Observability: the metrics registry and phase profiler, the request
trace, the streaming carbon feed, the fleet rollup, the OpenMetrics
exposition, the SLO burn-rate alerts and the validation CLI (copies of the
reference's ``obs/metrics.py``, ``obs/profile.py``, ``obs/trace.py``,
``obs/carbon_feed.py``, ``obs/aggregate.py``, ``obs/export.py``,
``obs/slo.py`` and ``obs/validate.py``), and the :class:`Telemetry` bundle
a serving backend carries."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.aggregate import LABEL_KEYS, FleetRollup, \
    StreamingHistogram
from repro_torch.obs.carbon_feed import CarbonFeed, CarbonSnapshot
from repro_torch.obs.export import SnapshotWriter, parse_openmetrics, \
    to_openmetrics
from repro_torch.obs.metrics import CATALOG, Counter, Gauge, Histogram, \
    MetricsRegistry
from repro_torch.obs.profile import PHASES, PhaseProfiler
from repro_torch.obs.slo import AlertState, BurnRatePolicy, CarbonBudget, \
    LatencyObjective, SLOEvaluator, default_rules
from repro_torch.obs.trace import TraceRecorder, validate_chrome_events, \
    validate_trace

__all__ = ["AlertState", "BurnRatePolicy", "CATALOG", "CarbonBudget",
           "CarbonFeed", "CarbonSnapshot", "Counter", "FleetRollup",
           "Gauge", "Histogram", "LABEL_KEYS", "LatencyObjective",
           "MetricsRegistry", "PHASES", "PhaseProfiler", "SLOEvaluator",
           "SnapshotWriter", "StreamingHistogram", "Telemetry",
           "TraceRecorder", "default_rules", "parse_openmetrics",
           "to_openmetrics", "validate_chrome_events", "validate_trace"]


@dataclasses.dataclass
class Telemetry:
    """The bundle a serving backend carries: its metrics registry plus the
    optional trace recorder and carbon feed.

    Lifecycle contract: ``tracer`` and ``feed`` are *persistent* — a probe
    loop reuses them across serve sessions so traces concatenate and the
    feed streams continuously.  ``registry`` is *per session* on the real
    engine (each serve session opens a fresh standard registry and
    ``stats()`` reads the last one); the fluid backend keeps one registry
    for its life."""

    registry: MetricsRegistry = None
    tracer: Optional[TraceRecorder] = None
    feed: Optional[CarbonFeed] = None
    backend: str = "backend"

    def __post_init__(self) -> None:
        if self.registry is None:
            self.registry = MetricsRegistry.standard(self.backend)
