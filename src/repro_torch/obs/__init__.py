"""Metrics registry and phase profiler (copies of the reference's
``obs/metrics.py`` and ``obs/profile.py``)."""
from repro_torch.obs.metrics import CATALOG, MetricsRegistry
from repro_torch.obs.profile import PHASES, PhaseProfiler

__all__ = ["CATALOG", "MetricsRegistry", "PHASES", "PhaseProfiler"]
