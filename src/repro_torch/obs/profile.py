"""Phase-level profiling: wall-clock timers for the engine hot phases.

EcoServe's observation (PAPERS.md) is that carbon-aware decisions need
*per-phase* attribution — prefill and decode have different power and
latency profiles, and swaps are pure overhead.  This module is the
plumbing: engines call :meth:`PhaseProfiler.observe` (or wrap code in
:meth:`span`) with one of the canonical :data:`PHASES`, and each sample
lands as a ``phase``-labeled child of the ``phase_latency_s`` CATALOG
histogram on whatever registry the current session attached.

The profiler is a tiny mutable shim rather than a registry wrapper
because engine sessions swap registries per ``submit()`` call: the engine
owns ONE profiler, repoints ``profiler.registry`` at session open, and
sets it to ``None`` when no telemetry is attached — then every ``observe``
is a single attribute check, which keeps the zero-telemetry hot path at
zero cost (the overhead gate in ``benchmarks/run.py`` holds the whole
plane, profiling included, under 5% of tokens/s).

The canonical phases:

  * ``prefill_chunk``  — one prefill call (paged chunked);
  * ``decode_dispatch`` — host time to *launch* decode step(s)
    (async dispatch; device work overlaps);
  * ``decode_land``     — blocking readback of a dispatched decode
    (the host-sync cost the pipelined path hides);
  * ``swap_d2h``        — preemption KV swap-out (device→host staging);
  * ``swap_h2d``        — resume KV swap-in (host→device restore).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["PHASES", "PhaseProfiler"]

PHASES = ("prefill_chunk", "decode_dispatch", "decode_land",
          "swap_d2h", "swap_h2d")


class PhaseProfiler:
    """Routes phase timings into a (swappable) registry's labeled
    ``phase_latency_s`` histogram.  ``registry=None`` disables it.

    ``role`` (disaggregated serving) adds a constant ``role`` label to
    every sample — a disagg engine owns one profiler per worker pool, so
    phase latency splits prefill-pool vs decode-pool without any change
    to the engine's observe call sites."""

    __slots__ = ("registry", "role")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 role: Optional[str] = None):
        self.registry = registry
        self.role = role

    def observe(self, phase: str, seconds: float) -> None:
        reg = self.registry
        if reg is None:
            return
        assert phase in PHASES, f"unknown phase {phase!r}"
        if self.role is None:
            reg.labeled("phase_latency_s", phase=phase).observe(seconds)
        else:
            reg.labeled("phase_latency_s", phase=phase,
                        role=self.role).observe(seconds)

    @contextmanager
    def span(self, phase: str):
        """``with profiler.span("swap_d2h"): ...`` — times the block and
        observes it (still observed if the block raises)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(phase, time.perf_counter() - t0)
