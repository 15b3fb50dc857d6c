"""Streaming carbon telemetry: a measure-every-N-seconds energy/CO2 feed
(a copy of the reference package's ``obs/carbon_feed.py``; the consumers
named below are the reference's, of which the port has the engine).

codecarbon idiom: instead of one post-hoc total, energy and emissions are
*streamed* — the feed accumulates measured segments (or integrates a power
reading against the clock) and every ``interval_s`` seconds emits a
:class:`CarbonSnapshot` carrying the window's joules / gCO2 / mean power /
carbon intensity plus the running totals.  Consumers subscribe:

  * ``Controller.maybe_reoptimize`` reads :meth:`CarbonFeed.latest` to act
    on *measured* CI + load instead of a trace lookup alone;
  * ``fleet_sim`` keeps one feed per region and heartbeats it at window
    boundaries, so a fleet run yields a per-region emissions time series;
  * ``benchmarks/run.py`` folds feed snapshots into the benchmark JSON.

Conservation by construction: when a ``core.carbon.CarbonAccountant`` is
given a feed, every ``add()`` forwards its *exact* joules/grams through
:meth:`record_segment` — so ``feed.energy_j_total`` equals the accountant's
total to the last bit, and the tests assert it.

Two ingestion styles:

  * **segment** (:meth:`record_segment`): the caller already measured a
    (t_start, duration, joules) segment — the accountant path;
  * **sampler** (:meth:`sample`): the caller only knows the *current* power
    draw; the feed integrates it over the gap since the previous sample —
    the codecarbon "measure every N seconds" path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

__all__ = ["CarbonFeed", "CarbonSnapshot"]

_J_PER_KWH = 3.6e6


@dataclasses.dataclass
class CarbonSnapshot:
    """One emitted window of the feed (all energies joules, carbon grams)."""
    t: float                    # window end (feed clock, seconds)
    region: str
    window_s: float             # width of this window
    energy_j: float             # joules accumulated in the window
    carbon_g: float             # gCO2 accumulated in the window
    power_w: float              # mean power over the window
    ci_g_per_kwh: float         # carbon intensity at window end
    energy_j_total: float       # running totals since feed creation
    carbon_g_total: float
    sla_ok_frac: Optional[float] = None   # caller-provided SLA health, if any


class CarbonFeed:
    """Per-region streaming energy/CO2 telemetry (codecarbon idiom).

    ``ci`` is a constant (gCO2/kWh) or a callable ``ci(t)`` — e.g. a
    ``CarbonIntensityTrace.at`` bound method.  Segments whose carbon was
    not pre-computed get midpoint-CI × PUE, the ``CarbonAccountant``
    convention, so both ingestion styles land on the same accounting."""

    def __init__(self, ci: Union[float, Callable[[float], float]] = 0.0,
                 interval_s: float = 60.0, region: str = "region",
                 pue: float = 1.0):
        self.ci_fn: Callable[[float], float] = \
            ci if callable(ci) else (lambda _t, _c=float(ci): _c)
        self.interval_s = float(interval_s)
        self.region = region
        self.pue = float(pue)
        self.energy_j_total = 0.0
        self.carbon_g_total = 0.0
        self.snapshots: List[CarbonSnapshot] = []
        self._subs: List[Callable[[CarbonSnapshot], None]] = []
        # current accumulation window
        self._win_j = 0.0
        self._win_g = 0.0
        self._win_t0: Optional[float] = None  # start of the open window
        self._last_sample_t: Optional[float] = None

    # --- ingestion -----------------------------------------------------------
    def record_segment(self, t_start: float, duration_s: float,
                       energy_j: float, carbon_g: Optional[float] = None
                       ) -> None:
        """Ingest one measured segment.  ``carbon_g=None`` → midpoint-CI ×
        PUE (the accountant's own convention); an accountant wired to this
        feed passes its exact grams, making feed totals == accountant
        totals with no re-derivation."""
        if carbon_g is None:
            ci = self.ci_fn(t_start + 0.5 * duration_s)
            carbon_g = energy_j / _J_PER_KWH * ci * self.pue
        if self._win_t0 is None:
            self._win_t0 = float(t_start)
        self._win_j += float(energy_j)
        self._win_g += float(carbon_g)
        self.heartbeat(t_start + duration_s)

    def sample(self, t: float, power_w: float) -> None:
        """Sampler ingestion: integrate ``power_w`` over the gap since the
        previous sample (the first call only anchors the clock)."""
        if self._last_sample_t is not None and t > self._last_sample_t:
            dt = t - self._last_sample_t
            self.record_segment(self._last_sample_t, dt, power_w * dt)
        self._last_sample_t = float(t)

    # --- emission ------------------------------------------------------------
    def heartbeat(self, t: float, sla_ok_frac: Optional[float] = None,
                  force: bool = False) -> Optional[CarbonSnapshot]:
        """Emit a snapshot if the open window has reached ``interval_s``
        (or ``force`` — fleet window boundaries force-flush so each region
        window lands in its own snapshot).  Returns the snapshot emitted,
        if any."""
        if self._win_t0 is None:
            return None
        width = t - self._win_t0
        if not force and width < self.interval_s:
            return None
        self.energy_j_total += self._win_j
        self.carbon_g_total += self._win_g
        snap = CarbonSnapshot(
            t=float(t), region=self.region, window_s=float(width),
            energy_j=self._win_j, carbon_g=self._win_g,
            power_w=self._win_j / width if width > 0 else 0.0,
            ci_g_per_kwh=float(self.ci_fn(t)),
            energy_j_total=self.energy_j_total,
            carbon_g_total=self.carbon_g_total,
            sla_ok_frac=sla_ok_frac)
        self.snapshots.append(snap)
        self._win_j = 0.0
        self._win_g = 0.0
        self._win_t0 = None
        for cb in self._subs:
            cb(snap)
        return snap

    def flush(self, t: float, sla_ok_frac: Optional[float] = None
              ) -> Optional[CarbonSnapshot]:
        """Force-emit whatever the open window holds (end of a session)."""
        return self.heartbeat(t, sla_ok_frac=sla_ok_frac, force=True)

    # --- consumption ---------------------------------------------------------
    def subscribe(self, cb: Callable[[CarbonSnapshot], None]) -> None:
        self._subs.append(cb)

    def latest(self) -> Optional[CarbonSnapshot]:
        return self.snapshots[-1] if self.snapshots else None

    @property
    def pending_energy_j(self) -> float:
        """Joules ingested but not yet emitted in a snapshot."""
        return self._win_j
