"""Carbon-intensity traces and carbon accounting (paper §2, Fig. 4/8) — the
port's copy of the reference package's ``core/carbon.py``.

Carbon Footprint = Energy × Carbon Intensity (× PUE).  The generators
reproduce the statistical structure the paper reports for each grid and
season (Fig. 8): diurnal solar valleys for California (deep in March,
shallower in September), wind-driven irregular oscillation for the UK.  A
CSV loader accepts real traces (ElectricityMaps-style exports) with
identical downstream behaviour.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

PUE_DEFAULT = 1.5          # Uptime Institute 2022 survey value used by the paper


@dataclasses.dataclass
class CarbonTrace:
    """Piecewise-linear carbon intensity over time (gCO2/kWh)."""
    name: str
    times_s: np.ndarray          # (n,) seconds, ascending
    intensity: np.ndarray        # (n,) gCO2/kWh

    def at(self, t: float) -> float:
        return float(np.interp(t, self.times_s, self.intensity))

    @property
    def duration_s(self) -> float:
        return float(self.times_s[-1])

    def mean(self) -> float:
        return float(np.trapezoid(self.intensity, self.times_s) / self.duration_s)

    # --- forecast hooks (fleet/forecast.py builds on these) -----------------
    def history(self, t: float) -> "CarbonTrace":
        """Samples observable at wall-clock ``t`` (times_s ≤ t) — the only
        view an *honest* online forecaster may fit on."""
        n = int(np.searchsorted(self.times_s, t, side="right"))
        n = max(n, 1)
        return CarbonTrace(self.name, self.times_s[:n], self.intensity[:n])

    def slice(self, t0: float, t1: float, rebase: bool = True) -> "CarbonTrace":
        """Sub-trace over [t0, t1] with interpolated endpoints; ``rebase``
        shifts the time axis so the slice starts at 0 (what a per-region
        backtest or a re-planning window wants)."""
        t0 = max(t0, float(self.times_s[0]))
        t1 = min(t1, float(self.times_s[-1]))
        if t1 <= t0:
            raise ValueError(f"empty slice [{t0}, {t1}] of {self.name}")
        inner = (self.times_s > t0) & (self.times_s < t1)
        ts = np.concatenate(([t0], self.times_s[inner], [t1]))
        ci = np.concatenate(([self.at(t0)], self.intensity[inner], [self.at(t1)]))
        if rebase:
            ts = ts - t0
        return CarbonTrace(self.name, ts, ci)

    def window_mean(self, t0: float, t1: float) -> float:
        """Time-averaged intensity over [t0, t1] (trapezoid rule) — the CI a
        fluid window serving uniformly across the interval actually sees."""
        s = self.slice(t0, t1, rebase=False)
        return float(np.trapezoid(s.intensity, s.times_s) / (s.times_s[-1] - s.times_s[0]))


def _diurnal(hours: np.ndarray, base: float, solar_dip: float, noise: float,
             wind: float, seed: int, dip_width: float = 4.0,
             dip_center: float = 13.0) -> np.ndarray:
    """base - solar midday dip + slow wind oscillation + AR(1) noise."""
    rng = np.random.default_rng(seed)
    tod = hours % 24.0
    dip = solar_dip * np.exp(-0.5 * ((tod - dip_center) / dip_width) ** 2)
    slow = wind * np.sin(2 * np.pi * hours / 37.0 + rng.uniform(0, 2 * np.pi))
    ar = np.zeros_like(hours)
    e = rng.normal(0, noise, size=len(hours))
    for i in range(1, len(hours)):
        ar[i] = 0.92 * ar[i - 1] + e[i]
    evening = 0.25 * solar_dip * np.exp(-0.5 * ((tod - 20.0) / 2.0) ** 2)
    return np.clip(base - dip + evening + slow + ar, 40.0, None)


def make_trace(region: str = "CISO-March", hours: float = 48.0,
               step_s: float = 300.0, seed: int = 7) -> CarbonTrace:
    """Synthetic trace calibrated to the paper's Fig. 8 envelopes."""
    t = np.arange(0.0, hours * 3600.0 + step_s, step_s)
    h = t / 3600.0
    if region == "CISO-March":        # deep solar valleys: ~100-320
        ci = _diurnal(h, base=290.0, solar_dip=190.0, noise=6.0, wind=18.0, seed=seed)
    elif region == "CISO-September":  # hotter, shallower valleys: ~180-380
        ci = _diurnal(h, base=340.0, solar_dip=140.0, noise=7.0, wind=20.0,
                      seed=seed + 1, dip_width=3.2)
    elif region == "ESO-March":       # UK wind-driven, irregular: ~80-300
        ci = _diurnal(h, base=210.0, solar_dip=60.0, noise=10.0, wind=70.0,
                      seed=seed + 2, dip_width=3.0)
    else:
        raise KeyError(f"unknown region {region!r}")
    return CarbonTrace(region, t, ci)


_TIME_COL_HINTS = ("datetime", "timestamp", "date", "time", "seconds")
_CI_COL_HINTS = ("carbon_intensity", "carbon intensity", "gco2", "co2",
                 "intensity")


def _parse_time_s(value: str) -> Tuple[float, bool]:
    """(seconds, was_datetime) from a CSV cell: plain numbers pass through;
    ISO-8601 timestamps (ElectricityMaps exports, with or without a trailing
    Z) become epoch seconds.  Naive stamps are taken as UTC — resolving them
    in the host's local timezone would make the same file load differently
    per machine and corrupt spacing across DST transitions."""
    try:
        return float(value), False
    except ValueError:
        pass
    import datetime as _dt
    v = value.strip().replace("Z", "+00:00")
    dt = _dt.datetime.fromisoformat(v)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.timestamp(), True


def load_trace_csv(path: str, name: Optional[str] = None,
                   time_col: Optional[str] = None,
                   ci_col: Optional[str] = None) -> CarbonTrace:
    """Load a carbon-intensity trace from CSV.

    Accepts both the repo's own ``seconds,gco2_per_kwh`` format and
    ElectricityMaps-style exports: a timestamp column (ISO-8601 datetimes
    *or* plain seconds — sniffed by header name, overridable via
    ``time_col``) plus a gCO2/kWh column (any header containing "carbon
    intensity"/"gco2"/…, overridable via ``ci_col``), with arbitrary extra
    columns, irregular sample spacing and unsorted rows.  Datetime stamps
    are rebased so the trace starts at t = 0; duplicate timestamps keep the
    last sample."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty trace CSV {path}")
    cols = list(rows[0].keys())

    def find(requested: Optional[str], hints) -> str:
        if requested is not None:
            if requested not in cols:
                raise KeyError(f"column {requested!r} not in {cols}")
            return requested
        for hint in hints:
            for c in cols:
                if c is not None and hint in c.strip().lower():
                    return c
        raise KeyError(f"no column matching {hints} in {cols}")

    tc = find(time_col, _TIME_COL_HINTS)
    cc = find(ci_col, _CI_COL_HINTS)
    samples = {}
    any_datetime = False
    for row in rows:
        t_raw, ci_raw = row.get(tc), row.get(cc)
        if not t_raw or not t_raw.strip() or not ci_raw or not ci_raw.strip():
            continue                    # gaps in real exports: skip the row
        t_s, was_dt = _parse_time_s(t_raw)
        any_datetime |= was_dt
        samples[t_s] = float(ci_raw)
    if len(samples) < 2:
        raise ValueError(f"{path}: fewer than 2 usable samples")
    ts = np.array(sorted(samples))
    ci = np.array([samples[t] for t in ts])
    if any_datetime:
        ts = ts - ts[0]                 # epoch stamps → trace-relative seconds
    return CarbonTrace(name or path, ts, ci)


# =============================================================================
# accounting
# =============================================================================
@dataclasses.dataclass
class CarbonAccountant:
    """Integrates energy → operational carbon at time-varying intensity.
    Mirrors the paper's carbontracker-based measurement service."""
    trace: CarbonTrace
    pue: float = PUE_DEFAULT
    energy_j: float = 0.0
    carbon_g: float = 0.0
    # optional streaming telemetry (repro_torch.obs.carbon_feed.CarbonFeed): every
    # add() forwards its EXACT joules/grams, so feed totals equal the
    # accountant's with no re-derivation (conservation by construction)
    feed: Optional[object] = None

    def add(self, t_start: float, duration_s: float, power_w: float) -> float:
        """Account ``power_w`` drawn for ``duration_s`` starting at t_start.
        Returns grams CO2 emitted."""
        e_j = power_w * duration_s
        ci = self.trace.at(t_start + 0.5 * duration_s)   # midpoint rule
        g = (e_j / 3.6e6) * ci * self.pue                # J → kWh → gCO2
        self.energy_j += e_j
        self.carbon_g += g
        if self.feed is not None:
            self.feed.record_segment(t_start, duration_s, e_j, g)
        return g

    def grams_for(self, energy_j: float, ci: float) -> float:
        return (energy_j / 3.6e6) * ci * self.pue
