"""Carbon-intensity traces (paper §2, Fig. 4/8) — the port's copy of the
reference package's ``core/carbon.py``, trimmed to the synthetic traces
Clover's real-mode control loop reads (:func:`make_trace`,
:meth:`CarbonTrace.at`).

Carbon Footprint = Energy × Carbon Intensity (× PUE).  The generators
reproduce the statistical structure the paper reports for each grid and
season (Fig. 8): diurnal solar valleys for California (deep in March,
shallower in September), wind-driven irregular oscillation for the UK.
"""
from __future__ import annotations

import dataclasses

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
        return float(np.trapezoid(self.intensity, self.times_s)
                     / self.duration_s)


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
        ci = _diurnal(h, base=290.0, solar_dip=190.0, noise=6.0, wind=18.0,
                      seed=seed)
    elif region == "CISO-September":  # hotter, shallower valleys: ~180-380
        ci = _diurnal(h, base=340.0, solar_dip=140.0, noise=7.0, wind=20.0,
                      seed=seed + 1, dip_width=3.2)
    elif region == "ESO-March":       # UK wind-driven, irregular: ~80-300
        ci = _diurnal(h, base=210.0, solar_dip=60.0, noise=10.0, wind=70.0,
                      seed=seed + 2, dip_width=3.0)
    else:
        raise KeyError(f"unknown region {region!r}")
    return CarbonTrace(region, t, ci)
