"""Carbon-intensity forecasting over ``CarbonTrace`` (fleet layer) — the
port's copy of the reference package's ``fleet/forecast.py``.

Clover's controller is reactive: it re-optimizes after the grid has already
moved ≥ 5 %.  The fleet layer wants to act *ahead* of the move — shift
deferrable work into tomorrow's solar valley, pre-reconfigure before the
evening ramp — which needs a forecast of carbon intensity at t + horizon.

Two honest online baselines (both only ever read trace samples ≤ t, via
``CarbonTrace.history``):

  PersistenceForecaster      — ci_hat(t + h) = ci(t).  Strong at short
                               horizons, blind to the diurnal cycle.
  DiurnalHarmonicForecaster  — least-squares regression of the recent history
                               on a truncated Fourier basis of the 24 h cycle
                               (mean + K sin/cos harmonics).  Captures solar
                               valleys and evening ramps hours ahead; the
                               residual wind/AR noise is irreducible for it.

``backtest`` replays a forecaster over a trace and reports MAE/RMSE/MAPE per
horizon, so region×forecaster choices are data-driven rather than asserted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.carbon import CarbonTrace

DAY_S = 24 * 3600.0


class Forecaster:
    """Common API: ``predict(t, horizon_s)`` → forecast CI at t + horizon_s,
    fitted only on samples observable at wall-clock ``t``."""

    name = "abstract"

    def __init__(self, trace: CarbonTrace):
        self.trace = trace

    def predict(self, t: float, horizon_s: float) -> float:
        raise NotImplementedError

    def predict_series(self, t: float, horizon_s: float,
                       step_s: float) -> np.ndarray:
        """Forecast CI at t + step, t + 2·step, … up to t + horizon_s."""
        hs = np.arange(step_s, horizon_s + 0.5 * step_s, step_s)
        return np.array([self.predict(t, float(h)) for h in hs])


class PersistenceForecaster(Forecaster):
    name = "persistence"

    def predict(self, t: float, horizon_s: float) -> float:
        return self.trace.at(min(t, self.trace.duration_s))


class DiurnalHarmonicForecaster(Forecaster):
    """ci(t) ≈ β0 + Σ_k βk·sin(2πkt/24h) + γk·cos(2πkt/24h), fitted by least
    squares on a sliding history window and cached between refits."""

    name = "harmonic"

    def __init__(self, trace: CarbonTrace, n_harmonics: int = 3,
                 fit_window_s: float = 36 * 3600.0,
                 refit_every_s: float = 1800.0):
        super().__init__(trace)
        self.n_harmonics = n_harmonics
        self.fit_window_s = fit_window_s
        self.refit_every_s = refit_every_s
        self._beta: Optional[np.ndarray] = None
        self._fit_t: float = -math.inf

    def _design(self, times_s: np.ndarray) -> np.ndarray:
        cols = [np.ones_like(times_s)]
        for k in range(1, self.n_harmonics + 1):
            w = 2.0 * math.pi * k * times_s / DAY_S
            cols.append(np.sin(w))
            cols.append(np.cos(w))
        return np.stack(cols, axis=1)

    def _min_samples(self) -> int:
        return 2 * (2 * self.n_harmonics + 1)

    def _fit(self, t: float) -> None:
        hist = self.trace.history(t)
        keep = hist.times_s >= t - self.fit_window_s
        ts, ci = hist.times_s[keep], hist.intensity[keep]
        if len(ts) < self._min_samples():
            self._beta = None            # cold start → fall back to persistence
        else:
            X = self._design(ts)
            self._beta, *_ = np.linalg.lstsq(X, ci, rcond=None)
        self._fit_t = t

    def predict(self, t: float, horizon_s: float) -> float:
        if t - self._fit_t >= self.refit_every_s or t < self._fit_t:
            self._fit(t)
        if self._beta is None:
            return self.trace.at(min(t, self.trace.duration_s))
        x = self._design(np.array([t + horizon_s]))
        return max(float(x[0] @ self._beta), 1.0)


class EnsembleForecaster(Forecaster):
    """Inverse-error weighted blend of persistence and diurnal-harmonic.

    Grids differ in how forecastable they are: solar-dominated CISO is nearly
    periodic (harmonic wins), wind-dominated ESO has a ~37 h oscillation that
    a 24 h Fourier basis cannot represent (persistence wins).  Rather than
    asking the operator to know this per region, the ensemble scores each
    member on a rolling *honest* backtest (predictions issued from past
    wall-clocks using only their own history) and weights by 1/(MAE + ε), so
    each region automatically leans on whichever model its grid rewards."""

    name = "ensemble"

    def __init__(self, trace: CarbonTrace, eval_horizon_s: float = 6 * 3600.0,
                 eval_window_s: float = 24 * 3600.0,
                 eval_step_s: float = 3600.0, refit_every_s: float = 3600.0):
        super().__init__(trace)
        self.members = [PersistenceForecaster(trace),
                        DiurnalHarmonicForecaster(trace)]
        self.eval_horizon_s = eval_horizon_s
        self.eval_window_s = eval_window_s
        self.eval_step_s = eval_step_s
        self.refit_every_s = refit_every_s
        self._weights = np.full(len(self.members), 1.0 / len(self.members))
        self._fit_t: float = -math.inf

    def _reweigh(self, t: float) -> None:
        t0 = max(t - self.eval_window_s, 0.0)
        maes = []
        for m in self.members:
            errs = []
            s = t0
            while s + self.eval_horizon_s <= t:
                truth = self.trace.at(s + self.eval_horizon_s)
                errs.append(abs(m.predict(s, self.eval_horizon_s) - truth))
                s += self.eval_step_s
            maes.append(np.mean(errs) if errs else 1.0)
        inv = 1.0 / (np.array(maes) + 1e-6)
        self._weights = inv / inv.sum()
        self._fit_t = t

    def predict(self, t: float, horizon_s: float) -> float:
        if t - self._fit_t >= self.refit_every_s or t < self._fit_t:
            self._reweigh(t)
        preds = np.array([m.predict(t, horizon_s) for m in self.members])
        return float(preds @ self._weights)


FORECASTERS = {
    PersistenceForecaster.name: PersistenceForecaster,
    DiurnalHarmonicForecaster.name: DiurnalHarmonicForecaster,
    EnsembleForecaster.name: EnsembleForecaster,
}


def make_forecaster(name: str, trace: CarbonTrace, **kw) -> Forecaster:
    return FORECASTERS[name](trace, **kw)


class ForecastCIFn:
    """Adapt a :class:`Forecaster` to the scheduling policies' ``ci_fn``
    contract (``serving.policies``): ``ci_fn(now, horizon_s=0)`` → forecast
    gCO2/kWh at ``now + horizon_s``, where ``now`` is the *backend's*
    session-relative clock.

    ``time_scale`` maps backend seconds onto trace seconds (a real engine's
    wall clock crawls relative to an hour-scale trace; a DES replaying a
    compressed workload may map 1 s → 1 h).  ``set_epoch`` re-anchors the
    session origin onto the trace's absolute clock — the fleet's real
    backend calls it with each probe window's ``t``, so the same policy
    object sees the right stretch of grid across windows.

    Horizon 0 is the nowcast: the forecaster's own fitted value at ``t``
    (NOT a raw trace lookup — an honest policy only ever sees what its
    forecaster believes)."""

    def __init__(self, forecaster: Forecaster, time_scale: float = 1.0,
                 t0: float = 0.0):
        self.forecaster = forecaster
        self.time_scale = time_scale
        self.t0 = t0

    def set_epoch(self, t0: float) -> None:
        self.t0 = float(t0)

    def __call__(self, now: Optional[float] = None,
                 horizon_s: float = 0.0) -> float:
        t = self.t0 + float(now or 0.0) * self.time_scale
        return float(self.forecaster.predict(t, float(horizon_s)
                                             * self.time_scale))


# =============================================================================
# backtesting
# =============================================================================
@dataclasses.dataclass(frozen=True)
class BacktestReport:
    forecaster: str
    trace: str
    horizon_s: float
    n: int
    mae: float                     # gCO2/kWh
    rmse: float                    # gCO2/kWh
    mape: float                    # fraction (0.1 = 10 %)


def backtest(forecaster: Forecaster, horizon_s: float,
             t_start: float = 12 * 3600.0, step_s: float = 1800.0,
             t_end: Optional[float] = None) -> BacktestReport:
    """Walk the trace, predicting ci(t + horizon) from each t, and score
    against the realized trace.  Starts after ``t_start`` so history-hungry
    forecasters are past their cold start."""
    tr = forecaster.trace
    t_end = tr.duration_s - horizon_s if t_end is None else t_end
    errs, rels = [], []
    t = t_start
    while t <= t_end:
        truth = tr.at(t + horizon_s)
        pred = forecaster.predict(t, horizon_s)
        errs.append(pred - truth)
        rels.append(abs(pred - truth) / max(truth, 1e-9))
        t += step_s
    e = np.array(errs)
    return BacktestReport(
        forecaster=forecaster.name, trace=tr.name, horizon_s=horizon_s,
        n=len(e), mae=float(np.mean(np.abs(e))),
        rmse=float(np.sqrt(np.mean(e ** 2))), mape=float(np.mean(rels)))


def backtest_table(trace: CarbonTrace,
                   horizons_s: Sequence[float] = (1800.0, 3600.0, 6 * 3600.0,
                                                  12 * 3600.0),
                   names: Sequence[str] = ("persistence", "harmonic"),
                   t_start: float = 12 * 3600.0,
                   ) -> Dict[str, Dict[float, BacktestReport]]:
    """Error matrix forecaster × horizon for one region's trace."""
    out: Dict[str, Dict[float, BacktestReport]] = {}
    for name in names:
        f = make_forecaster(name, trace)
        out[name] = {h: backtest(f, h, t_start=t_start) for h in horizons_s}
    return out


def backtest_csv(path: str, name: Optional[str] = None,
                 horizons_s: Sequence[float] = (1800.0, 3600.0, 6 * 3600.0),
                 names: Sequence[str] = ("persistence", "harmonic",
                                         "ensemble"),
                 t_start: Optional[float] = None,
                 ) -> Dict[str, Dict[float, BacktestReport]]:
    """Backtest forecasters on a REAL carbon-intensity trace loaded from an
    ElectricityMaps-style CSV (``carbon.load_trace_csv``) — the data-driven
    way to pick a region's forecaster instead of trusting the synthetic
    generators.  ``t_start`` defaults to a quarter of the trace so
    history-hungry forecasters are past their cold start even on short
    exports."""
    from repro_torch.core.carbon import load_trace_csv
    trace = load_trace_csv(path, name=name)
    if t_start is None:
        t_start = 0.25 * trace.duration_s
    return backtest_table(trace, horizons_s=horizons_s, names=names,
                          t_start=t_start)
