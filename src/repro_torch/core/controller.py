"""Clover master controller (paper §4.3 + Fig. 5) — the port's copy of the
reference package's ``core/controller.py``, with its SLO burn-rate alert
hook (``alerts=``, an ``obs.slo.SLOEvaluator``): monitors grid carbon
intensity, re-invokes the optimizer on configurable triggers, and tracks the
serving configuration over a trace.

Re-invocation triggers (paper §4.2): carbon-intensity change beyond a
threshold (default 5 %), accuracy-threshold violation, SLA-limit change, or a
λ-parameter change.  The controller is driven by the simulator (or by the
real-execution engine) through ``maybe_reoptimize``.

On top of the paper's reactive trigger, an optional *predictive* trigger
(fleet layer) consults a carbon-intensity forecaster: if the forecast CI at
``t + forecast_horizon_s`` departs from the last-optimized CI beyond the same
threshold, the controller re-optimizes *ahead* of the swing against a blend
of current and forecast intensity — so the config is already right when the
solar valley (or its evening ramp) arrives, instead of one threshold-crossing
late.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Protocol, Tuple

from repro_torch.core import annealing as SA
from repro_torch.core import catalog as CAT
from repro_torch.core import config_graph as CG
from repro_torch.core import schemes as SCH


class CIForecaster(Protocol):
    """Duck type implemented by fleet.forecast.Forecaster subclasses."""

    def predict(self, t: float, horizon_s: float) -> float: ...


@dataclasses.dataclass
class Invocation:
    t_s: float
    ci: float
    outcome: Optional[SA.SAOutcome]
    config: CG.ConfigGraph
    predictive: bool = False            # fired by the forecast trigger
    alert: bool = False                 # fired by an SLO/carbon burn alert


@dataclasses.dataclass
class Controller:
    scheme: SCH.Scheme
    ctx: SCH.SchemeContext
    ci_threshold: float = 0.05          # 5 % change re-invokes (paper §5.2.2)
    forecaster: Optional[CIForecaster] = None
    forecast_horizon_s: float = 3600.0
    forecast_blend: float = 0.5         # weight of forecast CI when acting early
    config: Optional[CG.ConfigGraph] = None
    last_opt_ci: Optional[float] = None        # observed CI at last invocation
    last_opt_hat: Optional[float] = None       # forecast CI at last invocation
    invocations: List[Invocation] = dataclasses.field(default_factory=list)
    # serving-backend hook: called with the new graph whenever the active
    # config changes (start / reoptimize / elastic scaling).  The real
    # engine's warm ``configure`` attaches here, so a fleet loop drives live
    # instances through the exact same path the simulator exercises.
    on_config_change: Optional[Callable[[CG.ConfigGraph], None]] = None
    # optional streaming telemetry (repro_torch.obs.carbon_feed.CarbonFeed):
    # when attached, ``maybe_reoptimize(t)`` may omit ``ci`` and act on the
    # feed's latest measured snapshot instead of a trace lookup — the
    # "controller consumes the telemetry plane" coupling (codecarbon idiom)
    feed: Optional[object] = None
    # optional SLO/carbon burn-rate alerting (repro_torch.obs.slo.
    # SLOEvaluator): when attached, every ``maybe_reoptimize(t)`` first
    # advances the evaluator at ``t``; a rule *starting* to fire forces a
    # re-invocation even when carbon intensity has not drifted — an
    # exhausted error budget is the controller's signal that the current
    # config is wrong regardless of what the grid is doing.
    alerts: Optional[object] = None
    last_alerts: List[object] = dataclasses.field(default_factory=list)
    _alert_fires_seen: int = 0

    def _notify(self, prev: Optional[CG.ConfigGraph]) -> None:
        if self.on_config_change is not None and self.config is not None \
                and (prev is None or prev.edges != self.config.edges):
            self.on_config_change(self.config)

    def start(self, t: float, ci: float) -> CG.ConfigGraph:
        self.config = self.scheme.initial(self.ctx)
        if self.scheme.carbon_aware:
            self.config, outcome = self.scheme.reoptimize(self.ctx, ci, self.config)
            self.invocations.append(Invocation(t, ci, outcome, self.config))
            self.last_opt_ci = ci
            self.last_opt_hat = (self.forecaster.predict(t, self.forecast_horizon_s)
                                 if self.forecaster is not None else ci)
        self._notify(None)
        return self.config

    def _drifted(self, anchor: Optional[float], ci: float) -> bool:
        if anchor is None:
            return True
        return abs(ci - anchor) / max(anchor, 1e-9) > self.ci_threshold

    def _forecast_ci(self, t: Optional[float]) -> Optional[float]:
        if self.forecaster is None or t is None:
            return None
        return self.forecaster.predict(t, self.forecast_horizon_s)

    def should_reoptimize(self, ci: float, t: Optional[float] = None) -> bool:
        """Reactive trigger: observed CI drifted from the observed CI at the
        last invocation (paper §4.2).  Predictive trigger: the forecast CI at
        t + horizon drifted from the forecast at the last invocation.  Each
        trigger compares against its *own* anchor — comparing the live
        observation against a stored blend would re-trip the threshold every
        window for as long as observation and forecast disagree (trigger
        ping-pong)."""
        if not self.scheme.carbon_aware:
            return False
        if self._drifted(self.last_opt_ci, ci):
            return True
        ci_hat = self._forecast_ci(t)
        return ci_hat is not None and self._drifted(self.last_opt_hat, ci_hat)

    def maybe_reoptimize(self, t: float, ci: Optional[float] = None
                         ) -> Tuple[CG.ConfigGraph, Optional[SA.SAOutcome]]:
        """Returns (active config, SA outcome if an invocation ran).

        ``ci`` may be omitted when a :class:`~repro_torch.obs.carbon_feed.
        CarbonFeed` is attached: the controller then acts on the feed's
        latest *measured* snapshot (its window-end carbon intensity).  An
        explicit ``ci`` always wins, so existing callers are unchanged."""
        if ci is None:
            assert self.feed is not None, \
                "maybe_reoptimize needs an explicit ci or an attached feed"
            snap = self.feed.latest()
            assert snap is not None, \
                "carbon feed has no snapshot yet (heartbeat it first)"
            ci = snap.ci_g_per_kwh
        alert_fired = False
        if self.alerts is not None:
            self.last_alerts = list(self.alerts.evaluate(t))
            fires = sum(s.fire_count for s in self.last_alerts)
            if fires > self._alert_fires_seen:
                alert_fired = True
            self._alert_fires_seen = fires
        if not alert_fired and not self.should_reoptimize(ci, t):
            return self.config, None
        predictive = (not alert_fired
                      and not self._drifted(self.last_opt_ci, ci))
        ci_hat = self._forecast_ci(t)
        ci_opt = ci
        if predictive:
            b = self.forecast_blend
            ci_opt = (1.0 - b) * ci + b * ci_hat   # lead the trace
        prev = self.config
        new_cfg, outcome = self.scheme.reoptimize(self.ctx, ci_opt, self.config)
        self.config = new_cfg
        self.last_opt_ci = ci
        self.last_opt_hat = ci_hat if ci_hat is not None else ci
        self.invocations.append(Invocation(t, ci_opt, outcome, new_cfg,
                                           predictive, alert=alert_fired))
        self._notify(prev)
        return new_cfg, outcome

    # --- elastic scaling (graph additivity, paper §4.2) -------------------------
    def scale_blocks(self, delta_blocks: int, template: Optional[CG.ConfigGraph] = None):
        """Add/remove serving blocks by edge-weight arithmetic.

        Removal greedily subtracts instances summing to exactly 16 chips per
        lost block (an exact cover always exists: slice sizes divide the block
        and the graph is block-packable by construction) — modelling the
        instances a failed block actually hosted.  Addition brings the new
        block up with the highest-quality variant unpartitioned (``template``
        overrides); the caller re-optimizes right after, exactly as the
        controller does on any capacity event."""
        assert self.config is not None
        from repro_torch.core import slices as SL
        g = self.config
        if delta_blocks < 0:
            for _ in range(-delta_blocks):
                remaining = SL.BLOCK_CHIPS
                w = g.weights()
                while remaining > 0:
                    # largest instance that still fits the remaining quota
                    cands = [(chips, e) for e, c in w.items()
                             for chips in [e[1]] if c > 0 and chips <= remaining]
                    assert cands, "graph not block-packable"
                    chips, e = max(cands)
                    w[e] -= 1
                    remaining -= chips
                g = CG.ConfigGraph.from_dict(g.family, w)
        elif delta_blocks > 0:
            if template is None:
                best = CAT.best_variant(self.ctx.variants)
                template = CG.ConfigGraph.uniform(g.family, best.name,
                                                  SL.BLOCK_CHIPS, 1)
            for _ in range(delta_blocks):
                g = g.add(template)
        self.ctx.n_blocks += delta_blocks
        prev, self.config = self.config, g
        self._notify(prev)
        return g
