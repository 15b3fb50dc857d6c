"""48-hour serving simulation over a carbon trace (paper §5 evaluation rig)
— the port's copy of the reference package's ``serving/simulator.py``.

Fluid-window discrete-event simulation: arrivals are Poisson with rate set so
BASE runs at ~70 % utilization ("neither starvation nor idle GPUs", §5.1);
each window serves min(backlog + arrivals, capacity·Δ) under the active
configuration's analytic service model.  All Clover/Blover *online evaluation
windows are served under the candidate being evaluated* and reconfiguration
downtime is charged — the paper includes both overheads in every result.

The per-request exact DES is ``serving/queue.py`` (the reference's
counterpart); at 48 h × production rates the fluid model is the tractable
equivalent.  This module touches no tensor: numpy and the
standard library only.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import annealing as SA
from repro_torch.core import carbon as CB
from repro_torch.core import config_graph as CG
from repro_torch.core import controller as CTRL
from repro_torch.core import objective as OBJ
from repro_torch.core import perf_model as PM
from repro_torch.core import schemes as SCH
from repro_torch.core.catalog import Variant, get_family


@dataclasses.dataclass
class SimConfig:
    n_blocks: int = 4                  # 4 blocks × 16 chips (≈ paper's 10 GPUs)
    window_s: float = 60.0
    target_rho: float = 0.7            # BASE operating point
    lam: float = 0.1                   # objective λ (paper default)
    ci_threshold: float = 0.05
    seed: int = 0
    reconfig_cost: bool = True
    accuracy_threshold_pct: Optional[float] = None
    sla_target_s: Optional[float] = None   # override the derived p95 target
                                           # (fleet baselines pin it so fleet
                                           # and single runs share one SLA)
    sa: SA.SAConfig = dataclasses.field(default_factory=SA.SAConfig)


@dataclasses.dataclass
class SimReport:
    scheme: str
    family: str
    carbon_g: float
    served: float
    dropped_backlog: float
    accuracy: float                    # request-weighted mean accuracy
    p95_latency_s: float
    sla_target_s: float
    sla_violation_frac: float          # fraction of served windows over target
    opt_time_s: float
    opt_time_frac: float
    n_evals: int
    evals_sla_ok: int
    n_invocations: int
    timeline: Dict[str, np.ndarray]    # t, ci, f, accuracy, power, carbon_rate

    def carbon_per_req_g(self) -> float:
        return self.carbon_g / max(self.served, 1.0)


def weighted_p95(lat_samples: Sequence[Tuple[float, float]]) -> float:
    """Request-weighted 95th percentile over (latency, weight) samples —
    shared by per-cluster servers and fleet-wide merges."""
    if not lat_samples:
        return 0.0
    samples = sorted(lat_samples)
    total = sum(w for _, w in samples)
    cum = 0.0
    for lat, w in samples:
        cum += w
        if cum >= 0.95 * total:
            return lat
    return samples[-1][0]


@dataclasses.dataclass
class SegmentResult:
    """One fluid window's outcome (returned so callers can build timelines)."""
    res: OBJ.EvalResult
    ci: float
    served: float                  # interactive requests served this window
    defer_served: float            # deferrable requests served this window
    carbon_g: float
    p95_s: float


class FluidServer:
    """The fluid-window service model, factored out of ``run_trace`` so the
    multi-region fleet simulator (repro_torch.fleet.fleet_sim) reuses it
    instead of
    duplicating the backlog/SLA/carbon bookkeeping.

    Two work classes: *interactive* requests count toward the p95/SLA
    statistics and are served first; *deferrable* work (``defer_rps``) only
    consumes capacity left over in the window and never enters the latency
    books — it has a deadline, not an SLA.  With ``defer_rps=0`` the model is
    exactly the original single-class ``serve_segment``.
    """

    def __init__(self, variants: Sequence[Variant], acct: CB.CarbonAccountant,
                 sla_target_s: float, sla_slack: float = 1.001):
        self.variants = variants
        self.acct = acct
        self.sla_target_s = sla_target_s
        self.sla_slack = sla_slack
        self.backlog = 0.0
        self.defer_backlog = 0.0
        self.served_total = 0.0
        self.defer_served_total = 0.0
        self.acc_weighted = 0.0
        self.lat_samples: List[Tuple[float, float]] = []   # (p95, weight)
        self.sla_over = 0
        self.sla_windows = 0

    def serve_segment(self, g: CG.ConfigGraph, start: float, dur: float,
                      arrival_rps: float, defer_rps: float = 0.0,
                      extra_latency_s: float = 0.0) -> SegmentResult:
        res = OBJ.evaluate(g, self.variants, arrival_rps + defer_rps)
        ci = self.acct.trace.at(start + dur / 2.0)
        cap = res.capacity_rps * dur
        work = self.backlog + arrival_rps * dur
        served = min(work, cap)
        self.backlog = work - served
        defer_work = self.defer_backlog + defer_rps * dur
        defer_served = min(defer_work, cap - served)
        self.defer_backlog = defer_work - defer_served
        wait = self.backlog / max(res.capacity_rps, 1e-9)
        p95 = res.p95_latency_s + wait + extra_latency_s
        carbon_g = self.acct.add(start, dur, res.power_w)
        self.served_total += served
        self.defer_served_total += defer_served
        self.acc_weighted += res.accuracy * (served + defer_served)
        if served > 0:
            self.lat_samples.append((p95, served))
            self.sla_windows += 1
            if p95 > self.sla_target_s * self.sla_slack:
                self.sla_over += 1
        return SegmentResult(res, ci, served, defer_served, carbon_g, p95)

    def weighted_p95(self) -> float:
        return weighted_p95(self.lat_samples)

    @property
    def mean_accuracy(self) -> float:
        return self.acc_weighted / max(self.served_total
                                       + self.defer_served_total, 1e-9)

    @property
    def sla_violation_frac(self) -> float:
        return self.sla_over / max(self.sla_windows, 1)


def make_context(family: str, sim: SimConfig,
                 variants: Optional[Sequence[Variant]] = None
                 ) -> Tuple[SCH.SchemeContext, float]:
    """Builds the scheme context; returns (ctx, arrival_rps).

    ``variants`` overrides the catalog lookup — the real-execution fleet
    backend optimizes over its engine ladder's variants instead of a
    catalog family."""
    variants = list(variants) if variants is not None else get_family(family)
    rng = random.Random(sim.seed)
    # BASE capacity determines the arrival rate and the SLA
    tmp_ctx = SCH.SchemeContext(family, variants, sim.n_blocks, 1.0,
                                None, sim.sa, rng)
    base_g = SCH.base_config(tmp_ctx)
    base_eval_unloaded = OBJ.evaluate(base_g, variants, 1e-9)
    arrival = base_eval_unloaded.capacity_rps * sim.target_rho
    base_eval = OBJ.evaluate(base_g, variants, arrival)
    obj = OBJ.ObjectiveConfig(
        lam=sim.lam,
        a_base=base_eval.accuracy,
        c_base=base_eval.carbon_per_req_g(380.0),   # baseline avg US intensity
        l_tail_s=(sim.sla_target_s if sim.sla_target_s is not None
                  else base_eval.p95_latency_s),
        max_accuracy_loss_pct=sim.accuracy_threshold_pct,
    )
    ctx = SCH.SchemeContext(family, variants, sim.n_blocks, arrival, obj,
                            sim.sa, rng)
    return ctx, arrival


def run_trace(scheme_name: str, family: str, trace: CB.CarbonTrace,
              sim: SimConfig = SimConfig()) -> SimReport:
    ctx, arrival = make_context(family, sim)
    scheme = SCH.make_scheme(scheme_name)
    controller = CTRL.Controller(scheme, ctx, ci_threshold=sim.ci_threshold)
    acct = CB.CarbonAccountant(trace)
    variants = ctx.variants
    server = FluidServer(variants, acct, ctx.obj_cfg.l_tail_s)

    t = 0.0
    ci0 = trace.at(0.0)
    config = controller.start(t, ci0)
    # charge the initial optimization run's evaluation windows
    opt_time = 0.0
    n_evals = evals_ok = 0
    tl_t, tl_ci, tl_f, tl_acc, tl_pow, tl_cg = [], [], [], [], [], []

    def serve_segment(g: CG.ConfigGraph, start: float, dur: float):
        seg = server.serve_segment(g, start, dur, arrival)
        tl_t.append(start)
        tl_ci.append(seg.ci)
        tl_f.append(OBJ.objective_f(seg.res, seg.ci, ctx.obj_cfg))
        tl_acc.append(seg.res.accuracy)
        tl_pow.append(seg.res.power_w)
        tl_cg.append(seg.carbon_g / max(dur, 1e-9))
        return seg.res

    def charge_invocation(outcome: Optional[SA.SAOutcome], start: float) -> float:
        """Serve each SA evaluation window under its candidate config."""
        nonlocal opt_time, n_evals, evals_ok
        if outcome is None:
            return 0.0
        tt = start
        for ev in outcome.evaluations:
            serve_segment(ev.graph, tt, ctx.sa_cfg.eval_window_s)
            tt += ctx.sa_cfg.eval_window_s
        opt_time += outcome.duration_s
        n_evals += outcome.n_evals
        evals_ok += sum(e.sla_ok for e in outcome.evaluations)
        return outcome.duration_s

    if controller.invocations:
        t += charge_invocation(controller.invocations[-1].outcome, t)
        config = controller.config

    prev_config = config
    while t < trace.duration_s:
        ci = trace.at(t)
        if controller.should_reoptimize(ci, t):
            new_cfg, outcome = controller.maybe_reoptimize(t, ci)
            t += charge_invocation(outcome, t)
            if sim.reconfig_cost and new_cfg.edges != prev_config.edges:
                # dead time: instance reload (parallel across slices)
                by_name = {v.name: v for v in variants}
                dt = max((PM.reconfig_seconds(by_name[vn], c)
                          for (vn, c), _ in new_cfg.edges), default=0.0)
                idle_power = sum(PM.instance_power_w(c, 0.0) * w
                                 for (vn, c), w in new_cfg.edges)
                acct.add(t, dt, idle_power)
                server.backlog += arrival * dt
                t += dt
            prev_config = config = new_cfg
            continue
        dur = min(sim.window_s, trace.duration_s - t)
        serve_segment(config, t, dur)
        t += dur

    return SimReport(
        scheme=scheme_name, family=family,
        carbon_g=acct.carbon_g, served=server.served_total,
        dropped_backlog=server.backlog,
        accuracy=server.mean_accuracy, p95_latency_s=server.weighted_p95(),
        sla_target_s=ctx.obj_cfg.l_tail_s,
        sla_violation_frac=server.sla_violation_frac,
        opt_time_s=opt_time, opt_time_frac=opt_time / trace.duration_s,
        n_evals=n_evals, evals_sla_ok=evals_ok,
        n_invocations=len(controller.invocations),
        timeline={"t": np.array(tl_t), "ci": np.array(tl_ci),
                  "f": np.array(tl_f), "accuracy": np.array(tl_acc),
                  "power_w": np.array(tl_pow),
                  "carbon_gps": np.array(tl_cg)},
    )


def compare_schemes(family: str, trace: CB.CarbonTrace,
                    schemes: Sequence[str] = ("BASE", "CO2OPT", "BLOVER",
                                              "CLOVER", "ORACLE"),
                    sim: SimConfig = SimConfig()) -> Dict[str, SimReport]:
    return {s: run_trace(s, family, trace, sim) for s in schemes}


def savings_vs_base(reports: Dict[str, SimReport]) -> Dict[str, Dict[str, float]]:
    base = reports["BASE"]
    out = {}
    for name, r in reports.items():
        out[name] = {
            "carbon_saving_pct": (1.0 - r.carbon_per_req_g()
                                  / base.carbon_per_req_g()) * 100.0,
            "accuracy_delta_pct": (r.accuracy - base.accuracy)
                                  / base.accuracy * 100.0,
            "p95_vs_sla": r.p95_latency_s / r.sla_target_s,
            "opt_time_frac_pct": r.opt_time_frac * 100.0,
        }
    return out
