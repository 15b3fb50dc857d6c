"""Clover optimization objective (paper Eq. 1–5) + the analytic service model
used to evaluate a configuration graph at a given arrival rate — the port's
copy of the reference package's ``core/objective.py``.

  ΔAccuracy = (A − A_base)/A_base · 100          (≤ 0)
  ΔCarbon   = (C_base − E·ci)/C_base · 100
  f = λ · ΔCarbon + (1 − λ) · ΔAccuracy           (maximize)
  s.t. L_p95 ≤ L_tail

The service model: work-conserving FIFO feeding heterogeneous instances —
per-instance rate share ∝ service rate; power via the slice utilization
model; p95 via weighted service percentile + a Sakasegawa M/G/c waiting-time
approximation.  The DES replays chosen configs at request granularity for the
reported end-to-end numbers; this analytic form is what the *online optimizer*
sees during an evaluation window (mirroring the paper's live measurements).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

from repro_torch.core import perf_model as PM
from repro_torch.core import slices as SL
from repro_torch.core.catalog import Variant
from repro_torch.core.config_graph import ConfigGraph


@dataclasses.dataclass(frozen=True)
class EvalResult:
    accuracy: float
    capacity_rps: float
    rho: float                  # offered load / capacity
    p95_latency_s: float
    power_w: float
    energy_per_req_j: float

    def carbon_per_req_g(self, ci: float, pue: float = 1.5) -> float:
        return self.energy_per_req_j / 3.6e6 * ci * pue


def evaluate(g: ConfigGraph, variants: Sequence[Variant],
             arrival_rps: float) -> EvalResult:
    by_name = {v.name: v for v in variants}
    pts, accs, rates = [], [], []
    for (vname, chips), w in g.edges:
        v = by_name[vname]
        sp = PM.cached_point(v, chips)
        for _ in range(w):
            pts.append((v, chips, sp))
            rates.append(sp.throughput_rps)
            accs.append(v.accuracy)
    if not pts:
        return EvalResult(0.0, 0.0, float("inf"), float("inf"), 0.0, float("inf"))

    capacity = sum(rates)
    rho = arrival_rps / capacity if capacity > 0 else float("inf")
    served_frac = [r / capacity for r in rates]
    accuracy = sum(s * a for s, a in zip(served_frac, accs))

    rho_c = min(rho, 1.0)      # work-conserving: every instance busy ρ of the time
    power = sum(PM.instance_power_w(chips, rho_c) for (_, chips, sp) in pts)
    served_rps = min(arrival_rps, capacity)
    energy_per_req = power / served_rps if served_rps > 0 else float("inf")

    # --- p95: weighted service-latency percentile + queueing tail ----------------
    lat_share = sorted((sp.latency_s, s) for (_, _, sp), s in zip(pts, served_frac))
    cum, p95_service = 0.0, lat_share[-1][0]
    for lat, s in lat_share:
        cum += s
        if cum >= 0.95:
            p95_service = lat
            break
    n = len(pts)
    mean_service = sum(sp.latency_s * s for (_, _, sp), s in zip(pts, served_frac))
    if rho < 1.0:
        wq = (rho ** (math.sqrt(2.0 * (n + 1))) / (n * (1.0 - rho))) * mean_service
        p95 = p95_service + 3.0 * wq               # ~exp tail of the wait
    else:
        p95 = p95_service * (1.0 + 10.0 * (rho - 1.0) + 1.0)  # overload: divergent
    return EvalResult(accuracy, capacity, rho, p95, power, energy_per_req)


# =============================================================================
# objective
# =============================================================================
@dataclasses.dataclass(frozen=True)
class ObjectiveConfig:
    lam: float                      # λ in Eq. 3
    a_base: float                   # accuracy of BASE (highest-quality) config
    c_base: float                   # gCO2/request baseline (Eq. 2, fixed)
    l_tail_s: float                 # SLA: p95 target measured on BASE
    pue: float = 1.5
    max_accuracy_loss_pct: Optional[float] = None   # optional hard threshold


def delta_accuracy(acc: float, cfg: ObjectiveConfig) -> float:
    return (acc - cfg.a_base) / cfg.a_base * 100.0


def delta_carbon(energy_per_req_j: float, ci: float, cfg: ObjectiveConfig) -> float:
    c = energy_per_req_j / 3.6e6 * ci * cfg.pue
    return (cfg.c_base - c) / cfg.c_base * 100.0


def objective_f(res: EvalResult, ci: float, cfg: ObjectiveConfig) -> float:
    da = delta_accuracy(res.accuracy, cfg)
    dc = delta_carbon(res.energy_per_req_j, ci, cfg)
    if (cfg.max_accuracy_loss_pct is not None
            and -da > cfg.max_accuracy_loss_pct):
        # provider-specified accuracy threshold (paper Fig. 14b): hard wall
        return -1e6 - (-da)
    return cfg.lam * dc + (1.0 - cfg.lam) * da


def sa_energy(res: EvalResult, ci: float, cfg: ObjectiveConfig) -> float:
    """Paper Eq. 6: h(x) = −f(x) · min(1, L_tail / L(x)).  SLA-violating
    configs are scaled toward zero, keeping the landscape smooth."""
    f = objective_f(res, ci, cfg)
    scale = min(1.0, cfg.l_tail_s / max(res.p95_latency_s, 1e-9))
    return -f * scale


def meets_sla(res: EvalResult, cfg: ObjectiveConfig) -> bool:
    return res.p95_latency_s <= cfg.l_tail_s
