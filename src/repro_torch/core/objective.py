"""Clover optimization objective (paper Eq. 1–5) — the port's copy of the
reference package's ``core/objective.py``, trimmed to what the annealer and
the real-mode control loop read (the analytic service model, ``evaluate``,
is the simulator's and is not carried).

  ΔAccuracy = (A − A_base)/A_base · 100          (≤ 0)
  ΔCarbon   = (C_base − E·ci)/C_base · 100
  f = λ · ΔCarbon + (1 − λ) · ΔAccuracy           (maximize)
  s.t. L_p95 ≤ L_tail
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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


def delta_carbon(energy_per_req_j: float, ci: float,
                 cfg: ObjectiveConfig) -> float:
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
