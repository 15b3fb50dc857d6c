"""Simulated annealing in the configuration-graph space (paper §4.2,
Eq. 6–7) — the port's copy of the reference package's
``core/annealing.py``.

Faithful parameters: T0 = 1, cooling 0.05 per iteration down to T = 0.1;
acceptance  P = exp(−(h(x') − h(x)) / T)  for worse candidates; termination at
a wall-time limit (5 simulated minutes by default) or 5 consecutive
evaluations without improvement.  Each candidate evaluation costs
``eval_window_s`` of live serving time — the paper measures candidates on the
real system, and the simulator charges this overhead identically.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, List, Optional, Sequence

from repro_torch.core import config_graph as CG
from repro_torch.core import objective as OBJ
from repro_torch.core.catalog import Variant


@dataclasses.dataclass(frozen=True)
class SAConfig:
    t_initial: float = 1.0
    cooling: float = 0.05
    t_min: float = 0.1
    stale_limit: int = 5
    time_limit_s: float = 300.0
    eval_window_s: float = 5.0
    max_ged: int = 4


@dataclasses.dataclass
class Evaluation:
    graph: CG.ConfigGraph
    result: OBJ.EvalResult
    f: float
    h: float
    sla_ok: bool
    t_offset_s: float            # when (relative to invocation start) evaluated


@dataclasses.dataclass
class SAOutcome:
    best: CG.ConfigGraph
    best_f: float
    evaluations: List[Evaluation]
    duration_s: float

    @property
    def n_evals(self) -> int:
        return len(self.evaluations)

    @property
    def sla_compliant_frac(self) -> float:
        if not self.evaluations:
            return 1.0
        return sum(e.sla_ok for e in self.evaluations) / len(self.evaluations)


def anneal(start: CG.ConfigGraph,
           variants: Sequence[Variant],
           evaluator: Callable[[CG.ConfigGraph], OBJ.EvalResult],
           ci: float,
           obj_cfg: OBJ.ObjectiveConfig,
           sa_cfg: SAConfig = SAConfig(),
           rng: Optional[random.Random] = None) -> SAOutcome:
    """One Clover optimization invocation.  ``start`` is the previous best
    (warm start — the paper's Fig. 13 invocation chaining)."""
    rng = rng or random.Random(0)
    evals: List[Evaluation] = []
    t = 0.0

    def run_eval(g: CG.ConfigGraph) -> Evaluation:
        nonlocal t
        t += sa_cfg.eval_window_s
        res = evaluator(g)
        f = OBJ.objective_f(res, ci, obj_cfg)
        h = OBJ.sa_energy(res, ci, obj_cfg)
        ev = Evaluation(g, res, f, h, OBJ.meets_sla(res, obj_cfg), t)
        evals.append(ev)
        return ev

    current = run_eval(start)
    best = current
    temp = sa_cfg.t_initial
    stale = 0

    while t < sa_cfg.time_limit_s and stale < sa_cfg.stale_limit:
        cand_graph = CG.sample_neighbor(current.graph, variants, rng,
                                        sa_cfg.max_ged)
        if cand_graph.edges == current.graph.edges:
            break                      # no neighbors at all
        cand = run_eval(cand_graph)

        accept = cand.h <= current.h
        if not accept:
            p = math.exp(-(cand.h - current.h) / max(temp, 1e-9))
            accept = rng.random() < p
        if accept:
            current = cand
        # track best among SLA-compliant configs; fall back to best-h
        improved = False
        if cand.sla_ok and (not best.sla_ok or cand.f > best.f):
            best, improved = cand, True
        elif not best.sla_ok and cand.h < best.h:
            best, improved = cand, True
        stale = 0 if improved else stale + 1
        temp = max(temp - sa_cfg.cooling, sa_cfg.t_min)

    return SAOutcome(best.graph, best.f, evals, t)
