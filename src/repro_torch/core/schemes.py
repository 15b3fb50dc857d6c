"""Clover and the paper's competing schemes (§5.1) — the port's copy of the
reference package's ``core/schemes.py``:

  BASE    — highest-quality variant, unpartitioned blocks (carbon-unaware).
  CO2OPT  — finest feasible partition, smallest variant (carbon-minimal).
  BLOVER  — carbon-aware random search in the raw (x^p, x^v) space: all of
            Clover's machinery except the configuration-graph optimizer.
  CLOVER  — graph-space simulated annealing (annealing.py), warm-started.
  ORACLE  — instant argmax-f over the standardized offline-profiled space
            (uniform partition + per-slice-type variant across blocks),
            zero optimization time — the paper's infeasible upper bound.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import annealing as SA
from repro_torch.core import config_graph as CG
from repro_torch.core import objective as OBJ
from repro_torch.core import slices as SL
from repro_torch.core.catalog import Variant, best_variant, worst_variant


@dataclasses.dataclass
class SchemeContext:
    family: str
    variants: Sequence[Variant]
    n_blocks: int
    arrival_rps: float
    obj_cfg: OBJ.ObjectiveConfig
    sa_cfg: SA.SAConfig
    rng: random.Random

    def evaluator(self) -> Callable[[CG.ConfigGraph], OBJ.EvalResult]:
        return lambda g: OBJ.evaluate(g, self.variants, self.arrival_rps)


def base_config(ctx: SchemeContext) -> CG.ConfigGraph:
    best = best_variant(ctx.variants)
    return CG.ConfigGraph.uniform(ctx.family, best.name, SL.BLOCK_CHIPS,
                                  ctx.n_blocks)


def co2opt_config(ctx: SchemeContext) -> CG.ConfigGraph:
    small = worst_variant(ctx.variants)
    chips = min(s for s in SL.SLICE_SIZES if SL.fits(small.mem_gb, s))
    return CG.ConfigGraph.uniform(ctx.family, small.name, chips, ctx.n_blocks)


class Scheme:
    name = "abstract"
    carbon_aware = False

    def initial(self, ctx: SchemeContext) -> CG.ConfigGraph:
        raise NotImplementedError

    def reoptimize(self, ctx: SchemeContext, ci: float,
                   current: CG.ConfigGraph
                   ) -> Tuple[CG.ConfigGraph, Optional[SA.SAOutcome]]:
        return current, None


class Base(Scheme):
    name = "BASE"

    def initial(self, ctx):
        return base_config(ctx)


class CO2Opt(Scheme):
    name = "CO2OPT"

    def initial(self, ctx):
        return co2opt_config(ctx)


class Clover(Scheme):
    name = "CLOVER"
    carbon_aware = True

    def initial(self, ctx):
        return base_config(ctx)

    def reoptimize(self, ctx, ci, current):
        out = SA.anneal(current, ctx.variants, ctx.evaluator(), ci,
                        ctx.obj_cfg, ctx.sa_cfg, ctx.rng)
        return out.best, out


class Blover(Scheme):
    """Random search over raw (x^p, x^v): same eval budget and termination
    rules as Clover, no graph neighborhood structure (paper §5.1)."""
    name = "BLOVER"
    carbon_aware = True

    def initial(self, ctx):
        return base_config(ctx)

    def reoptimize(self, ctx, ci, current):
        evaluator = ctx.evaluator()
        evals: List[SA.Evaluation] = []
        t = 0.0

        def run_eval(g):
            nonlocal t
            t += ctx.sa_cfg.eval_window_s
            res = evaluator(g)
            f = OBJ.objective_f(res, ci, ctx.obj_cfg)
            h = OBJ.sa_energy(res, ci, ctx.obj_cfg)
            ev = SA.Evaluation(g, res, f, h, OBJ.meets_sla(res, ctx.obj_cfg), t)
            evals.append(ev)
            return ev

        best = run_eval(current)
        stale = 0
        while t < ctx.sa_cfg.time_limit_s and stale < ctx.sa_cfg.stale_limit:
            cand = run_eval(CG.random_config(ctx.family, ctx.variants,
                                             ctx.n_blocks, ctx.rng))
            improved = False
            if cand.sla_ok and (not best.sla_ok or cand.f > best.f):
                best, improved = cand, True
            elif not best.sla_ok and cand.h < best.h:
                best, improved = cand, True
            stale = 0 if improved else stale + 1
        return best.graph, SA.SAOutcome(best.graph, best.f, evals, t)


class Oracle(Scheme):
    """Exhaustive offline profile over the standardized space (the paper
    limits ORACLE to uniform per-block configurations; it still took two
    weeks of wall-time on their testbed — here the profile is analytic)."""
    name = "ORACLE"
    carbon_aware = True

    def __init__(self):
        self._space: Optional[List[CG.ConfigGraph]] = None

    def _build_space(self, ctx: SchemeContext) -> List[CG.ConfigGraph]:
        graphs: Dict = {}
        for part in SL.partition_catalog():
            sizes = sorted(set(part), reverse=True)
            feas = {s: [v for v in ctx.variants if SL.fits(v.mem_gb, s)]
                    for s in sizes}
            if any(not feas[s] for s in sizes):
                continue
            for choice in itertools.product(*(feas[s] for s in sizes)):
                weights: Dict = {}
                vmap = dict(zip(sizes, choice))
                for s in part:
                    e = (vmap[s].name, s)
                    weights[e] = weights.get(e, 0) + ctx.n_blocks
                g = CG.ConfigGraph.from_dict(ctx.family, weights)
                graphs[g.edges] = g
        return list(graphs.values())

    def initial(self, ctx):
        return base_config(ctx)

    def reoptimize(self, ctx, ci, current):
        if self._space is None:
            self._space = self._build_space(ctx)
        evaluator = ctx.evaluator()
        best_g, best_f = current, -float("inf")
        for g in self._space:
            res = evaluator(g)
            if not OBJ.meets_sla(res, ctx.obj_cfg):
                continue
            f = OBJ.objective_f(res, ci, ctx.obj_cfg)
            if f > best_f:
                best_g, best_f = g, f
        return best_g, None          # zero optimization time (oracular)


SCHEMES = {s.name: s for s in (Base(), CO2Opt(), Blover(), Clover(), Oracle())}


def make_scheme(name: str) -> Scheme:
    cls = {"BASE": Base, "CO2OPT": CO2Opt, "BLOVER": Blover,
           "CLOVER": Clover, "ORACLE": Oracle}[name]
    return cls()
