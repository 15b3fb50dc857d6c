"""Temporal shifting of deferrable work into forecast low-carbon windows —
the port's copy of the reference package's ``fleet/shifting.py``.

Given (a) deferrable jobs with deadlines (workload.py) and (b) a grid of
candidate slots — per region, per planning window: spare serving capacity,
forecast carbon intensity and the region's current energy/request — assign
job work to slots minimizing forecast grams of CO2, subject to

    Σ_slots x[j,s] = work_j          (every job fully placed)
    Σ_jobs  x[j,s] ≤ spare_s·dur_s   (slot capacity)
    x[j,s] = 0 unless  arrival_j ≤ slot.t0  and  slot.t1 ≤ deadline_j

Two solvers with one return type so the fleet simulator can swap them:

  greedy_shift — earliest-deadline-first over jobs, cheapest-feasible-slot
                 first within a job.  O(J·S log S), no deps, and near-optimal
                 when slot costs are shared across jobs (they are: cost
                 depends only on the slot).
  lp_shift     — the exact LP relaxation of the transportation problem via
                 scipy.optimize.linprog (HiGHS).  The constraint matrix is
                 totally unimodular, so the relaxation is integral whenever
                 work/capacities are; fractional work is fine regardless
                 because requests are fluid here.  Falls back to greedy when
                 scipy is unavailable (the container bakes it in, but the
                 module must not hard-require it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.carbon import PUE_DEFAULT
from repro_torch.fleet.workload import DeferrableJob


@dataclasses.dataclass(frozen=True)
class Slot:
    """One (region × planning-window) unit of shiftable capacity."""
    region: str
    t0: float
    dur_s: float
    spare_rps: float               # capacity left after interactive traffic
    ci_hat: float                  # forecast gCO2/kWh over the window
    energy_per_req_j: float        # region's current marginal energy/request

    @property
    def t1(self) -> float:
        return self.t0 + self.dur_s

    @property
    def capacity_req(self) -> float:
        return self.spare_rps * self.dur_s

    def cost_g_per_req(self, pue: float = PUE_DEFAULT) -> float:
        return self.energy_per_req_j / 3.6e6 * self.ci_hat * pue


@dataclasses.dataclass(frozen=True)
class Allocation:
    job_id: str
    region: str
    t0: float
    dur_s: float
    work_req: float


@dataclasses.dataclass
class ShiftPlan:
    allocations: List[Allocation]
    unplaced: Dict[str, float]     # job_id → work that found no feasible slot

    @property
    def feasible(self) -> bool:
        return not self.unplaced

    @property
    def placed_work(self) -> float:
        return sum(a.work_req for a in self.allocations)

    def forecast_carbon_g(self, slots: Sequence[Slot],
                          pue: float = PUE_DEFAULT) -> float:
        cost = {(s.region, s.t0): s.cost_g_per_req(pue) for s in slots}
        return sum(a.work_req * cost[(a.region, a.t0)]
                   for a in self.allocations)

    def rate(self, region: str, t: float) -> float:
        """Planned deferrable arrival rate for ``region`` at time ``t``."""
        out = 0.0
        for a in self.allocations:
            if a.region == region and a.t0 <= t < a.t0 + a.dur_s:
                out += a.work_req / a.dur_s
        return out

    def by_slot(self) -> Dict[Tuple[str, float], float]:
        out: Dict[Tuple[str, float], float] = {}
        for a in self.allocations:
            k = (a.region, a.t0)
            out[k] = out.get(k, 0.0) + a.work_req
        return out


def _feasible(job: DeferrableJob, slot: Slot) -> bool:
    return job.feasible_in(slot.t0, slot.t1) and slot.capacity_req > 1e-9


def greedy_shift(jobs: Sequence[DeferrableJob], slots: Sequence[Slot],
                 pue: float = PUE_DEFAULT) -> ShiftPlan:
    """EDF over jobs (tightest deadline claims capacity first), cheapest
    feasible slot first within each job."""
    remaining_cap = {id(s): s.capacity_req for s in slots}
    order = sorted(slots, key=lambda s: (s.cost_g_per_req(pue), s.t0))
    allocations: List[Allocation] = []
    unplaced: Dict[str, float] = {}
    for job in sorted(jobs, key=lambda j: j.deadline_s):
        need = job.work_req
        for slot in order:
            if need <= 1e-9:
                break
            if not _feasible(job, slot):
                continue
            take = min(need, remaining_cap[id(slot)])
            if take <= 1e-9:
                continue
            allocations.append(Allocation(job.job_id, slot.region, slot.t0,
                                          slot.dur_s, take))
            remaining_cap[id(slot)] -= take
            need -= take
        if need > 1e-9:
            unplaced[job.job_id] = need
    return ShiftPlan(allocations, unplaced)


def lp_shift(jobs: Sequence[DeferrableJob], slots: Sequence[Slot],
             pue: float = PUE_DEFAULT) -> ShiftPlan:
    """Exact LP over the feasible (job, slot) pairs; see module docstring."""
    try:
        from scipy.optimize import linprog
        from scipy.sparse import lil_matrix
    except ImportError:                       # pragma: no cover - baked in
        return greedy_shift(jobs, slots, pue)

    pairs: List[Tuple[int, int]] = [(j, s) for j, job in enumerate(jobs)
                                    for s, slot in enumerate(slots)
                                    if _feasible(job, slot)]
    if not pairs:
        return ShiftPlan([], {j.job_id: j.work_req for j in jobs
                              if j.work_req > 1e-9})
    costs = [slots[s].cost_g_per_req(pue) for _, s in pairs]
    # equality rows (jobs) stacked over inequality rows (slot capacities);
    # jobs with no feasible slot at all are excluded and reported unplaced.
    jobs_in = sorted({j for j, _ in pairs})
    jrow = {j: r for r, j in enumerate(jobs_in)}
    a_eq = lil_matrix((len(jobs_in), len(pairs)))
    a_ub = lil_matrix((len(slots), len(pairs)))
    for col, (j, s) in enumerate(pairs):
        a_eq[jrow[j], col] = 1.0
        a_ub[s, col] = 1.0
    b_eq = [jobs[j].work_req for j in jobs_in]
    b_ub = [s.capacity_req for s in slots]
    res = linprog(costs, A_ub=a_ub.tocsr(), b_ub=b_ub,
                  A_eq=a_eq.tocsr(), b_eq=b_eq, method="highs")
    if not res.success:
        # aggregate capacity can't cover every deadline → greedy degrades
        # gracefully (partial placement + explicit unplaced report)
        return greedy_shift(jobs, slots, pue)
    allocations = []
    for col, (j, s) in enumerate(pairs):
        w = float(res.x[col])
        if w > 1e-6:
            slot = slots[s]
            allocations.append(Allocation(jobs[j].job_id, slot.region,
                                          slot.t0, slot.dur_s, w))
    unplaced = {jobs[j].job_id: jobs[j].work_req for j in range(len(jobs))
                if j not in jrow and jobs[j].work_req > 1e-9}
    return ShiftPlan(allocations, unplaced)


SHIFTERS = {"greedy": greedy_shift, "lp": lp_shift}


def make_shifter(name: str):
    return SHIFTERS[name]
