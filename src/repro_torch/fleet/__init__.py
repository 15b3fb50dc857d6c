"""Carbon-aware fleet layer on top of the per-cluster Clover controller.

Four pieces (the CarbonShiftML and EcoServe directions):

  forecast.py  — carbon-intensity forecasters over ``CarbonTrace`` so
                 controllers can act *before* the solar valley arrives.
  workload.py  — two-class traffic: interactive requests (SLA-bound, served
                 now) and deferrable batch jobs (deadline-bound, shiftable).
  shifting.py  — temporal scheduler packing deferrable work into forecast
                 low-CI windows under capacity and deadline constraints.
  router.py    — spatial load balancer splitting interactive arrivals across
                 regions by effective carbon-per-request.
  fleet_sim.py — the multi-region simulator tying it together: one Clover
                 ``Controller`` per region, a global router, elastic block
                 scaling, and fleet-wide carbon accounting.
"""
from repro_torch.fleet.forecast import (DiurnalHarmonicForecaster, Forecaster,
                                  PersistenceForecaster, backtest,
                                  make_forecaster)
from repro_torch.fleet.workload import DeferrableJob, FleetWorkload, make_workload
from repro_torch.fleet.shifting import (ShiftPlan, Slot, greedy_shift, lp_shift,
                                  make_shifter)
from repro_torch.fleet.router import RegionSnapshot, RouteDecision, route_interactive
from repro_torch.fleet.fleet_sim import FleetConfig, FleetReport, run_fleet

__all__ = [
    "Forecaster", "PersistenceForecaster", "DiurnalHarmonicForecaster",
    "backtest", "make_forecaster",
    "DeferrableJob", "FleetWorkload", "make_workload",
    "Slot", "ShiftPlan", "greedy_shift", "lp_shift", "make_shifter",
    "RegionSnapshot", "RouteDecision", "route_interactive",
    "FleetConfig", "FleetReport", "run_fleet",
]
