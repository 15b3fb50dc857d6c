"""Spatial routing of interactive traffic across regions (fleet layer) —
the port's copy of the reference package's ``fleet/router.py``.

Each window the global front door splits the fleet-wide interactive arrival
stream across regions by *effective carbon per request* — the region's
current marginal energy/request times its current grid intensity, PLUS the
network-egress carbon of hauling the request/response payload to that region
— greedily water-filling the cheapest regions first, subject to:

  capacity  — no region is loaded past ``max_rho`` of its configured
              capacity (the headroom also protects the shifting plan's
              spare-capacity assumptions);
  latency   — a request routed cross-region pays ``net_delay_s``; a region
              is only loaded up to the rate where its modeled p95 plus that
              penalty still meets the SLA (p95 is monotone in load, so the
              cap is found by bisection);
  gravity   — ``gravity_cap_rps`` hard-caps the rate a region may take for
              data-residency / data-gravity reasons (the request's data
              lives elsewhere and only so much may leave), independent of
              how clean its grid is.

The egress term matters because network paths are not carbon-free: moving a
GB across a backbone has a measured footprint (order 10⁻²–10⁻¹ gCO2/GB on
modern routes, far higher on satellite or legacy paths), so a marginally
cleaner grid behind an expensive path can LOSE to a dirtier local region —
exactly the flip ``test_router_egress_carbon_flips_routing`` pins down.

Traffic that no region can take within the limits is spread proportionally
to capacity anyway (it queues as backlog and is served late) and the excess
rate is reported as overflow — an overload pressure gauge, not a drop count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.carbon import PUE_DEFAULT


@dataclasses.dataclass
class RegionSnapshot:
    """What the router knows about one region at decision time."""
    name: str
    capacity_rps: float
    energy_per_req_j: float
    ci: float
    net_delay_s: float
    p95_at: Callable[[float], float]     # modeled p95 at a candidate rate
    # network egress: payload hauled per request × path carbon intensity.
    # Zero by default — latency-only routing — so existing callers are exact.
    egress_gb_per_req: float = 0.0       # request+response payload (GB)
    egress_g_per_gb: float = 0.0         # gCO2 per GB on the path here
    # data gravity: hard per-region rate cap (data-residency constraints)
    gravity_cap_rps: float = math.inf

    def carbon_g_per_req(self, pue: float = PUE_DEFAULT) -> float:
        """Compute-side carbon only (grid intensity × energy × PUE)."""
        return self.energy_per_req_j / 3.6e6 * self.ci * pue

    def egress_g_per_req(self) -> float:
        """Network-side carbon of routing one request here."""
        return self.egress_gb_per_req * self.egress_g_per_gb

    def effective_g_per_req(self, pue: float = PUE_DEFAULT) -> float:
        """What one request routed here actually emits: compute + egress."""
        return self.carbon_g_per_req(pue) + self.egress_g_per_req()


@dataclasses.dataclass
class RouteDecision:
    rates: Dict[str, float]              # region → interactive rps assigned
    # demand assigned *above* the SLA/rho/gravity caps this window.  It is
    # still included in ``rates`` (spread by capacity, served late via
    # backlog) — this is a pressure gauge, not a count of dropped requests.
    overflow_rps: float

    def rate(self, region: str) -> float:
        return self.rates.get(region, 0.0)


def _sla_rate_cap(snap: RegionSnapshot, sla_s: float, rho_cap_rps: float,
                  tol_rps: float = 1e-3) -> float:
    """Largest rate ≤ rho_cap_rps whose p95 + net delay meets the SLA."""
    budget = sla_s - snap.net_delay_s
    if budget <= 0.0:
        return 0.0
    if snap.p95_at(rho_cap_rps) <= budget:
        return rho_cap_rps
    lo, hi = 0.0, rho_cap_rps
    if snap.p95_at(lo) > budget:
        return 0.0
    while hi - lo > tol_rps:
        mid = 0.5 * (lo + hi)
        if snap.p95_at(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def route_interactive(total_rps: float, snapshots: Sequence[RegionSnapshot],
                      sla_s: float, max_rho: float = 0.85,
                      pue: float = PUE_DEFAULT,
                      prev_rates: Optional[Dict[str, float]] = None,
                      hysteresis: float = 0.05) -> RouteDecision:
    """Greedy water-fill: cheapest *effective* region first (compute carbon
    + egress carbon), up to its binding cap (max_rho ∧ SLA ∧ gravity).

    ``prev_rates`` enables stickiness: regions currently carrying traffic get
    a ``hysteresis`` discount on their effective cost, so the assignment only
    migrates when the carbon advantage is material.  Without it, near-ties
    between regions flap the routing every window and the downstream
    reconfiguration/rescaling churn costs more carbon than the tie is worth."""
    rates = {s.name: 0.0 for s in snapshots}
    remaining = total_rps

    def cost(s: RegionSnapshot) -> float:
        c = s.effective_g_per_req(pue)
        if prev_rates and prev_rates.get(s.name, 0.0) > 1e-6:
            c *= 1.0 - hysteresis
        return c

    for snap in sorted(snapshots, key=lambda s: (cost(s), s.net_delay_s)):
        if remaining <= 1e-9:
            break
        cap = _sla_rate_cap(snap, sla_s, max_rho * snap.capacity_rps)
        cap = min(cap, snap.gravity_cap_rps)      # data gravity is a hard cap
        take = min(remaining, cap)
        rates[snap.name] = take
        remaining -= take
    if remaining > 1e-9:
        # overload: spread the excess so no region melts alone — weighted by
        # each region's REMAINING gravity headroom (residency is a hard cap
        # and holds even under overload: a region already at its gravity
        # limit takes nothing more).  Only if every region's headroom is
        # exhausted does the spread fall back to raw capacity — at that
        # point the demand itself violates residency and overflow reports
        # the pressure.
        weights = {s.name: max(min(s.capacity_rps, s.gravity_cap_rps)
                               - rates[s.name], 0.0)
                   for s in snapshots}
        total_w = sum(weights.values())
        if total_w <= 0.0:
            weights = {s.name: s.capacity_rps for s in snapshots}
            total_w = sum(weights.values()) or 1.0
        for snap in snapshots:
            rates[snap.name] += remaining * weights[snap.name] / total_w
    return RouteDecision(rates, max(remaining, 0.0))
