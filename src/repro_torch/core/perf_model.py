"""Power model the serving engine prices its joules with — the port's copy
of the reference package's ``core/perf_model.py``, trimmed to what the
engine reads.

These are the REFERENCE's model constants (its calibrated per-chip idle and
busy draw), kept unchanged so that the port's per-request joules and the
reference's are computed by the same formula and the conservation checks
compare like with like.  They are not measurements of the card the port
runs on; a power model of that card is later work (ROADMAP).

A chip serving a request draws "busy" power regardless of how well the
request uses the card; an idle-but-allocated chip draws idle power.  Decode
ticks are charged at occupancy-scaled power (:func:`instance_power_w`),
prefill at busy power, unaccounted wall time at idle power.
"""
from __future__ import annotations

P_IDLE_W = 25.0
P_BUSY_W = 210.0


def instance_power_w(chips: int, busy_frac: float) -> float:
    b = min(max(busy_frac, 0.0), 1.0)
    return chips * (P_IDLE_W + (P_BUSY_W - P_IDLE_W) * b)
