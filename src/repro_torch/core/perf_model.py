"""Latency / power / energy model for (variant × slice) — the port's copy of
the reference package's ``core/perf_model.py``.

These are the REFERENCE's analytic model and constants, kept unchanged so
that the port's simulator, fleet and engine joules are computed by the
same formulas as the reference's and the parity tests compare like with
like.  They are not measurements of the card the port runs on; a power
model of that card is later work (ROADMAP A6).  Three mechanisms:

  1. Batch-1 inference achieves a few-percent utilization of the chip's
     matrix units that *grows* with model size (eff1 ∝ FLOPs^0.55).
     t1 = FLOPs / (peak × eff1).
  2. Model-parallel scaling across a slice follows Amdahl (parallel
     fraction α = W/(W + 2 GF)) plus a per-hop sync term — spreading a
     small model thin *increases* latency (paper Fig. 3's latency cost),
     while large variants still speed up on big slices.
  3. A chip serving a request draws "busy" power (``P_BUSY_W``) regardless
     of how well the request uses it; an idle-but-allocated chip draws
     ``P_IDLE_W``.  Fine partitions keep fewer chips busy per request.

Decode ticks of the real engine are charged at occupancy-scaled power
(:func:`instance_power_w`), prefill at busy power, unaccounted wall time at
idle power.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.core import slices as SL
from repro_torch.core.catalog import Variant

P_IDLE_W = 25.0
P_BUSY_W = 210.0


@dataclasses.dataclass(frozen=True)
class ServicePoint:
    latency_s: float          # single-request service latency on the slice
    throughput_rps: float     # sustained rate of the instance (1/latency)
    busy_power_w: float       # slice power while serving
    energy_per_req_j: float   # at full load
    utilization: float        # matrix-unit utilization while busy (roofline fraction)


def _eff1(v: Variant) -> float:
    """Single-chip batch-1 matrix-unit utilization (grows with model size)."""
    w_g = max(v.flops_g, 1e-3)
    return min(1.2e-3 * w_g ** 0.55, 0.35)


def _alpha(v: Variant) -> float:
    """Amdahl parallel fraction of the per-request work."""
    w = v.flops_g * 1e9
    return w / (w + 2e9)


def _layers_proxy(v: Variant) -> float:
    return 2.0 * math.log2(1.0 + v.params_m)


def latency_s(v: Variant, chips: int) -> float:
    w = v.flops_g * 1e9
    t1 = w / (SL.PEAK_FLOPS_BF16 * _eff1(v))
    a = _alpha(v)
    t = t1 * ((1.0 - a) + a / chips)
    sync = 2.0e-5 * (chips - 1) * _layers_proxy(v)
    return t + sync + 5e-4                     # + host dispatch overhead


def service_point(v: Variant, chips: int) -> ServicePoint:
    lat = latency_s(v, chips)
    tput = 1.0 / lat
    p_busy = chips * P_BUSY_W
    energy = p_busy * lat
    util = (v.flops_g * 1e9) / (chips * SL.PEAK_FLOPS_BF16 * lat)
    return ServicePoint(lat, tput, p_busy, energy, util)


def instance_power_w(chips: int, busy_frac: float) -> float:
    b = min(max(busy_frac, 0.0), 1.0)
    return chips * (P_IDLE_W + (P_BUSY_W - P_IDLE_W) * b)


_CACHE: Dict[Tuple[str, int], ServicePoint] = {}


def cached_point(v: Variant, chips: int) -> ServicePoint:
    key = (v.key, chips)
    if key not in _CACHE:
        _CACHE[key] = service_point(v, chips)
    return _CACHE[key]


def reconfig_seconds(v: Variant, chips: int) -> float:
    """Instance re-instantiation cost: weight reload over DCN (25 GB/s
    aggregate per block) + runtime restart — the paper's repartition +
    service-reinit overhead, charged on every reconfiguration."""
    weight_bytes = v.params_m * 1e6 * 2.0
    return 5.0 + weight_bytes / 25e9
