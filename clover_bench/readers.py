"""Arithmetic that several metrics share: the tails of the requests due
in the window, the model's share of the card's peak, and the card's idle
share.  Each metric's own file under ``metrics/`` names what it reads."""
from __future__ import annotations

import math
from typing import Dict, Optional

from clover_bench import yardstick as Y


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (nearest rank) of ``values``; None of
    none."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, min(len(v) - 1, math.ceil(q / 100 * len(v)) - 1))]


def ttft_p95_ms(ctx: Dict) -> Optional[float]:
    """p95 over the requests due in the window of first token landed -
    due time; one with no first token counts at the longest wait seen."""
    due = ctx["due_in"]
    t_stop = max([r.first or r.due for r in due] + [ctx["t_w1"]])
    p = percentile([(r.first if r.first is not None else t_stop) - r.due
                    for r in due], 95)
    return None if p is None else 1e3 * p


def tpot_p95_ms(ctx: Dict) -> Optional[float]:
    """p95 over the requests due in the window of (last - first token) /
    (tokens - 1)."""
    p = percentile([(r.last - r.first) / (r.n - 1) for r in ctx["due_in"]
                    if r.first is not None and r.n > 1], 95)
    return None if p is None else 1e3 * p


def mfu(ctx: Dict) -> Optional[float]:
    """Model FLOPs of the profiled slice over its seconds at the bf16
    peak, in %."""
    work, tr = ctx["work"], ctx["trace"]
    if not work or not tr or not work["flops"]:
        return None
    return 100.0 * work["flops"] / (tr["window_s"] * Y.PEAK_BF16)


def device_idle(ctx: Dict) -> Optional[float]:
    """The share (%) of the profiled slice with nothing on the card."""
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
