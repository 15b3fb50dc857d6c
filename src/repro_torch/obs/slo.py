"""Declarative SLO / carbon-budget rules with multi-window burn-rate alerts
— the port's copy of the reference package's ``obs/slo.py``.

The SRE error-budget formulation, applied to both latency SLOs and the
Clover carbon budget:

  * a :class:`LatencyObjective` says "fraction of ``slo_class`` requests
    with ``metric`` ≤ ``threshold_s`` must be ≥ ``target``".  The error
    budget is ``1 − target``; the **burn rate** over a window is
    ``bad_fraction / (1 − target)`` — 1.0 means exactly on budget, 10
    means the budget burns 10× too fast;
  * a :class:`CarbonBudget` says "at most ``budget_g`` gCO2 per
    ``window_s`` of wall time".  Its burn rate over an evaluation window W
    is ``grams_in_W / (budget_g · W / window_s)`` — emitted grams over
    the pro-rated allowance;
  * alerts use the standard **multi-window** guard: fire only when the
    burn rate is ≥ ``fire_burn`` in BOTH the short and the long window
    (short = fast detection, long = deblipping), clear when both drop
    below ``clear_burn``.  With deterministic inputs the fire/clear tick
    sequence is deterministic — the synthetic-trace test pins it exactly.

:class:`SLOEvaluator` holds the rule set + sliding event windows; the
``Controller`` consumes it via ``alerts=`` and forces a re-optimization
the tick a rule starts firing (see ``core.controller``).

Pure stdlib; events are (t, is_bad) / (t, grams) deques pruned beyond the
long window, so memory is bounded by window length, not run length.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["LatencyObjective", "CarbonBudget", "BurnRatePolicy",
           "AlertState", "SLOEvaluator", "default_rules"]


@dataclass(frozen=True)
class LatencyObjective:
    """``target`` fraction of ``slo_class`` requests must have
    ``metric`` ≤ ``threshold_s``."""
    name: str
    threshold_s: float
    target: float = 0.95
    metric: str = "ttft_s"            # "ttft_s" or "latency_s"
    slo_class: str = "interactive"

    def __post_init__(self):
        assert self.metric in ("ttft_s", "latency_s"), self.metric
        assert 0.0 < self.target < 1.0, self.target


@dataclass(frozen=True)
class CarbonBudget:
    """At most ``budget_g`` grams of CO2 per ``window_s`` seconds."""
    name: str
    budget_g: float
    window_s: float = 3600.0

    def __post_init__(self):
        assert self.budget_g > 0 and self.window_s > 0


@dataclass(frozen=True)
class BurnRatePolicy:
    """Multi-window burn-rate thresholds (defaults: page on 2× burn seen
    in both a 5-minute and a 1-hour window; clear below 1×)."""
    short_s: float = 300.0
    long_s: float = 3600.0
    fire_burn: float = 2.0
    clear_burn: float = 1.0

    def __post_init__(self):
        assert 0 < self.short_s <= self.long_s
        assert 0 < self.clear_burn <= self.fire_burn


@dataclass
class AlertState:
    """Deterministic alert lifecycle for one rule."""
    rule: object
    firing: bool = False
    t_fired: Optional[float] = None
    t_cleared: Optional[float] = None
    fire_count: int = 0
    burn_short: float = 0.0
    burn_long: float = 0.0
    transitions: List[Tuple[float, str]] = field(default_factory=list)

    def _update(self, t: float, policy: BurnRatePolicy) -> None:
        if not self.firing and self.burn_short >= policy.fire_burn \
                and self.burn_long >= policy.fire_burn:
            self.firing = True
            self.t_fired = t
            self.fire_count += 1
            self.transitions.append((t, "fire"))
        elif self.firing and self.burn_short < policy.clear_burn \
                and self.burn_long < policy.clear_burn:
            self.firing = False
            self.t_cleared = t
            self.transitions.append((t, "clear"))


class SLOEvaluator:
    """Sliding-window burn-rate evaluation over a declarative rule set."""

    def __init__(self, rules: List[object],
                 policy: BurnRatePolicy = BurnRatePolicy()):
        self.policy = policy
        self.rules: List[object] = list(rules)
        self.states: Dict[str, AlertState] = {}
        seen = set()
        for r in self.rules:
            assert isinstance(r, (LatencyObjective, CarbonBudget)), r
            assert r.name not in seen, f"duplicate rule name {r.name!r}"
            seen.add(r.name)
            self.states[r.name] = AlertState(rule=r)
        # per-(slo_class, metric) deque of (t, is_bad); carbon: (t, grams)
        self._lat: Dict[Tuple[str, str], Deque[Tuple[float, bool]]] = {}
        self._carbon: Deque[Tuple[float, float]] = deque()
        self.total_fires = 0

    # --- ingestion -----------------------------------------------------------
    def record_request(self, t: float, slo_class: str,
                       ttft_s: Optional[float] = None,
                       latency_s: Optional[float] = None) -> None:
        for metric, value in (("ttft_s", ttft_s), ("latency_s", latency_s)):
            if value is None:
                continue
            for r in self.rules:
                if isinstance(r, LatencyObjective) and r.metric == metric \
                        and r.slo_class == slo_class:
                    key = (slo_class, metric)
                    dq = self._lat.setdefault(key, deque())
                    dq.append((float(t), float(value) > r.threshold_s))
                    break   # one event per (class, metric) sample

    def record_carbon(self, t: float, grams: float) -> None:
        if grams > 0:
            self._carbon.append((float(t), float(grams)))

    def observe_response(self, t: float, resp) -> None:
        """Convenience: ingest an ``InferenceResponse``-shaped object."""
        self.record_request(t, getattr(resp, "slo", "interactive"),
                            ttft_s=getattr(resp, "ttft_s", None),
                            latency_s=getattr(resp, "latency_s", None))

    # --- evaluation ----------------------------------------------------------
    def evaluate(self, t: float) -> List[AlertState]:
        """Recompute burn rates at time ``t``, advance every rule's alert
        state machine, and return the states (stable rule order)."""
        self._prune(t)
        for r in self.rules:
            st = self.states[r.name]
            st.burn_short = self._burn(r, t, self.policy.short_s)
            st.burn_long = self._burn(r, t, self.policy.long_s)
            was = st.fire_count
            st._update(t, self.policy)
            self.total_fires += st.fire_count - was
        return [self.states[r.name] for r in self.rules]

    def firing(self) -> List[AlertState]:
        return [s for s in self.states.values() if s.firing]

    # --- internals -----------------------------------------------------------
    def _burn(self, rule, t: float, window_s: float) -> float:
        lo = t - window_s
        if isinstance(rule, LatencyObjective):
            dq = self._lat.get((rule.slo_class, rule.metric))
            if not dq:
                return 0.0
            n = bad = 0
            for ts, is_bad in dq:
                if ts > lo:
                    n += 1
                    bad += is_bad
            if n == 0:
                return 0.0
            return (bad / n) / (1.0 - rule.target)
        grams = sum(g for ts, g in self._carbon if ts > lo)
        allowance = rule.budget_g * (window_s / rule.window_s)
        return grams / allowance

    def _prune(self, t: float) -> None:
        lo = t - self.policy.long_s
        for dq in self._lat.values():
            while dq and dq[0][0] <= lo:
                dq.popleft()
        while self._carbon and self._carbon[0][0] <= lo:
            self._carbon.popleft()


def default_rules(ttft_s: float = 0.5, latency_s: float = 10.0,
                  carbon_g_per_h: float = 50.0) -> List[object]:
    """The rule set the CLI / fleet sim use when none is given: an
    interactive TTFT objective, a batch completion-latency objective, and
    an hourly carbon budget."""
    return [
        LatencyObjective("interactive-ttft", threshold_s=ttft_s,
                         target=0.95, metric="ttft_s",
                         slo_class="interactive"),
        LatencyObjective("deferrable-latency", threshold_s=latency_s,
                         target=0.90, metric="latency_s",
                         slo_class="deferrable"),
        CarbonBudget("hourly-carbon", budget_g=carbon_g_per_h,
                     window_s=3600.0),
    ]
