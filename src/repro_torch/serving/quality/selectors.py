"""Per-request quality selectors (the mixed-quality request path; a copy
of the reference package's ``serving/quality/selectors.py``).

A selector owns a LADDER — the variants actually instantiable on the
backend it serves (the engine's ``build_engine_family`` rungs, a catalog
family's rungs on the DES/fluid) — and maps each request to one rung at
admission time.  The contract that makes one decision sequence replay
bit-identically across the real engine, the DES and the fluid model:

  * decisions are a pure function of (request metadata, the decision
    clock, the selector's own prior decisions).  The decision clock is the
    request's ``arrival_s`` (0 when unset) — a backend-independent number,
    NOT the backend's wall/simulated clock, so the same workload produces
    the same sequence everywhere;
  * grid pressure is read through the policies' ``ci_fn(now)`` contract
    (``fleet.forecast.ForecastCIFn`` or any callable) sampled at the
    decision clock;
  * served-accuracy feedback (the governor's floor window) accumulates at
    decision time with the DECIDED variant's accuracy — routing enforces
    the decision, so this is the served mix, known before service.

Every selector honors the per-request API knobs: ``quality_hint`` pins a
named rung when the ladder has it, and ``min_accuracy`` is a hard floor no
choice may cross.  Decisions append to ``selector.decisions``;
``decision_sequence()`` is the comparable (rid, variant, reason) trace the
conformance tests assert across backends.

The accuracy-floor governor reuses the sliding-window shape of the SLO
burn-rate evaluator (``obs/slo.py``): one pruned ``(t, accuracy)`` deque
per SLO class, so memory is bounded by the window length.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, \
    Union

__all__ = ["QualityDecision", "QualitySelector", "StaticPinSelector",
           "GreedyDownshiftSelector", "AccuracyFloorGovernor",
           "make_selector", "SELECTORS"]


@dataclasses.dataclass(frozen=True)
class QualityDecision:
    """One request's quality routing: the rung it will be served on and
    why.  ``reason`` vocabulary: ``pinned`` (static per-class pin),
    ``default`` (clean grid / no rule engaged), ``downshift`` (dirty-grid
    deferrable drop), ``pressure`` (sustained-dirty interactive drop),
    ``floor`` (governor refused a deeper downshift), ``hint``
    (``quality_hint`` pin), ``min_accuracy`` (per-request floor clamp)."""
    rid: int
    variant: str
    accuracy: float
    reason: str
    slo: str
    t: float                           # the decision clock (arrival_s)


class QualitySelector:
    """Base selector: ladder bookkeeping, per-request clamps, the decision
    log.  Subclasses implement ``_choose(req, t) -> (variant, reason)``."""

    name = "abstract"

    def __init__(self) -> None:
        self._ladder: List = []                 # worst → best
        self._by_name: Dict[str, object] = {}
        self.decisions: List[QualityDecision] = []

    # --- lifecycle -----------------------------------------------------------
    def reset(self, variants: Sequence) -> None:
        """(Re)bind the selector to the variants a backend can actually
        instantiate, worst rung first.  Backends call this when a serve
        session opens — decisions are always clamped to this set, so a
        routed request can never name a variant with no instance."""
        assert variants, "empty quality ladder"
        self._ladder = sorted(variants,
                              key=lambda v: (v.quality, v.accuracy, v.name))
        self._by_name = {v.name: v for v in self._ladder}
        self.decisions = []

    @property
    def best(self):
        return self._ladder[-1]

    @property
    def worst(self):
        return self._ladder[0]

    # --- the per-request decision --------------------------------------------
    def select(self, req, now: Optional[float] = None) -> QualityDecision:
        """Decide the request's rung.  ``now`` overrides the decision clock
        (backends leave it None → ``req.arrival_s``)."""
        assert self._ladder, "reset(variants) before select()"
        t = float(req.arrival_s or 0.0) if now is None else float(now)
        v, reason = self._choose(req, t)
        hint = getattr(req, "quality_hint", None)
        if hint is not None and hint in self._by_name:
            v, reason = self._by_name[hint], "hint"
        floor = getattr(req, "min_accuracy", None)
        if floor is not None and v.accuracy < floor:
            v, reason = self._lowest_at_least(floor), "min_accuracy"
        dec = QualityDecision(req.rid, v.name, v.accuracy, reason, req.slo, t)
        self.decisions.append(dec)
        self._note(dec)
        return dec

    def decision_sequence(self) -> List[Tuple[int, str, str]]:
        """The cross-backend comparable trace."""
        return [(d.rid, d.variant, d.reason) for d in self.decisions]

    # --- subclass hooks ------------------------------------------------------
    def _choose(self, req, t: float):
        raise NotImplementedError

    def _note(self, dec: QualityDecision) -> None:
        """Post-decision feedback (the governor's window); default no-op."""

    # --- helpers -------------------------------------------------------------
    def _lowest_at_least(self, acc_floor: float):
        """Cheapest rung whose accuracy clears ``acc_floor`` (best rung if
        none does — the least-bad violation)."""
        for v in self._ladder:
            if v.accuracy >= acc_floor:
                return v
        return self.best


class StaticPinSelector(QualitySelector):
    """Per-SLO-class pinning: ``pins = {"deferrable": "B1"}`` serves every
    deferrable request on rung B1; unpinned classes ride the best rung.
    The degenerate selector — no grid input — and the operating point that
    separates *having* a request-path knob from *using* it."""

    name = "static"

    def __init__(self, pins: Optional[Dict[str, str]] = None):
        super().__init__()
        self.pins = dict(pins or {})

    def _choose(self, req, t: float):
        pin = self.pins.get(req.slo)
        if pin is not None and pin in self._by_name:
            return self._by_name[pin], "pinned"
        return self.best, "default"


class GreedyDownshiftSelector(QualitySelector):
    """Dirty-grid downshifter over the policies' ``ci_fn`` contract.

    Deferrable requests drop to the WORST rung whenever the nowcast CI
    exceeds ``dirty_threshold_g`` — deferred batch work is exactly the
    traffic whose quality the operator said they'd trade.  Interactive
    requests only move under *sustained* pressure: once the grid has been
    continuously dirty for ``sustain_s`` of decision time they drop ONE
    rung below best (never to the bottom — tail-latency traffic keeps most
    of its accuracy).  A clean nowcast restores everyone to best."""

    name = "greedy"

    def __init__(self, ci_fn: Optional[Callable[[float], float]] = None,
                 dirty_threshold_g: float = 300.0,
                 sustain_s: float = 1800.0):
        super().__init__()
        self.ci_fn = ci_fn
        self.dirty_threshold_g = dirty_threshold_g
        self.sustain_s = sustain_s
        self._dirty_since: Optional[float] = None

    def reset(self, variants: Sequence) -> None:
        super().reset(variants)
        self._dirty_since = None

    def _dirty(self, t: float) -> bool:
        ci = float(self.ci_fn(t)) if self.ci_fn is not None else 0.0
        if ci > self.dirty_threshold_g:
            if self._dirty_since is None:
                self._dirty_since = t
            return True
        self._dirty_since = None
        return False

    def _choose(self, req, t: float):
        if not self._dirty(t):
            return self.best, "default"
        if req.slo == "deferrable":
            return self.worst, "downshift"
        if t - self._dirty_since >= self.sustain_s and len(self._ladder) > 1:
            return self._ladder[-2], "pressure"
        return self.best, "default"


class AccuracyFloorGovernor(QualitySelector):
    """Accuracy-floor governor over a base selector (greedy by default).

    Tracks a windowed request-weighted mean accuracy per SLO class — one
    pruned ``(t, accuracy)`` deque per class, the ``obs/slo.py`` burn-rate
    window shape — and REFUSES any downshift that would drag the window
    mean below the class's configured floor: the candidate is promoted to
    the cheapest rung that keeps ``(window_sum + acc) / (n + 1) ≥ floor``
    (reason ``floor``).  The greedy selector's carbon savings thus come
    with Clover's accuracy constraint enforced per class, online."""

    name = "governed"

    def __init__(self, base: Optional[QualitySelector] = None,
                 floors: Optional[Dict[str, float]] = None,
                 default_floor: float = 0.0, window_s: float = 4 * 3600.0,
                 ci_fn: Optional[Callable[[float], float]] = None,
                 dirty_threshold_g: float = 300.0,
                 sustain_s: float = 1800.0):
        super().__init__()
        self.base = base if base is not None else GreedyDownshiftSelector(
            ci_fn=ci_fn, dirty_threshold_g=dirty_threshold_g,
            sustain_s=sustain_s)
        self.floors = dict(floors or {})
        self.default_floor = default_floor
        self.window_s = window_s
        self._win: Dict[str, Deque[Tuple[float, float]]] = {}

    def reset(self, variants: Sequence) -> None:
        super().reset(variants)
        self.base.reset(variants)
        self._win = {}

    def floor_for(self, slo: str) -> float:
        return self.floors.get(slo, self.default_floor)

    def window_mean(self, slo: str) -> float:
        win = self._win.get(slo)
        if not win:
            return self.best.accuracy
        return sum(a for _, a in win) / len(win)

    def _prune(self, slo: str, t: float) -> None:
        win = self._win.setdefault(slo, deque())
        while win and win[0][0] <= t - self.window_s:
            win.popleft()

    def _choose(self, req, t: float):
        v, reason = self.base._choose(req, t)
        floor = self.floor_for(req.slo)
        if floor <= 0.0:
            return v, reason
        self._prune(req.slo, t)
        win = self._win[req.slo]
        acc_sum, n = sum(a for _, a in win), len(win)
        if (acc_sum + v.accuracy) / (n + 1) >= floor:
            return v, reason
        # refuse the downshift: cheapest rung that keeps the window mean
        # at or above the floor (the best rung is the last resort)
        for cand in self._ladder:
            if cand.accuracy > v.accuracy \
                    and (acc_sum + cand.accuracy) / (n + 1) >= floor:
                return cand, "floor"
        return self.best, "floor"

    def _note(self, dec: QualityDecision) -> None:
        self._win.setdefault(dec.slo, deque()).append((dec.t, dec.accuracy))


SELECTORS: Dict[str, type] = {
    StaticPinSelector.name: StaticPinSelector,
    GreedyDownshiftSelector.name: GreedyDownshiftSelector,
    AccuracyFloorGovernor.name: AccuracyFloorGovernor,
}


def make_selector(spec: Union[str, QualitySelector, None], **kw
                  ) -> Optional[QualitySelector]:
    """Resolve a selector spec the way ``make_policy`` resolves policies:
    None / "off" / "none" → no selector, a name → a fresh instance (extra
    kwargs forwarded; ``ci_fn`` is dropped for selectors that take none),
    an instance → itself."""
    if spec is None or isinstance(spec, QualitySelector):
        return spec
    name = spec.lower()
    if name in ("off", "none", ""):
        return None
    if name not in SELECTORS:
        raise ValueError(f"unknown quality selector {spec!r} "
                         f"(have {sorted(SELECTORS)})")
    cls = SELECTORS[name]
    if cls is StaticPinSelector:
        kw = {k: v for k, v in kw.items()
              if k not in ("ci_fn", "dirty_threshold_g", "sustain_s",
                           "floors", "default_floor", "window_s")}
    elif cls is GreedyDownshiftSelector:
        kw = {k: v for k, v in kw.items()
              if k not in ("floors", "default_floor", "window_s", "pins")}
    return cls(**kw)
