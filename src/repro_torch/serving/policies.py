"""Pluggable scheduling policies over the shared ``SchedulerCore``.

Admission order used to be hard-wired FIFO in both the real engine and the
DES.  A :class:`SchedulerPolicy` turns it into a strategy: given the live
queue entries (in submission order) and the backend's current clock, pick
the entry to admit next — or hold everything (return ``None``) when nothing
*should* run right now, which is how the carbon-aware policy parks
deferrable work under a dirty grid.

Policies are pure selection: they never mutate the queue, never see device
state, and work identically under the real engine's wall clock and the
DES's simulated clock.  ``SchedulerCore`` keeps its plain deque fast path
for FIFO (``is_fifo`` policies), so today's behavior stays bit-identical.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

__all__ = ["SchedulerPolicy", "FIFOPolicy", "PriorityPolicy", "EDFPolicy",
           "CarbonAwarePolicy", "CarbonForecastPolicy", "make_policy"]


class SchedulerPolicy:
    """Selection strategy over pending queue entries.

    ``entries`` arrive in queue order (head first — for FIFO semantics the
    first entry IS the choice); each entry exposes ``rid, t_arrival, seq,
    priority, deadline_s, slo`` (see ``scheduler._Entry``).  Return the index
    of the entry to admit next, or ``None`` to hold the queue."""

    name = "base"
    is_fifo = False                    # True → SchedulerCore's deque fast path

    def select(self, entries: Sequence, now: Optional[float] = None
               ) -> Optional[int]:
        raise NotImplementedError

    # --- hold bookkeeping (observability) ------------------------------------
    # The carbon policies call these from ``select``: ``note_hold`` the first
    # time an entry is parked, ``note_release`` the first time it becomes a
    # candidate again (with the reason: "valley" / "threshold" / "runway").
    # Backends read ``hold_info`` at completion to surface ``held_s`` and the
    # release reason on the InferenceResponse and to emit the "hold" trace
    # span.  Timestamps are whatever clock ``select`` received (session-
    # relative on both the real engine and the DES), so ``held_s`` is a plain
    # duration either way.
    def reset_holds(self) -> None:
        """Forget hold state (the real engine calls this at session open —
        request ids may repeat across serve sessions)."""
        self.__dict__["_holds"] = {}

    def note_hold(self, rid: int, now: Optional[float]) -> None:
        if now is None:
            return
        holds = self.__dict__.setdefault("_holds", {})
        if rid not in holds:
            holds[rid] = [float(now), None, None]   # t_first, t_release, why

    def note_release(self, rid: int, now: Optional[float],
                     reason: str) -> None:
        if now is None:
            return
        rec = self.__dict__.setdefault("_holds", {}).get(rid)
        if rec is not None and rec[1] is None:
            rec[1] = float(now)
            rec[2] = reason

    def hold_info(self, rid: int):
        """(t_first_hold, t_release, reason) for a request that was held and
        released, else None (never held, or still parked)."""
        rec = self.__dict__.get("_holds", {}).get(rid)
        if rec is None or rec[1] is None:
            return None
        return (rec[0], rec[1], rec[2])

    def select_prefill(self, entries: Sequence, now: Optional[float] = None
                       ) -> int:
        """Ordering for an instance's chunked-prefill queue.

        Same selection as admission, with one difference: a prefill queue
        can never be HELD — every entry is already admitted and is holding
        arena blocks, so parking it (as the carbon policies park deferrable
        *admissions* under a dirty grid) would only strand memory.  A
        policy that would hold falls back to the FIFO head."""
        idx = self.select(entries, now)
        return 0 if idx is None else idx


class FIFOPolicy(SchedulerPolicy):
    """Arrival order — today's behavior, bit-identical (the core keeps its
    deque fast path and never calls ``select``)."""

    name = "fifo"
    is_fifo = True

    def select(self, entries, now=None):
        return 0 if entries else None


class PriorityPolicy(SchedulerPolicy):
    """Highest ``priority`` first; FIFO (submission order) within a level."""

    name = "priority"

    def select(self, entries, now=None):
        if not entries:
            return None
        return min(range(len(entries)),
                   key=lambda i: (-entries[i].priority, entries[i].seq))


class EDFPolicy(SchedulerPolicy):
    """Earliest deadline first; requests without a deadline queue FIFO
    behind every deadlined request."""

    name = "edf"

    def select(self, entries, now=None):
        if not entries:
            return None
        inf = float("inf")
        return min(range(len(entries)),
                   key=lambda i: (entries[i].deadline_s
                                  if entries[i].deadline_s is not None
                                  else inf, entries[i].seq))


class CarbonAwarePolicy(SchedulerPolicy):
    """Two-class carbon-aware admission: interactive requests always flow
    (FIFO), deferrable requests are **held while the grid is dirty**
    (``ci_fn(now) > ci_threshold``) and released EDF when it cleans up — or
    force-released regardless of CI once their deadline runway
    (``deadline_s − now``) shrinks below the estimated service time plus
    margin, so a long dirty spell can never turn a hold into a miss.

    ``ci_fn`` may be any ``ci_fn(now) → gCO2/kWh`` callable — a raw trace
    lookup, or a :class:`repro_torch.fleet.forecast.ForecastCIFn` nowcast so this
    policy and :class:`CarbonForecastPolicy` share one CI source."""

    name = "carbon"

    def __init__(self, ci_fn: Callable[[Optional[float]], float],
                 ci_threshold: float, est_service_s: float = 0.0,
                 deadline_margin_s: float = 0.0):
        self.ci_fn = ci_fn
        self.ci_threshold = ci_threshold
        self.est_service_s = est_service_s
        self.deadline_margin_s = deadline_margin_s

    def _must_release(self, e, now: Optional[float]) -> bool:
        if now is None or e.deadline_s is None:
            return False
        runway = e.deadline_s - now
        return runway <= self.est_service_s + self.deadline_margin_s

    def select(self, entries, now=None):
        for i, e in enumerate(entries):        # interactive: plain FIFO
            if e.slo == "interactive":
                return i
        if not entries:
            return None
        clean = self.ci_fn(now) <= self.ci_threshold
        inf = float("inf")
        candidates = []
        for i, e in enumerate(entries):
            if self._must_release(e, now):
                candidates.append(i)
                self.note_release(e.rid, now, "runway")
            elif clean:
                candidates.append(i)
                self.note_release(e.rid, now, "threshold")
            else:
                self.note_hold(e.rid, now)
        if not candidates:
            return None                        # hold: grid dirty, runway wide
        return min(candidates,
                   key=lambda i: (entries[i].deadline_s
                                  if entries[i].deadline_s is not None
                                  else inf, entries[i].seq))


class CarbonForecastPolicy(SchedulerPolicy):
    """Forecast-driven two-class admission (the Clover/EcoServe coupling:
    act on *predicted* carbon, not the instantaneous grid).

    Interactive requests always flow (FIFO).  Each deferrable request is
    scheduled against the **forecast valley inside its own deadline
    runway**: ``ci_fn(now, h)`` is sampled every ``step_s`` out to
    ``min(horizon_s, runway)``, where runway = ``deadline_s − now −
    est_service_s − deadline_margin_s`` (deadline-less requests get the
    full horizon).  The request is released when

      * the nowcast is already within ``valley_tolerance`` of the best
        forecast CI it can still reach — waiting cannot pay; this includes
        a forecast that is flat or *rising* through the whole runway, where
        the raw-threshold policy would still sit out the dirty spell; or
      * the nowcast is under ``ci_threshold`` (optional absolute clean-grid
        fast path, matching :class:`CarbonAwarePolicy`); or
      * the runway is exhausted (force-release — a wrong forecast can never
        turn a hold into a deadline miss).

    Released candidates drain EDF.  ``ci_fn`` must accept ``(now,
    horizon_s)`` — :class:`repro_torch.fleet.forecast.ForecastCIFn` adapts the
    fleet's forecaster ensemble to exactly this contract.  Forecast series
    are memoized per (now, runway) quantized to ``step_s``, so a busy
    engine tick doesn't re-run the forecaster per queued entry."""

    name = "carbon_forecast"

    def __init__(self, ci_fn: Callable[..., float], horizon_s: float,
                 step_s: Optional[float] = None,
                 est_service_s: float = 0.0, deadline_margin_s: float = 0.0,
                 valley_tolerance: float = 0.05,
                 ci_threshold: Optional[float] = None):
        assert horizon_s > 0.0, "need a positive forecast horizon"
        self.ci_fn = ci_fn
        self.horizon_s = horizon_s
        self.step_s = step_s if step_s is not None else horizon_s / 12.0
        self.est_service_s = est_service_s
        self.deadline_margin_s = deadline_margin_s
        self.valley_tolerance = valley_tolerance
        self.ci_threshold = ci_threshold
        self._memo: dict = {}          # (now_q, runway_q) → valley CI

    def _runway(self, e, now: float) -> float:
        if e.deadline_s is None:
            return self.horizon_s
        return (e.deadline_s - now - self.est_service_s
                - self.deadline_margin_s)

    def _valley(self, now: float, runway: float) -> float:
        """Lowest forecast CI reachable within ``runway`` seconds.  The memo
        key includes the ci_fn's epoch (``ForecastCIFn.t0``): a re-anchored
        clock (fleet probe windows) must not serve valleys forecast for a
        different stretch of the grid."""
        h_max = min(runway, self.horizon_s)
        key = (round(now / self.step_s), round(h_max / self.step_s),
               getattr(self.ci_fn, "t0", 0.0))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        valley = float("inf")
        h = self.step_s
        while h <= h_max + 1e-9:
            valley = min(valley, self.ci_fn(now, h))
            h += self.step_s
        if valley == float("inf"):
            # runway shorter than one step: still consult the forecast at
            # the runway's end instead of skipping the valley check entirely
            valley = self.ci_fn(now, h_max)
        if len(self._memo) > 4096:     # bounded: one serve session's worth
            self._memo.clear()
        self._memo[key] = valley
        return valley

    def _release_reason(self, e, now: float,
                        ci_now: float) -> Optional[str]:
        """Why this entry may run now — "runway" / "threshold" / "valley" —
        or None while it should keep waiting for a better valley."""
        runway = self._runway(e, now)
        if runway <= 0.0:
            return "runway"                          # force-release
        if self.ci_threshold is not None and ci_now <= self.ci_threshold:
            return "threshold"                       # grid already clean
        valley = self._valley(now, runway)
        if ci_now <= valley * (1.0 + self.valley_tolerance):
            return "valley"
        return None

    def _release(self, e, now: float, ci_now: float) -> bool:
        return self._release_reason(e, now, ci_now) is not None

    def select(self, entries, now=None):
        for i, e in enumerate(entries):        # interactive: plain FIFO
            if e.slo == "interactive":
                return i
        if not entries:
            return None
        now_f = float(now) if now is not None else 0.0
        ci_now = self.ci_fn(now_f, 0.0)
        candidates = []
        for i, e in enumerate(entries):
            reason = self._release_reason(e, now_f, ci_now)
            if reason is not None:
                candidates.append(i)
                self.note_release(e.rid, now, reason)
            else:
                self.note_hold(e.rid, now)
        if not candidates:
            return None                        # hold: a better valley is near
        inf = float("inf")
        return min(candidates,
                   key=lambda i: (entries[i].deadline_s
                                  if entries[i].deadline_s is not None
                                  else inf, entries[i].seq))


def make_policy(name, **kwargs) -> SchedulerPolicy:
    """Resolve a policy by name (``SchedulerPolicy`` instances pass
    through).  ``carbon`` requires ``ci_fn`` and ``ci_threshold``;
    ``carbon_forecast`` requires ``ci_fn`` and ``horizon_s``."""
    if isinstance(name, SchedulerPolicy):
        return name
    if name is None:
        return FIFOPolicy()
    table = {"fifo": FIFOPolicy, "priority": PriorityPolicy, "edf": EDFPolicy,
             "carbon": CarbonAwarePolicy,
             "carbon_forecast": CarbonForecastPolicy}
    key = str(name).lower()
    if key not in table:
        raise ValueError(f"unknown scheduling policy {name!r} "
                         f"(have {sorted(table)})")
    return table[key](**kwargs)
