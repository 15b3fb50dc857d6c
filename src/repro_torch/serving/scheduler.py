"""Shared scheduler core for the serving layer (paper §4.3 load balancer).

Both serving paths need the same admission machinery and used to duplicate
it: the analytic DES (``serving.queue``) and the real-execution
continuous-batching engine (``serving.engine.RealEngine``).  This module is
the single implementation both build on:

  * an admission queue with lazy completion skipping (a hedged or re-queued
    request may already be done by the time it reaches the head);
  * **pluggable ordering** (``serving.policies.SchedulerPolicy``): entries
    carry priority / deadline / SLO-class metadata and the policy picks the
    next admission — or holds the queue (carbon-aware deferral).  Without a
    policy (or with FIFO) the core runs its original deque fast path,
    bit-identical to the pre-policy behavior;
  * first-completion-wins bookkeeping (hedges dispatch duplicates; only the
    first finish records a latency and an accuracy credit);
  * hedge / fail-repair / preemption requeue counters;
  * nearest-rank latency percentiles (the correct rank rounding — p50 of
    [1, 2, 3, 4] is 2, and p95 never indexes past the end of the sample).

The DES drives it from a simulated-time event heap; the real engine drives
it from wall-clock decode steps.  Neither knows about the other's notion of
time — the core only ever receives timestamps, and passes ``now`` through
to the policy for deadline/CI decisions.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.policies import SchedulerPolicy


def latency_percentile(lats: Sequence[float], q: float) -> float:
    """Percentile of a latency sample with correct rank rounding.

    Nearest-rank on the sorted sample: rank = ceil(q/100 · n), clamped to
    [1, n] — so p50 of [1, 2, 3, 4] is 2 (not 3, as naive ``n//2`` indexing
    gives) and p95 never reads past the end of the list."""
    if not lats:
        return float("nan")
    s = sorted(lats)
    rank = math.ceil(q / 100.0 * len(s))
    return s[min(max(rank, 1), len(s)) - 1]


@dataclasses.dataclass
class _Entry:
    """One queued admission: request id + the metadata policies order by.
    ``seq`` is a monotonic submission counter — the stable FIFO tie-break
    within a priority level / deadline."""
    rid: int
    t_arrival: float
    seq: int
    priority: int = 0
    deadline_s: Optional[float] = None
    slo: str = "interactive"


class SchedulerCore:
    """Admission queue + completion/hedge/requeue bookkeeping.

    Queue entries are ``(request id, arrival time)`` plus policy metadata;
    the payload (prompt, analytic work size, …) stays with the caller,
    keyed by request id.  ``policy=None`` (or any ``is_fifo`` policy) keeps
    the original FIFO deque semantics exactly."""

    def __init__(self, policy: Optional[SchedulerPolicy] = None):
        self.policy = policy
        self._fifo = policy is None or getattr(policy, "is_fifo", False)
        self._queue: Deque[_Entry] = deque()
        self._seq = 0
        self.done: Dict[int, bool] = {}
        self.latencies: List[float] = []
        self.acc_weighted: float = 0.0
        self.served: int = 0
        self.hedges: int = 0
        self.requeues: int = 0

    # --- admission -----------------------------------------------------------
    def submit(self, rid: int, t_arrival: float, *, priority: int = 0,
               deadline_s: Optional[float] = None,
               slo: str = "interactive") -> None:
        """Enqueue a new request at the tail (submission order is the FIFO
        order and every policy's tie-break)."""
        self._queue.append(_Entry(rid, t_arrival, self._seq, priority,
                                  deadline_s, slo))
        self._seq += 1

    def _prune(self) -> None:
        """Drop completed entries.  FIFO only ever needs the head pruned
        (original lazy behavior); policies scan the whole queue, so stale
        interior entries must go before selection."""
        if self._fifo:
            while self._queue and self.done.get(self._queue[0].rid):
                self._queue.popleft()
        else:
            if any(self.done.get(e.rid) for e in self._queue):
                self._queue = deque(e for e in self._queue
                                    if not self.done.get(e.rid))

    def _select(self, now: Optional[float]) -> Optional[int]:
        """Index of the next admission under the policy, or None (empty
        queue, or the policy is holding everything)."""
        self._prune()
        if not self._queue:
            return None
        if self._fifo:
            return 0
        return self.policy.select(list(self._queue), now)

    def pop_next(self, now: Optional[float] = None
                 ) -> Optional[Tuple[int, float]]:
        """Next admission under the policy, or None.  Entries whose request
        already completed (hedge duplicates, stale requeues) are dropped on
        the way — the caller never sees them."""
        idx = self._select(now)
        if idx is None:
            return None
        if idx == 0:
            e = self._queue.popleft()
        else:
            e = self._queue[idx]
            del self._queue[idx]
        return e.rid, e.t_arrival

    def peek_next(self, now: Optional[float] = None
                  ) -> Optional[Tuple[int, float]]:
        """The next admission WITHOUT popping it — admission control that
        depends on the request (does this prompt fit the instance's free
        blocks?) peeks first and only pops once a home is found, so a
        temporarily unadmittable request keeps its queue position."""
        idx = self._select(now)
        if idx is None:
            return None
        e = self._queue[idx]
        return e.rid, e.t_arrival

    def has_pending(self) -> bool:
        """Live entries remain (the policy may still be HOLDING them all —
        ``peek_next`` returning None distinguishes a hold from empty)."""
        self._prune()
        return bool(self._queue)

    # --- priority re-entry ---------------------------------------------------
    def hedge_front(self, rid: int, t_arrival: float, *, priority: int = 0,
                    deadline_s: Optional[float] = None,
                    slo: str = "interactive") -> None:
        """Duplicate a slow in-flight request at the head of the queue; the
        first completion wins (the duplicate's finish becomes a no-op).
        Metadata must match the original submission or a policy would
        mis-order the duplicate (e.g. EDF sorting a deadline-less twin
        behind every deadlined entry)."""
        self._queue.appendleft(_Entry(rid, t_arrival, -self._seq, priority,
                                      deadline_s, slo))
        self._seq += 1
        self.hedges += 1

    def requeue_front(self, rid: int, t_arrival: float, *, priority: int = 0,
                      deadline_s: Optional[float] = None,
                      slo: str = "interactive") -> None:
        """Re-queue a request lost to an instance failure — or swapped out
        by a preemption — at the head (no request loss, original arrival
        time preserved for its latency).  The negative ``seq`` keeps it
        ahead of every same-key entry under any policy's tie-break."""
        self._queue.appendleft(_Entry(rid, t_arrival, -self._seq, priority,
                                      deadline_s, slo))
        self._seq += 1
        self.requeues += 1

    # --- completion ----------------------------------------------------------
    def complete(self, rid: int, t_arrival: float, now: float,
                 accuracy: float = 0.0) -> bool:
        """Record a finish.  Returns True for the first completion of ``rid``
        (latency + accuracy recorded), False for hedge duplicates."""
        if self.done.get(rid):
            return False
        self.done[rid] = True
        self.latencies.append(now - t_arrival)
        self.acc_weighted += accuracy
        self.served += 1
        return True

    # --- stats ---------------------------------------------------------------
    def percentile(self, q: float) -> float:
        return latency_percentile(self.latencies, q) if self.latencies else 0.0
