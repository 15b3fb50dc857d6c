"""Per-request discrete-event serving queue (paper §4.3 load balancer) —
the port's copy of the reference package's ``serving/queue.py``.

Producer/consumer FIFO exactly as the paper describes: requests enter a FIFO
queue; whenever an instance finishes it notifies the consumer, which feeds it
the head-of-line request.  Extensions for scale and fault tolerance:

  * lognormal service-time jitter + a heavy straggler tail;
  * hedged requests: if a request has been in service longer than
    ``hedge_factor × p95`` of that instance's nominal latency, a duplicate is
    dispatched to the next free instance and the first completion wins;
  * fail/repair: instances fail (Poisson) and respawn after a repair time;
    their in-flight request is re-queued at the head (no loss).

It validates the fluid simulator on short horizons, and it is the
backend of the validation CLI (``obs.validate``).  The admission machinery
(done-skipping queue, first-completion-wins, hedge/requeue counters,
pluggable :mod:`repro_torch.serving.policies`) lives in
``serving.scheduler.SchedulerCore``, shared with the real engine.  The
draws come from stdlib ``random`` with the reference's seeds, so every
float equals the reference's.

Two surfaces: :func:`run_des` is the closed-form rate-driven simulation the
fluid-model validation uses; :class:`DESBackend` exposes the same event
machinery through the unified ``ServingBackend`` protocol
(``serving.api``) — typed ``InferenceRequest``s in, per-request responses
with attributed energy/carbon out, any scheduling policy in between.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import config_graph as CG
from repro_torch.core import perf_model as PM
from repro_torch.core.catalog import Variant
from repro_torch.obs import MetricsRegistry, Telemetry
from repro_torch.serving.api import DONE, InferenceRequest, InferenceResponse
from repro_torch.serving.policies import SchedulerPolicy, make_policy
from repro_torch.serving.quality import make_selector
from repro_torch.serving.scheduler import SchedulerCore, latency_percentile


@dataclasses.dataclass
class DESConfig:
    jitter_sigma: float = 0.08          # lognormal sigma on service times
    straggler_prob: float = 0.0         # P[service time × straggler_mult]
    straggler_mult: float = 8.0
    hedge: bool = False
    hedge_factor: float = 3.0
    fail_rate_per_instance_hz: float = 0.0
    repair_time_s: float = 30.0
    seed: int = 0


@dataclasses.dataclass
class DESResult:
    latencies: List[float]
    accuracy_weighted: float
    served: int
    energy_j: float
    hedges: int
    failures: int
    requeues: int

    def _pct(self, q: float) -> float:
        return latency_percentile(self.latencies, q) if self.latencies else 0.0

    def p50(self) -> float:
        return self._pct(50.0)

    def p95(self) -> float:
        return self._pct(95.0)

    def p99(self) -> float:
        return self._pct(99.0)

    def mean_accuracy(self) -> float:
        return self.accuracy_weighted / max(self.served, 1)


class _Instance:
    __slots__ = ("idx", "variant", "chips", "nominal", "busy", "alive",
                 "busy_until", "current")

    def __init__(self, idx: int, variant: Variant, chips: int, nominal: float):
        self.idx = idx
        self.variant = variant
        self.chips = chips
        self.nominal = nominal
        self.busy = False
        self.alive = True
        self.busy_until = 0.0
        self.current: Optional[Tuple[int, float]] = None   # (req id, start)


def run_des(g: CG.ConfigGraph, variants: Sequence[Variant],
            arrival_rps: float, horizon_s: float,
            des: DESConfig = DESConfig(),
            service_time_fn: Optional[Callable] = None) -> DESResult:
    """Event-driven simulation of one configuration for ``horizon_s``."""
    rng = random.Random(des.seed)
    by_name = {v.name: v for v in variants}
    instances: List[_Instance] = []
    for (vname, chips), w in g.edges:
        v = by_name[vname]
        sp = PM.cached_point(v, chips)
        for _ in range(w):
            instances.append(_Instance(len(instances), v, chips, sp.latency_s))

    def sample_service(inst: _Instance) -> float:
        if service_time_fn is not None:
            return service_time_fn(inst.variant, inst.chips)
        t = inst.nominal * math.exp(rng.gauss(0.0, des.jitter_sigma))
        if des.straggler_prob and rng.random() < des.straggler_prob:
            t *= des.straggler_mult
        return t

    # event heap: (time, seq, kind, payload)
    ARRIVE, FINISH, FAIL, REPAIR, HEDGE_CHECK = range(5)
    heap: List[Tuple[float, int, int, tuple]] = []
    seq = 0

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    push(rng.expovariate(arrival_rps), ARRIVE, ())
    for inst in instances:
        if des.fail_rate_per_instance_hz > 0:
            push(rng.expovariate(des.fail_rate_per_instance_hz), FAIL,
                 (inst.idx,))

    core = SchedulerCore()
    req_id = 0
    energy = 0.0
    failures = 0

    def dispatch(now: float):
        nonlocal energy
        free = [i for i in instances if i.alive and not i.busy]
        for inst in free:
            nxt = core.pop_next()
            if nxt is None:
                break
            rid, t_arr = nxt
            svc = sample_service(inst)
            inst.busy = True
            inst.busy_until = now + svc
            inst.current = (rid, t_arr)
            energy += inst.chips * PM.P_BUSY_W * svc
            push(now + svc, FINISH, (inst.idx, rid, t_arr))
            if des.hedge:
                push(now + inst.nominal * des.hedge_factor, HEDGE_CHECK,
                     (inst.idx, rid, t_arr))

    while heap:
        now, _, kind, payload = heapq.heappop(heap)
        if now > horizon_s:
            break
        if kind == ARRIVE:
            core.submit(req_id, now)
            req_id += 1
            push(now + rng.expovariate(arrival_rps), ARRIVE, ())
            dispatch(now)
        elif kind == FINISH:
            idx, rid, t_arr = payload
            inst = instances[idx]
            if inst.current and inst.current[0] == rid and inst.alive:
                inst.busy = False
                inst.current = None
                core.complete(rid, t_arr, now, inst.variant.accuracy)
                dispatch(now)
        elif kind == HEDGE_CHECK:
            idx, rid, t_arr = payload
            if not core.done.get(rid) and instances[idx].current \
                    and instances[idx].current[0] == rid:
                core.hedge_front(rid, t_arr)     # duplicate at head of queue
                dispatch(now)
        elif kind == FAIL:
            (idx,) = payload
            inst = instances[idx]
            if inst.alive:
                inst.alive = False
                failures += 1
                if inst.current is not None:     # re-queue in-flight work
                    rid, t_arr = inst.current
                    if not core.done.get(rid):
                        core.requeue_front(rid, t_arr)
                    inst.current = None
                    inst.busy = False
                push(now + des.repair_time_s, REPAIR, (idx,))
        elif kind == REPAIR:
            (idx,) = payload
            instances[idx].alive = True
            if des.fail_rate_per_instance_hz > 0:
                push(now + rng.expovariate(des.fail_rate_per_instance_hz),
                     FAIL, (idx,))
            dispatch(now)

    # total = busy chip-seconds at P_BUSY + remaining chip-seconds at P_IDLE
    busy_j = energy
    busy_chip_s = busy_j / PM.P_BUSY_W
    idle_chip_s = max(g.total_chips * horizon_s - busy_chip_s, 0.0)
    energy = busy_j + idle_chip_s * PM.P_IDLE_W

    return DESResult(core.latencies, core.acc_weighted, core.served, energy,
                     core.hedges, failures, core.requeues)


# =============================================================================
# ServingBackend protocol over the DES (unified request/response API)
# =============================================================================
class DESBackend:
    """Per-request discrete-event simulation behind the unified
    ``ServingBackend`` protocol (``serving.api``).

    The same typed :class:`~repro_torch.serving.api.InferenceRequest`
    workload the real engine executes runs here analytically: arrivals release on the
    SIMULATED clock (``arrival_s``), a pluggable
    :class:`~repro_torch.serving.policies.SchedulerPolicy` orders admissions
    through the shared :class:`SchedulerCore`, service time is the
    instance's nominal latency scaled by the request's decode budget
    (lognormal jitter from :class:`DESConfig`), and responses carry the
    same per-request attribution contract: busy joules charged to the
    request that burned them, the idle floor spread across the session's
    responses at drain, ``carbon_g = joules × ci_g_per_kwh``.

    Tokens are never generated (``response.tokens is None``) — this backend
    answers scheduling questions (policy orderings, deadline attainment,
    carbon accounting) six orders of magnitude faster than real execution.

    ``ci_g_per_kwh`` may be a constant or a ``ci(now) → gCO2/kWh`` callable
    on the simulated clock (e.g. ``trace.at``): with a time-varying grid a
    request's busy joules are attributed at the CI of its own service
    midpoint and the idle floor at the session-mean CI — so holding work
    into a cleaner window (the carbon policies' whole point) is visible in
    per-request ``carbon_g``, and the responses still sum exactly to
    ``stats()['carbon_g']``.
    """

    _ARRIVE, _FINISH = 0, 1

    def __init__(self, g: CG.ConfigGraph, variants: Sequence[Variant],
                 des: DESConfig = DESConfig(),
                 policy: Union[str, SchedulerPolicy, None] = "fifo",
                 ci_g_per_kwh: Union[float, Callable[[float], float]] = 0.0,
                 tokens_ref: int = 8,
                 hold_retry_s: float = 60.0,
                 telemetry: Optional[Telemetry] = None,
                 quality_selector=None):
        self.g = g
        self.des = des
        self.policy = make_policy(policy)
        self.policy.reset_holds()
        # single-session backend: one registry for its whole life; the
        # tracer (if any) is the caller's persistent recorder
        self.telemetry = telemetry
        self.registry = MetricsRegistry.standard("des")
        if telemetry is not None:
            telemetry.registry = self.registry
        self.tracer = telemetry.tracer if telemetry is not None else None
        self._span_ids: Dict[int, int] = {}     # rid → "request" span sid
        self.ci_g_per_kwh = ci_g_per_kwh
        self.tokens_ref = tokens_ref       # decode budget the nominal maps to
        self.hold_retry_s = hold_retry_s   # clock hop when the policy parks
                                           # the whole queue (carbon hold)
        self._rng = random.Random(des.seed)
        by_name = {v.name: v for v in variants}
        self._instances: List[_Instance] = []
        for (vname, chips), w in g.edges:
            v = by_name[vname]
            sp = PM.cached_point(v, chips)
            for _ in range(w):
                self._instances.append(
                    _Instance(len(self._instances), v, chips, sp.latency_s))
        # mixed-quality request path (serving.quality): decisions at submit
        # on the request's arrival clock, dispatch matches the decided rung
        self.quality_selector = make_selector(quality_selector)
        self._variant_of: Dict[int, str] = {}
        if self.quality_selector is not None:
            ladder = {i.variant.name: i.variant for i in self._instances}
            self.quality_selector.reset(list(ladder.values()))
        self.core = SchedulerCore(self.policy)
        self.now = 0.0
        self._heap: List[Tuple[float, int, int, tuple]] = []
        self._seq = 0
        self._reqs: Dict[int, InferenceRequest] = {}
        self._meters: Dict[int, float] = {}
        self._carbon: Dict[int, float] = {}      # busy gCO2 at service-time CI
        self._starts: Dict[int, float] = {}
        self._responses: List[InferenceResponse] = []   # step's delta buffer
        self._done: List[InferenceResponse] = []        # whole session
        self._busy_j = 0.0
        self._stats: Dict[str, float] = {}

    # --- protocol ------------------------------------------------------------
    def submit(self, req: InferenceRequest) -> None:
        assert req.rid not in self._reqs, f"duplicate rid {req.rid}"
        self._reqs[req.rid] = req
        self._meters[req.rid] = 0.0
        self._carbon[req.rid] = 0.0
        if self.quality_selector is not None:
            dec = self.quality_selector.select(req)
            self._variant_of[req.rid] = dec.variant
        self.registry.counter("requests_submitted").inc()
        self._push(req.arrival_s or 0.0, self._ARRIVE, (req.rid,))

    # --- carbon intensity ----------------------------------------------------
    def _ci_at(self, t: float) -> float:
        ci = self.ci_g_per_kwh
        return float(ci(t)) if callable(ci) else float(ci)

    def _ci_mean(self, t_end: float) -> float:
        """Session-mean CI for the idle floor (trapezoid over the session
        span; exact for a constant grid)."""
        if not callable(self.ci_g_per_kwh):
            return float(self.ci_g_per_kwh)
        if t_end <= 0.0:
            return self._ci_at(0.0)
        import numpy as _np
        ts = _np.linspace(0.0, t_end, 65)
        return float(_np.trapezoid([self._ci_at(float(t)) for t in ts], ts)
                     / t_end)

    def step(self) -> List[InferenceResponse]:
        """Process one event off the heap (advancing the simulated clock).
        When the heap is empty but the policy still parks live work (carbon
        hold), the clock hops ``hold_retry_s`` forward and re-dispatches —
        time passing is what changes the policy's mind."""
        if not self._heap:
            if self.core.has_pending():
                self.now += self.hold_retry_s
                self._dispatch()
            return self._drain_completed()
        t, _, kind, payload = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        if kind == self._ARRIVE:
            (rid,) = payload
            req = self._reqs[rid]
            self.core.submit(rid, self.now, priority=req.priority,
                             deadline_s=req.deadline_s, slo=req.slo)
            self._dispatch()
        elif kind == self._FINISH:
            idx, rid, t_arr = payload
            inst = self._instances[idx]
            if inst.current and inst.current[0] == rid:
                inst.busy = False
                inst.current = None
                self._complete(rid, t_arr, inst)
                self._dispatch()
        return self._drain_completed()

    def drain(self) -> List[InferenceResponse]:
        """Run every submitted request to completion and return ALL of the
        session's responses (including ones a prior ``step`` already
        handed out — the idle floor and carbon attribution must cover the
        whole session, not just the drain-collected tail)."""
        while self._heap or self.core.has_pending() \
                or any(i.busy for i in self._instances):
            self.step()
        self._finalize(self._done)
        return list(self._done)

    def stats(self) -> Dict[str, float]:
        return dict(self._stats)

    # --- internals -----------------------------------------------------------
    def _push(self, t: float, kind: int, payload: tuple) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def _service_s(self, inst: _Instance, req: InferenceRequest) -> float:
        base = inst.nominal * (req.max_new_tokens / self.tokens_ref)
        if self.des.jitter_sigma > 0:
            base *= math.exp(self._rng.gauss(0.0, self.des.jitter_sigma))
        return base

    def _assign(self, inst: _Instance, rid: int, t_arr: float) -> None:
        req = self._reqs[rid]
        svc = self._service_s(inst, req)
        inst.busy = True
        inst.current = (rid, t_arr)
        self._starts[rid] = self.now
        busy_j = inst.chips * PM.P_BUSY_W * svc
        self._meters[rid] += busy_j
        self._carbon[rid] += busy_j / 3.6e6 * self._ci_at(self.now
                                                          + 0.5 * svc)
        self._busy_j += busy_j
        self._push(self.now + svc, self._FINISH, (inst.idx, rid, t_arr))

    def _dispatch(self) -> None:
        if self.quality_selector is not None:
            # mixed-quality routing: the queue head only runs on instances
            # of its decided rung; a variant-busy head blocks the line —
            # the same head-of-line discipline as the real engine's
            # admission loop, so decision → placement replays identically
            while True:
                nxt = self.core.peek_next(self.now)
                if nxt is None:
                    break
                rid, t_arr = nxt
                want = self._variant_of.get(rid)
                inst = next(
                    (i for i in self._instances
                     if i.alive and not i.busy
                     and (want is None or i.variant.name == want)), None)
                if inst is None:
                    break
                self.core.pop_next(self.now)
                self._assign(inst, rid, t_arr)
            return
        for inst in self._instances:
            if inst.busy or not inst.alive:
                continue
            nxt = self.core.pop_next(self.now)
            if nxt is None:
                break
            rid, t_arr = nxt
            self._assign(inst, rid, t_arr)

    def _complete(self, rid: int, t_arr: float, inst: _Instance) -> None:
        req = self._reqs[rid]
        self.core.complete(rid, t_arr, self.now, inst.variant.accuracy)
        start = self._starts.get(rid, t_arr)
        hold = self.policy.hold_info(rid)
        resp = InferenceResponse(
            rid=rid, tokens=None, slo=req.slo, priority=req.priority,
            state=DONE, t_arrival=t_arr, t_finish=self.now,
            queue_delay_s=start - t_arr, ttft_s=self.now - t_arr,
            latency_s=self.now - t_arr, energy_j=self._meters[rid],
            accuracy=inst.variant.accuracy, variant=inst.variant.name,
            deadline_s=req.deadline_s,
            held_s=hold[1] - hold[0] if hold is not None else 0.0,
            release_reason=hold[2] if hold is not None else None)
        self._responses.append(resp)
        self._done.append(resp)
        reg = self.registry
        reg.counter("requests_served").inc()
        reg.histogram("latency_s").observe(resp.latency_s)
        reg.labeled("latency_s", slo_class=req.slo).observe(resp.latency_s)
        reg.histogram("queue_delay_s").observe(resp.queue_delay_s)
        reg.histogram("ttft_s").observe(resp.ttft_s)
        reg.labeled("ttft_s", slo_class=req.slo).observe(resp.ttft_s)
        reg.histogram("accuracy").observe(resp.accuracy)
        reg.labeled("accuracy", slo_class=req.slo).observe(resp.accuracy)
        if not resp.deadline_met:
            reg.counter("deadline_misses").inc()
        if hold is not None:
            reg.counter("holds_released").inc()
            reg.histogram("held_s").observe(resp.held_s)
        if self.tracer is not None:
            tr = self.tracer
            self._span_ids[rid] = tr.span(
                "request", t_arr, self.now, rid=rid, slo=req.slo,
                queue_delay_s=resp.queue_delay_s, n_tokens=0)
            tr.span("service", start, self.now, rid=rid,
                    instance=inst.idx, variant=inst.variant.name)
            if hold is not None:
                tr.span("hold", hold[0], hold[1], rid=rid, reason=hold[2])

    def _drain_completed(self) -> List[InferenceResponse]:
        out, self._responses = self._responses, []
        return out

    def _finalize(self, responses: List[InferenceResponse]) -> None:
        idle_chip_s = max(self.g.total_chips * self.now
                          - self._busy_j / PM.P_BUSY_W, 0.0)
        idle_j = idle_chip_s * PM.P_IDLE_W
        total_j = self._busy_j + idle_j
        share = idle_j / len(responses) if responses else 0.0
        idle_g = idle_j / 3.6e6 * self._ci_mean(self.now)
        share_g = idle_g / len(responses) if responses else 0.0
        for r in responses:
            r.energy_j += share
            # busy gCO2 at each dispatch's service-midpoint CI + an equal
            # share of the idle floor at session-mean CI; for a constant
            # grid this is exactly energy_j × ci
            r.carbon_g = self._carbon.get(r.rid, 0.0) + share_g
            if self.tracer is not None and r.rid in self._span_ids:
                self.tracer.annotate(self._span_ids[r.rid],
                                     energy_j=r.energy_j,
                                     carbon_g=r.carbon_g)
        carbon_total = sum(r.carbon_g for r in responses)
        core = self.core
        reg = self.registry
        reg.counter("energy_j").inc(total_j)
        reg.counter("carbon_g").inc(carbon_total)
        reg.gauge("wall_s").set(self.now)
        if self.telemetry is not None and self.telemetry.feed is not None:
            self.telemetry.feed.record_segment(0.0, self.now, total_j,
                                               carbon_total)
        self._stats = {
            "served": core.served,
            "p50_s": reg.histogram("latency_s").percentile(50.0),
            "p95_s": reg.histogram("latency_s").percentile(95.0),
            "p99_s": reg.histogram("latency_s").percentile(99.0),
            "mean_accuracy": core.acc_weighted / max(core.served, 1),
            "energy_j": reg.value("energy_j"),
            "carbon_g": reg.value("carbon_g"),
            "carbon_g_per_req": carbon_total / max(core.served, 1),
            "wall_s": self.now,
            "deadline_misses": int(reg.value("deadline_misses")),
            "preemptions": 0,
        }
