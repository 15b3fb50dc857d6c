"""Pluggable per-region serving backends for the fleet simulator — the
port's copy of the reference package's ``serving/backends.py``.

The fleet loop (``repro_torch.fleet.fleet_sim``) does its routing /
shifting / elastic-scaling arithmetic against the analytic fluid-window
model — at 48 h and production rates that is the only tractable choice.
This module also lets a region serve through the port's REAL
continuous-batching engine (``serving.engine.RealEngine``, on the GPU or,
on request, the CPU) so a short-horizon run validates the whole control
loop — controller re-optimization, warm reconfiguration, continuous
batching, measured latencies and energy — against real execution instead
of the fluid model alone.

Both region backends speak the unified request/response API
(``serving.api``):

  * ``RealWindowServer`` keeps the FluidServer bookkeeping (capacity,
    backlog, SLA windows) and, per serving window, applies the controller's
    active config through the warm ``configure`` path and runs a probe
    batch of typed ``InferenceRequest``s through the engine — the engine's
    ``ci_g_per_kwh`` is set to the window's carbon intensity first, so
    every probe response carries its attributed gCO2;
  * ``FluidBackend`` wraps the analytic ``FluidServer`` in the
    ``ServingBackend`` protocol (submit/step/drain/stats): requests
    aggregate into per-window arrival rates, responses come back with the
    window's p95 as their latency and an equal share of the window's
    energy/carbon — the cheapest member of the three-backend family
    (real slotted / real paged / fluid in the port) that one workload script
    can sweep.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import carbon as CB
from repro_torch.core import config_graph as CG
from repro_torch.core.catalog import Variant
from repro_torch.obs import MetricsRegistry, Telemetry
from repro_torch.serving import simulator as SIM
from repro_torch.serving.api import DEFERRABLE, DONE, INTERACTIVE, \
    InferenceRequest, InferenceResponse, serve_workload
from repro_torch.serving.quality import make_selector
from repro_torch.serving.scheduler import latency_percentile


def build_real_family(arch: str = "qwen3-1.7b", n_layers: int = 4,
                      fracs=(1.0, 0.5, 0.25), seed: int = 0, device=None):
    """Reduced-depth engine ladder (SMOKE widths, f32) for fleet acceptance
    runs, with random weights from ``seed`` on ``device`` (the GPU by
    default).  torch is imported lazily: the fluid fleet path stays
    importable without the device stack."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import engine as ENG

    base = get_smoke_config(arch).with_(n_layers=n_layers,
                                        dtype=torch.float32)
    return ENG.build_engine_family(base, fracs=fracs, seed=seed,
                                   device=device)


class RealWindowServer(SIM.FluidServer):
    """FluidServer bookkeeping + a real continuous-batching engine in the
    serving loop (see module docstring)."""

    def __init__(self, variants: Sequence[Variant], acct: CB.CarbonAccountant,
                 sla_target_s: float, *, engine, probe_requests: int = 4,
                 prompt_len: int = 6, n_new: int = 4, seed: int = 0,
                 sla_slack: float = 1.001, ci_fn=None,
                 deferrable_frac: float = 0.0, probe_deadline_s: float = 2.0):
        super().__init__(variants, acct, sla_target_s, sla_slack)
        self.engine = engine
        self.probe_requests = probe_requests
        self.prompt_len = prompt_len
        self.n_new = n_new
        # forecaster-driven policy support: ``ci_fn`` is the
        # fleet.forecast.ForecastCIFn the engine's carbon policy reads;
        # probe_window re-anchors its epoch to each window's trace time so
        # the policy's session-relative clock lands on the right grid
        self.ci_fn = ci_fn
        self.deferrable_frac = deferrable_frac
        self.probe_deadline_s = probe_deadline_s
        self._rng = np.random.default_rng(seed)
        self._vocab = next(iter(engine.family.values())).cfg.vocab_size
        self._configured_edges = None
        self._rid = 0
        # measured, real-execution stats
        self.real_latencies: List[float] = []
        self.real_served = 0
        self.real_tokens = 0
        self.real_energy_j = 0.0
        self.real_carbon_g = 0.0       # per-request attributed, window CI
        self.real_preemptions = 0
        self.real_occupancy: List[float] = []
        self.reconfig_s_total = 0.0
        self.n_reconfigs = 0
        # per-SLO-class served-accuracy accumulators (mixed-quality mix)
        self.real_acc_sum: Dict[str, float] = {}
        self.real_acc_n: Dict[str, int] = {}

    # --- controller hook -----------------------------------------------------
    def apply_config(self, g: CG.ConfigGraph) -> None:
        """Warm-reconfigure the engine to the controller's active graph.
        Suspended regions (0 chips) simply drop all instances."""
        if self._configured_edges == g.edges:
            return
        self.reconfig_s_total += self.engine.configure(g)
        self.n_reconfigs += 1
        self._configured_edges = g.edges

    # --- real probe ----------------------------------------------------------
    def probe_window(self, g: CG.ConfigGraph,
                     t: float = 0.0) -> Optional[Dict[str, float]]:
        """Serve a probe batch of typed requests under the active config and
        record measured latency/energy plus per-request carbon attributed at
        the window's CI.  Returns the engine stats (None for a suspended
        region)."""
        if g.total_chips == 0:
            return None
        self.apply_config(g)
        self.engine.ci_g_per_kwh = self.acct.trace.at(t)
        if self.ci_fn is not None:
            # the carbon policy's session clock starts at ~0 every probe:
            # anchor the forecaster onto this window's trace time
            self.ci_fn.set_epoch(t)
        n_defer = int(round(self.probe_requests * self.deferrable_frac))
        reqs = []
        for i in range(self.probe_requests):
            defer = i < n_defer
            reqs.append(InferenceRequest(
                rid=self._rid,
                prompt=self._rng.integers(0, self._vocab,
                                          size=(self.prompt_len,)
                                          ).astype(np.int32),
                max_new_tokens=self.n_new,
                slo=DEFERRABLE if defer else INTERACTIVE,
                deadline_s=self.probe_deadline_s if defer else None))
            self._rid += 1
        responses = serve_workload(self.engine, reqs)
        m = self.engine.stats()
        for r in responses:
            self.real_acc_sum[r.slo] = (self.real_acc_sum.get(r.slo, 0.0)
                                        + r.accuracy)
            self.real_acc_n[r.slo] = self.real_acc_n.get(r.slo, 0) + 1
        self.real_latencies.extend(self.engine.last_latencies)
        self.real_served += int(m["served"])
        self.real_tokens += int(m["tokens"])
        self.real_energy_j += m["energy_j"]
        self.real_carbon_g += sum(r.carbon_g for r in responses)
        self.real_preemptions += int(m.get("preemptions", 0))
        self.real_occupancy.append(m["mean_occupancy"])
        return m

    def real_p95(self) -> float:
        return (latency_percentile(self.real_latencies, 95.0)
                if self.real_latencies else 0.0)

    def accuracy_mix(self) -> Dict[str, float]:
        """Request-weighted mean served accuracy per SLO class, over every
        probe response this server has measured."""
        return {slo: self.real_acc_sum[slo] / self.real_acc_n[slo]
                for slo in sorted(self.real_acc_n) if self.real_acc_n[slo]}


class FluidBackend:
    """The analytic fluid-window model behind the ``ServingBackend``
    protocol.

    Requests aggregate into per-window arrival rates split by SLO class
    (interactive vs deferrable — deferrable work only consumes leftover
    window capacity, exactly the FluidServer contract); completions drain
    FIFO from each class's pending queue as the window's fluid service
    allows.  A response's latency is its completion window's p95 (+ the
    backlog wait already folded in by the model); its energy/carbon is an
    equal share of that window's power × duration at the window's CI.  No
    tokens are generated."""

    def __init__(self, g: CG.ConfigGraph, variants: Sequence[Variant],
                 sla_target_s: float, trace: Optional[CB.CarbonTrace] = None,
                 window_s: float = 60.0, ci_g_per_kwh: float = 0.0,
                 telemetry: Optional[Telemetry] = None,
                 quality_selector=None):
        self.g = g
        self.window_s = window_s
        if trace is None:
            trace = CB.CarbonTrace("flat", np.array([0.0, 365 * 24 * 3600.0]),
                                   np.array([ci_g_per_kwh, ci_g_per_kwh]))
        self.acct = CB.CarbonAccountant(trace)
        self.server = SIM.FluidServer(variants, self.acct, sla_target_s)
        # single-session backend: one registry for its whole life
        self.telemetry = telemetry
        self.registry = MetricsRegistry.standard("fluid")
        if telemetry is not None:
            telemetry.registry = self.registry
        self.tracer = telemetry.tracer if telemetry is not None else None
        # mixed-quality request path: the fluid model serves aggregate
        # rates, so the selector is a decision + attribution overlay — the
        # SAME decision sequence as the event-level backends, with each
        # response carrying its decided rung's name and accuracy
        self.quality_selector = make_selector(quality_selector)
        self._dec: Dict[int, tuple] = {}     # rid → (variant, accuracy)
        if self.quality_selector is not None:
            self.quality_selector.reset(list(variants))
        self.now = 0.0
        self._pending: Dict[str, List[InferenceRequest]] = {
            INTERACTIVE: [], DEFERRABLE: []}
        self._arrived: Dict[str, int] = {INTERACTIVE: 0, DEFERRABLE: 0}
        self._all: List[InferenceRequest] = []
        self._released: set = set()
        self._responses: List[InferenceResponse] = []
        self._stats: Dict[str, float] = {}

    # --- protocol ------------------------------------------------------------
    def submit(self, req: InferenceRequest) -> None:
        self._all.append(req)
        if self.quality_selector is not None:
            d = self.quality_selector.select(req)
            self._dec[req.rid] = (d.variant, d.accuracy)
        self.registry.counter("requests_submitted").inc()

    def step(self) -> List[InferenceResponse]:
        """Serve one fluid window: release arrivals due by its end, serve
        the two-class rates through ``FluidServer.serve_segment``, complete
        as much pending work as the window's fluid service covered."""
        t0, t1 = self.now, self.now + self.window_s
        for req in self._all:
            if (req.arrival_s or 0.0) < t1 and req.rid not in self._released:
                self._released.add(req.rid)
                self._pending[req.slo].append(req)
                self._arrived[req.slo] += 1
        rates = {slo: self._arrived[slo] / self.window_s
                 for slo in self._arrived}
        self._arrived = {INTERACTIVE: 0, DEFERRABLE: 0}
        seg = self.server.serve_segment(self.g, t0, self.window_s,
                                        rates[INTERACTIVE],
                                        rates[DEFERRABLE])
        self.now = t1
        out: List[InferenceResponse] = []
        n_done = (int(round(seg.served)) + int(round(seg.defer_served)))
        window_j = seg.res.power_w * self.window_s
        share_j = window_j / max(n_done, 1)
        ci = seg.ci
        for slo, served in ((INTERACTIVE, int(round(seg.served))),
                            (DEFERRABLE, int(round(seg.defer_served)))):
            q = self._pending[slo]
            for req in q[:served]:
                lat = seg.p95_s
                dec = self._dec.get(req.rid)
                resp = InferenceResponse(
                    rid=req.rid, tokens=None, slo=req.slo,
                    priority=req.priority, state=DONE,
                    t_arrival=req.arrival_s or 0.0, t_finish=t1,
                    queue_delay_s=max(lat, 0.0), ttft_s=lat, latency_s=lat,
                    energy_j=share_j, carbon_g=share_j / 3.6e6 * ci,
                    accuracy=dec[1] if dec is not None else seg.res.accuracy,
                    variant=dec[0] if dec is not None else None,
                    deadline_s=req.deadline_s)
                out.append(resp)
                reg = self.registry
                reg.counter("requests_served").inc()
                reg.histogram("latency_s").observe(resp.latency_s)
                reg.labeled("latency_s",
                            slo_class=req.slo).observe(resp.latency_s)
                reg.histogram("queue_delay_s").observe(resp.queue_delay_s)
                reg.histogram("ttft_s").observe(resp.ttft_s)
                reg.labeled("ttft_s", slo_class=req.slo).observe(resp.ttft_s)
                reg.histogram("accuracy").observe(resp.accuracy)
                reg.labeled("accuracy",
                            slo_class=req.slo).observe(resp.accuracy)
                if not resp.deadline_met:
                    reg.counter("deadline_misses").inc()
                if self.tracer is not None:
                    # fluid latencies are window aggregates, not a real
                    # timeline — span the completion window and carry the
                    # final attribution directly (no post-hoc annotate)
                    self.tracer.span("request", resp.t_arrival, t1,
                                     rid=resp.rid, slo=resp.slo, n_tokens=0,
                                     energy_j=resp.energy_j,
                                     carbon_g=resp.carbon_g)
            del q[:served]
        if self.tracer is not None and n_done:
            self.tracer.span("window", t0, t1, served=n_done,
                             power_w=seg.res.power_w, ci=ci)
        self._responses.extend(out)
        return out

    def drain(self) -> List[InferenceResponse]:
        limit = 10_000                     # windows; the fluid model always
        while limit and (any(self._pending.values())
                         or len(self._released) < len(self._all)):
            self.step()                    # converges — backlog is served
            limit -= 1                     # at capacity every window
        reg = self.registry
        total_j = sum(r.energy_j for r in self._responses)
        total_g = sum(r.carbon_g for r in self._responses)
        reg.counter("energy_j").inc(total_j)
        reg.counter("carbon_g").inc(total_g)
        reg.gauge("wall_s").set(self.now)
        if self.telemetry is not None and self.telemetry.feed is not None:
            self.telemetry.feed.record_segment(0.0, self.now, total_j,
                                               total_g)
        self._stats = {
            "served": int(reg.value("requests_served")),
            "p95_s": self.server.weighted_p95(),
            # with a selector the served mix defines accuracy (each response
            # carries its decided rung); without one, the pool mean
            "mean_accuracy": (reg.histogram("accuracy").mean
                              if self.quality_selector is not None
                              else self.server.mean_accuracy),
            # attributed totals: sums of the per-response shares, so the
            # joules-sum / carbon = J × CI contract holds for this backend
            # too.  The accountant's trace total (which also counts windows
            # that completed nothing) is reported separately.
            "energy_j": reg.value("energy_j"),
            "carbon_g": reg.value("carbon_g"),
            "trace_carbon_g": self.acct.carbon_g,
            "wall_s": self.now,
            "sla_violation_frac": self.server.sla_violation_frac,
            "preemptions": 0,
        }
        return list(self._responses)

    def stats(self) -> Dict[str, float]:
        return dict(self._stats)