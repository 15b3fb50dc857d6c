"""Multi-region fleet simulation: Clover per region + global carbon-aware
routing, temporal shifting and elastic block scaling (fleet layer).

Each region runs its own Clover ``Controller`` over its own carbon trace and
serves through the shared fluid-window model (``serving.simulator.FluidServer``
— factored out of ``run_trace`` precisely so this module does not duplicate
it).  On top, per window:

  1. the *router* splits the fleet-wide interactive stream across regions by
     effective carbon/request under capacity + latency constraints;
  2. the *shifting plan* (recomputed every ``replan_every_s`` from CI
     forecasts) releases deferrable job work into its assigned low-carbon
     slots; an emergency path force-releases anything at risk of missing its
     deadline;
  3. *elastic scaling* grows blocks in regions the router is loading and
     shrinks parked regions to ``min_blocks``, reusing
     ``Controller.scale_blocks`` and re-optimizing after every capacity event;
  4. controllers re-optimize on the paper's reactive 5 % trigger *and* the
     predictive forecast trigger, with SA evaluation windows and
     reconfiguration dead time charged inside the serving timeline exactly as
     the single-cluster simulator charges them.

The single-region baseline for comparisons is plain ``run_trace`` with the
deferrable volume folded into its arrival rate — same work mix, no fleet
machinery.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import annealing as SA
from repro_torch.core import carbon as CB
from repro_torch.core import catalog as CAT
from repro_torch.core import config_graph as CG
from repro_torch.core import controller as CTRL
from repro_torch.core import objective as OBJ
from repro_torch.core import perf_model as PM
from repro_torch.core import schemes as SCH
from repro_torch.core import slices as SL
from repro_torch.fleet import forecast as FC
from repro_torch.fleet import router as RT
from repro_torch.fleet import shifting as SH
from repro_torch.fleet import workload as WL
from repro_torch.obs import CarbonFeed, FleetRollup, MetricsRegistry
from repro_torch.serving import simulator as SIM


@dataclasses.dataclass
class FleetConfig:
    # per-region cluster (mirrors SimConfig)
    n_blocks: int = 2
    window_s: float = 600.0
    target_rho: float = 0.7
    lam: float = 0.1
    ci_threshold: float = 0.05
    seed: int = 0
    scheme: str = "CLOVER"
    reconfig_cost: bool = True
    sa: SA.SAConfig = dataclasses.field(default_factory=SA.SAConfig)
    # workload (two classes)
    deferrable_frac: float = 0.2
    n_jobs: int = 12
    min_slack_s: float = 6 * 3600.0
    max_slack_s: float = 18 * 3600.0
    # forecasting + temporal shifting
    forecaster: str = "ensemble"
    forecast_horizon_s: float = 3600.0
    warmup_s: float = 0.0              # trace prefix reserved as forecaster
                                       # history; simulation starts after it
    shifter: str = "greedy"
    plan_slot_s: float = 1800.0
    replan_every_s: float = 3 * 3600.0
    plan_horizon_s: float = 24 * 3600.0
    defer_cap_frac: float = 0.7        # planner uses this fraction of spare
    plan_deadline_margin_s: float = 7200.0   # planner's safety slack per job
    emergency_margin_s: float = 2 * 3600.0
    # spatial routing
    max_rho: float = 0.88
    net_delay_s: float = 0.002         # global front-door network penalty
    # network-egress carbon: hauling a request's payload to a region emits
    # payload_gb_per_req × that region's path intensity (gCO2/GB).  None /
    # 0.0 keeps the latency-only behaviour.
    payload_gb_per_req: float = 0.0
    egress_g_per_gb: Optional[Dict[str, float]] = None    # region → gCO2/GB
    # data gravity: hard per-region interactive rate caps (data residency)
    gravity_caps: Optional[Dict[str, float]] = None       # region → rps
    # deferrable-batch migration cost: moving queued work between regions
    # checkpoints and re-stages it — it lands ``migrate_overhead_s`` later
    # and burns ``migrate_j_per_req`` joules per request moved (charged to
    # the SOURCE region's accountant).  Zero = free moves.
    migrate_overhead_s: float = 0.0
    migrate_j_per_req: float = 0.0
    # elastic block scaling
    elastic: bool = True
    min_blocks: int = 0                # 0 = parked regions fully suspend
    max_blocks: Optional[int] = None   # default: 3 × n_blocks
    scale_every_s: float = 900.0
    scale_rho: float = 0.85            # utilization elastic sizing aims for —
                                       # tight sizing is what makes the
                                       # load-drift trigger pay for itself
    # re-optimize when the routed load drifts, not just the grid: the router
    # reshapes each region's arrival rate every window, and a config
    # optimized for a stale rate wastes power (over-provisioned) or blows
    # p95 (under-provisioned) even at constant carbon intensity
    load_threshold: float = 0.2
    # ablation toggles
    routing_on: bool = True
    shifting_on: bool = True
    predictive_on: bool = True
    # serving backend: "fluid" = analytic window model (default);
    # "real" = fluid bookkeeping + a per-region continuous-batching
    # RealEngine reconfigured through Controller.maybe_reoptimize, probed
    # with real requests every window (short-horizon acceptance runs)
    backend: str = "fluid"
    engine_arch: str = "qwen3-1.7b"
    engine_layers: int = 2             # depth of the x1 engine variant
    engine_slots: int = 2              # KV-cache slots per instance
    engine_max_len: int = 32
    engine_kv_layout: str = "slotted"  # "paged" = kvpool block arena + radix
                                       # prefix cache per region
    engine_policy: str = "fifo"        # SchedulerPolicy name for the probe
                                       # engines (serving.policies).
                                       # "carbon" / "carbon_forecast" are
                                       # built over THIS region's forecaster
                                       # (forecast.ForecastCIFn), not a raw
                                       # trace lookup — the Clover loop acts
                                       # on predicted CI end to end
    engine_policy_horizon_s: float = 3600.0   # forecast-valley horizon fed
                                              # to CarbonForecastPolicy
    engine_ci_threshold_g: float = 300.0      # clean-grid release threshold
                                              # (gCO2/kWh) for both carbon
                                              # policies
    engine_preemption: bool = False    # paged decode-time swap-out
    # per-region disaggregated worker topology: region → (prefill_workers,
    # decode_workers).  A region in the map gets RealEngine(roles=...), a
    # prefill/decode split (serving.disagg.DisaggEngine) that requires the
    # paged KV layout (block handoff); regions not in the map stay
    # monolithic.
    engine_topology: Optional[Dict[str, Tuple[int, int]]] = None
    # mixed-quality request path (serving.quality): a per-request variant
    # selector built over THIS region's forecaster (same nowcast the carbon
    # policies read) and handed to the probe engine.  None/"off" = route
    # everything to the engine family's best rung (no per-request choice);
    # "static" / "greedy" / "governed" select per request at admission
    engine_quality_selector: Optional[str] = None
    engine_accuracy_floor: float = 0.0 # "governed": default per-class floor
                                       # on windowed mean served accuracy
    probe_requests: int = 4            # real requests probed per window
    probe_prompt_len: int = 6
    probe_new_tokens: int = 4
    probe_deferrable_frac: float = 0.0 # fraction of each window's probe batch
                                       # submitted DEFERRABLE with a short
                                       # session-clock deadline, so a carbon
                                       # policy's hold/release path runs on
                                       # real execution every window
    probe_deadline_s: float = 2.0      # that deadline (seconds on the probe
                                       # session's wall clock)

    def resolved_max_blocks(self) -> int:
        return self.max_blocks if self.max_blocks is not None else 3 * self.n_blocks


@dataclasses.dataclass
class RegionReport:
    name: str
    carbon_g: float
    energy_j: float
    served_interactive: float
    served_deferrable: float
    accuracy: float
    p95_s: float
    sla_violation_frac: float
    n_invocations: int
    n_predictive: int
    final_blocks: int
    mean_ci: float
    released_plan: float = 0.0         # deferrable work sent here by the plan
    released_emergency: float = 0.0    # … by the deadline-emergency path
    # real-execution backend stats (zero under the fluid backend)
    real_p95_s: float = 0.0            # measured engine p95 over all probes
    real_served: int = 0               # real requests actually executed
    real_energy_j: float = 0.0         # measured (occupancy-scaled) energy
    real_carbon_g: float = 0.0         # per-request attributed gCO2 (probe
                                       # joules × that window's CI)
    real_preemptions: int = 0          # paged decode-time swap-outs
    real_reconfig_s: float = 0.0       # total warm-reconfiguration seconds
    real_reconfigs: int = 0
    # request-weighted mean served accuracy per SLO class (mixed-quality
    # request path; under the fluid backend both classes sit at the pool
    # mean — no per-request routing happens there)
    accuracy_mix: Dict[str, float] = dataclasses.field(default_factory=dict)
    # streaming telemetry (repro_torch.obs.carbon_feed): totals equal the
    # accountant's by construction; snapshots = emitted feed windows
    feed_energy_j: float = 0.0
    feed_carbon_g: float = 0.0
    feed_snapshots: int = 0


@dataclasses.dataclass
class FleetReport:
    regions: Dict[str, RegionReport]
    carbon_g: float
    served_interactive: float
    served_deferrable: float
    accuracy: float                    # request-weighted fleet-wide mean
    p95_s: float
    sla_target_s: float
    sla_violation_frac: float
    jobs_total: int
    deadline_misses: List[str]
    overflow_req: float
    job_lateness_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    real_p95_s: float = 0.0            # fleet-wide measured engine p95
    real_served: int = 0               # (real-execution backend only)

    # fleet-scope observability: per-region registries merged with bit-
    # exact conservation (sum of region energy_j/carbon_g == fleet totals);
    # ``rollup.merged()`` is the registry the OpenMetrics exporter scrapes
    rollup: Optional[FleetRollup] = None

    @property
    def deadlines_met(self) -> bool:
        return not self.deadline_misses

    @property
    def served_total(self) -> float:
        return self.served_interactive + self.served_deferrable

    def carbon_per_req_g(self) -> float:
        return self.carbon_g / max(self.served_total, 1.0)


class _Region:
    """Runtime state of one region's cluster."""

    def __init__(self, name: str, trace: CB.CarbonTrace, family: str,
                 cfg: FleetConfig, engine_family=None):
        simcfg = SIM.SimConfig(n_blocks=cfg.n_blocks, window_s=cfg.window_s,
                               target_rho=cfg.target_rho, lam=cfg.lam,
                               ci_threshold=cfg.ci_threshold, seed=cfg.seed,
                               reconfig_cost=cfg.reconfig_cost, sa=cfg.sa)
        self.name = name
        self.trace = trace
        self.cfg = cfg
        if engine_family is not None:
            # the controller optimizes over the ENGINE ladder's variants, so
            # its configs name real instances the engine can instantiate
            variants = [ev.variant for ev in engine_family]
            family = engine_family[0].variant.family
            self.ctx, self.base_arrival = SIM.make_context(
                family, simcfg, variants=variants)
        else:
            self.ctx, self.base_arrival = SIM.make_context(family, simcfg)
        self.forecaster = FC.make_forecaster(cfg.forecaster, trace)
        self.controller = CTRL.Controller(
            SCH.make_scheme(cfg.scheme), self.ctx,
            ci_threshold=cfg.ci_threshold,
            forecaster=self.forecaster if cfg.predictive_on else None,
            forecast_horizon_s=cfg.forecast_horizon_s)
        self.acct = CB.CarbonAccountant(trace)
        # streaming per-region telemetry: every accountant segment forwards
        # its exact joules/grams into this feed (one snapshot per fleet
        # window's worth of accumulation), and the controller can consume
        # the feed's measured CI in place of a raw trace lookup
        self.feed = CarbonFeed(trace.at, interval_s=cfg.window_s,
                               region=name, pue=self.acct.pue)
        self.acct.feed = self.feed
        self.controller.feed = self.feed
        # per-region metrics registry (region constant label): totals fold
        # in at report time and the fleet rollup merges every region's
        # registry with bit-exact conservation
        self.registry = MetricsRegistry.standard(name,
                                                 labels={"region": name})
        if engine_family is not None:
            # lazy imports: the fluid path must not depend on torch
            from repro_torch.serving import backends as BK
            from repro_torch.serving import engine as ENG
            from repro_torch.serving import policies as POL
            # carbon policies read THIS region's forecaster through the
            # ci_fn contract — the probe engine schedules on predicted CI,
            # re-anchored to each window's trace time by probe_window.  The
            # probe session's wall clock crawls relative to the trace, so
            # ForecastCIFn maps the probe DEADLINE runway onto the
            # configured forecast horizon: a deferrable probe's few seconds
            # of session runway span engine_policy_horizon_s of grid time,
            # and the valley logic genuinely engages every window.
            policy = cfg.engine_policy
            probe_ci_fn = None
            if cfg.engine_policy in ("carbon", "carbon_forecast"):
                scale = (cfg.engine_policy_horizon_s
                         / max(cfg.probe_deadline_s, 1e-9))
                probe_ci_fn = FC.ForecastCIFn(self.forecaster,
                                              time_scale=scale)
                # force-release while half the session deadline budget
                # remains — a hold must never turn a probe into a miss
                margin = 0.5 * cfg.probe_deadline_s
                if cfg.engine_policy == "carbon":
                    policy = POL.CarbonAwarePolicy(
                        probe_ci_fn, ci_threshold=cfg.engine_ci_threshold_g,
                        deadline_margin_s=margin)
                else:
                    policy = POL.CarbonForecastPolicy(
                        probe_ci_fn, horizon_s=cfg.probe_deadline_s,
                        step_s=cfg.probe_deadline_s / 12.0,
                        ci_threshold=cfg.engine_ci_threshold_g,
                        deadline_margin_s=margin)
            # mixed-quality request path: the selector reads the SAME
            # forecaster nowcast as the carbon policies.  If no carbon
            # policy built a ForecastCIFn, build one anyway (fifo + greedy
            # selector is a legitimate operating point) — probe_window's
            # set_epoch re-anchors it per window either way.
            selector = None
            if cfg.engine_quality_selector not in (None, "off", "none", ""):
                from repro_torch.serving import quality as QL
                if probe_ci_fn is None:
                    scale = (cfg.engine_policy_horizon_s
                             / max(cfg.probe_deadline_s, 1e-9))
                    probe_ci_fn = FC.ForecastCIFn(self.forecaster,
                                                  time_scale=scale)
                selector = QL.make_selector(
                    cfg.engine_quality_selector, ci_fn=probe_ci_fn,
                    dirty_threshold_g=cfg.engine_ci_threshold_g,
                    default_floor=cfg.engine_accuracy_floor)
            # disaggregated regions: RealEngine(roles=...) builds a
            # DisaggEngine (prefill/decode worker split) behind the same
            # protocol — it requires the paged arena for handoff
            roles = (cfg.engine_topology or {}).get(self.name)
            if roles is not None:
                assert cfg.engine_kv_layout == "paged", \
                    f"engine_topology[{self.name!r}] needs " \
                    f"engine_kv_layout='paged' (block handoff), got " \
                    f"{cfg.engine_kv_layout!r}"
            # the engine runs where the ladder's weights live (the GPU for
            # a family built with no device, the CPU for one built there)
            device = next(engine_family[0].params.parameters()).device
            eng = ENG.RealEngine(engine_family, n_slots=cfg.engine_slots,
                                 max_len=cfg.engine_max_len,
                                 kv_layout=cfg.engine_kv_layout,
                                 policy=policy,
                                 preemption=cfg.engine_preemption,
                                 quality_selector=selector,
                                 roles=roles, device=device)
            self.server = BK.RealWindowServer(
                self.ctx.variants, self.acct, self.ctx.obj_cfg.l_tail_s,
                engine=eng, probe_requests=cfg.probe_requests,
                prompt_len=cfg.probe_prompt_len, n_new=cfg.probe_new_tokens,
                seed=cfg.seed, ci_fn=probe_ci_fn,
                deferrable_frac=cfg.probe_deferrable_frac,
                probe_deadline_s=cfg.probe_deadline_s)
            # reconfigurations flow through Controller.maybe_reoptimize /
            # scale_blocks straight into the engine's warm configure
            self.controller.on_config_change = self.server.apply_config
        else:
            self.server = SIM.FluidServer(self.ctx.variants, self.acct,
                                          self.ctx.obj_cfg.l_tail_s)
        self.queue: List[List] = []    # [deadline, job_id, work] — EDF heap-ish
        self.int_rate = self.base_arrival
        self.last_scale_t = -math.inf
        self.pending_outcome: Optional[SA.SAOutcome] = None
        self.last_opt_load: Optional[float] = None
        # stable per-block capacity reference for elastic sizing: the BASE
        # operating point (optimized configs inflate capacity with small
        # variants — sizing against that reference would shed blocks the SLA
        # still needs)
        self.base_block_rps = self.base_arrival / (cfg.target_rho
                                                   * cfg.n_blocks)
        # stable energy/request reference for routing and shifting costs.
        # Using the *current* config's energy would let a region's transient
        # partitioning state outvote its grid: whichever cluster happens to
        # hold a fine-partitioned config looks "cheap" even under a dirty
        # grid.  All regions share the hardware model, so the stable
        # reference makes spatial cost differences pure carbon-intensity
        # differences.
        self.ref_energy_j = OBJ.evaluate(
            SCH.base_config(self.ctx), self.variants,
            self.base_arrival).energy_per_req_j

    @property
    def variants(self):
        return self.ctx.variants

    def capacity_rps(self) -> float:
        return OBJ.evaluate(self.controller.config, self.variants,
                            1e-9).capacity_rps

    def enqueue(self, deadline_s: float, job_id: str, work: float) -> None:
        if work <= 1.0:
            # sub-request dust from fractional release arithmetic: below the
            # fluid model's resolution, but a dust entry stranded in a region
            # that later suspends would record the whole job as finishing
            # whenever that region next revives
            return
        self.queue.append([deadline_s, job_id, work])
        self.queue.sort()

    def dequeue(self, served: float, now: float,
                done_t: Dict[str, float]) -> None:
        """Drain ``served`` deferrable requests EDF; record completion.
        Residuals ≤ 1 request are dust (see enqueue) — popped with the entry
        rather than left to pin the job's completion time to whenever this
        region next serves deferrable work."""
        while served > 1e-9 and self.queue:
            entry = self.queue[0]
            take = min(served, entry[2])
            entry[2] -= take
            served -= take
            if entry[2] <= 1.0:
                self.queue.pop(0)
                done_t[entry[1]] = max(done_t.get(entry[1], 0.0), now)

    def _charge_outcome(self, outcome: SA.SAOutcome, start: float,
                        remaining: float, int_rate: float, defer_rps: float,
                        net_delay_s: float) -> Tuple[float, float]:
        """Serve SA evaluation windows under their candidate configs, clipped
        to the current fleet window (SAConfig.time_limit ≤ window by default,
        so clipping is the rare overrun case)."""
        for ev in outcome.evaluations:
            if remaining <= 1e-9:
                break
            w = min(self.ctx.sa_cfg.eval_window_s, remaining)
            self.server.serve_segment(ev.graph, start, w, int_rate,
                                      defer_rps, net_delay_s)
            start += w
            remaining -= w
        return start, remaining

    def step(self, t: float, dur: float, int_rate: float, defer_rps: float,
             net_delay_s: float, reconfig_cost: bool) -> None:
        """One fleet window: optimizer triggers (eval windows + reconfig dead
        time charged inside the window), then fluid serving."""
        ctrl = self.controller
        start, remaining = t, dur
        ci = self.trace.at(t)
        # the optimizer must see the load the router actually assigned, not
        # the static sizing rate the context was built with — and a material
        # load drift is itself a re-optimization trigger (the capacity-event
        # analogue of the paper's λ/SLA-change triggers)
        load = int_rate + defer_rps
        self.ctx.arrival_rps = load
        if (self.last_opt_load is not None
                and ctrl.config is not None and ctrl.config.total_chips > 0
                and abs(load - self.last_opt_load)
                / max(self.last_opt_load, 1e-9) > self.cfg.load_threshold):
            ctrl.last_opt_ci = None
        if self.pending_outcome is not None:    # the start() invocation
            start, remaining = self._charge_outcome(
                self.pending_outcome, start, remaining, int_rate, defer_rps,
                net_delay_s)
            self.pending_outcome = None
            self.last_opt_load = load
        elif ctrl.config.total_chips == 0:
            pass    # suspended region: nothing to optimize, zero power draw
        elif ctrl.should_reoptimize(ci, t):
            prev = ctrl.config
            new_cfg, outcome = ctrl.maybe_reoptimize(t, ci)
            self.last_opt_load = load
            if outcome is not None:
                start, remaining = self._charge_outcome(
                    outcome, start, remaining, int_rate, defer_rps,
                    net_delay_s)
            if (reconfig_cost and remaining > 1e-9
                    and new_cfg.edges != prev.edges):
                by_name = {v.name: v for v in self.variants}
                dt = max((PM.reconfig_seconds(by_name[vn], c)
                          for (vn, c), _ in new_cfg.edges), default=0.0)
                dt = min(dt, remaining)
                idle_power = sum(PM.instance_power_w(c, 0.0) * w
                                 for (vn, c), w in new_cfg.edges)
                self.acct.add(start, dt, idle_power)
                # work keeps arriving through the dead time — both classes
                # (dropping the deferrable share here would strand enqueued
                # job work that the EDF queue still expects to drain)
                self.server.backlog += int_rate * dt
                self.server.defer_backlog += defer_rps * dt
                start += dt
                remaining -= dt
        if remaining > 1e-9:
            self.server.serve_segment(ctrl.config, start, remaining, int_rate,
                                      defer_rps, net_delay_s)
        # real-execution backend: drive this window's active config through
        # the region's engine and measure a probe batch of typed requests
        # (per-request carbon attributed at this window's CI)
        probe = getattr(self.server, "probe_window", None)
        if probe is not None:
            probe(ctrl.config, t)

    def rescale(self, t: float, need_rps: float, cfg: FleetConfig) -> None:
        """Size the block count so the assigned load lands near ``scale_rho``
        utilization of the *realized* per-block capacity.  Optimized configs
        carry substantially more throughput per block than BASE, so sizing
        against the BASE reference over-provisions ~2× and the idle power of
        the surplus blocks dominates carbon/request; the realized estimate is
        still clamped to a sane band around the BASE reference so one extreme
        config can't whipsaw the fleet."""
        if not cfg.elastic:
            return
        # cooldown damps resize churn, but revival from full suspension must
        # bypass it: the router can assign a suspended region traffic the
        # moment its grid turns cleanest, and with capacity 0 that whole
        # window's stream would backlog unserved
        if self.ctx.n_blocks > 0 and t - self.last_scale_t < cfg.scale_every_s:
            return
        per_block = self.capacity_rps() / max(self.ctx.n_blocks, 1)
        per_block = min(max(per_block, self.base_block_rps),
                        2.5 * self.base_block_rps)
        desired = math.ceil(need_rps / max(cfg.scale_rho * per_block, 1e-9))
        desired = min(max(desired, cfg.min_blocks), cfg.resolved_max_blocks())
        if desired != self.ctx.n_blocks:
            self.controller.scale_blocks(desired - self.ctx.n_blocks)
            self.controller.last_opt_ci = None   # capacity event → re-optimize
            self.last_scale_t = t


def _rebalance_queues(regions: Sequence[_Region], t: float,
                      caps: Dict[str, float],
                      headroom: float = 0.7,
                      lookahead_s: float = 8 * 3600.0,
                      cfg: Optional[FleetConfig] = None) -> None:
    """Work stealing for queued deferrable backlog: an entry whose deadline
    is EDF-infeasible against its region's realized spare capacity migrates
    to the region with the most spare.  Deferrable batches are portable; a
    queue is not a commitment to drain in place, and without this a region
    that scales down (or suspends) after accepting work strands it.

    Moves are NOT free (``cfg.migrate_overhead_s`` / ``migrate_j_per_req``):
    the batch checkpoints, ships, and re-stages, so the destination only has
    ``deadline − t − overhead`` seconds of runway for it, and the
    checkpoint+transfer energy is charged to the SOURCE region's accountant
    at move time.  A move that no longer pays off under those costs — the
    destination's overhead-discounted slack is no better than just staying
    put — is skipped.

    Must run before this window's releases: at that point each region's
    queue total equals its server's deferrable backlog, so moving an entry
    moves fluid work the server has not yet absorbed elsewhere."""
    overhead_s = cfg.migrate_overhead_s if cfg is not None else 0.0
    j_per_req = cfg.migrate_j_per_req if cfg is not None else 0.0
    spare = {r.name: max(caps[r.name] - r.int_rate, 0.0) for r in regions}
    queued = {r.name: sum(e[2] for e in r.queue) for r in regions}
    for src in regions:
        cum = 0.0
        for entry in list(src.queue):
            dl, job_id, w = entry
            horizon = max(dl - t, 60.0)
            cum += w
            if (dl - t > lookahead_s
                    or cum / horizon <= headroom * spare[src.name]):
                continue

            def slack_src(r: _Region) -> float:
                return (headroom * spare[r.name]
                        - (queued[r.name] + w) / horizon)

            # migrated work arrives ``overhead_s`` late: the receiver's
            # runway shrinks, so a near-deadline entry may be unmovable even
            # into an idle region — checkpointing it would eat the slack the
            # move was supposed to buy.  With zero overhead the destination
            # shares the source's 60 s floor (free instant moves), so the
            # guard below can only fire when a real re-stage delay exists.
            horizon_dst = dl - t - overhead_s
            if overhead_s <= 0.0:
                horizon_dst = max(horizon_dst, 60.0)

            def slack_dst(r: _Region) -> float:
                if horizon_dst < 60.0:
                    return -math.inf           # can't re-stage before deadline
                return (headroom * spare[r.name]
                        - (queued[r.name] + w) / horizon_dst)

            dst = max((r for r in regions if r is not src),
                      key=slack_dst, default=None)
            if dst is None or slack_dst(dst) <= slack_src(src) + 1e-9:
                continue               # move doesn't pay — leave it
            src.queue.remove(entry)
            src.server.defer_backlog = max(
                src.server.defer_backlog - w, 0.0)
            dst.server.defer_backlog += w
            dst.enqueue(dl, job_id, w)
            if j_per_req > 0.0:
                # checkpoint + transfer energy, charged where the data
                # leaves (1 s accounting window at the equivalent power —
                # CarbonAccountant integrates power × duration)
                src.acct.add(t, 1.0, w * j_per_req)
            queued[src.name] -= w
            queued[dst.name] += w
            cum -= w


def _snapshot(r: _Region, t: float, cfg: FleetConfig) -> RT.RegionSnapshot:
    """Router view of a region: live capacity and p95 from the active config,
    stable reference energy (see _Region.ref_energy_j).

    A suspended region (0 blocks) advertises a hypothetical single BASE
    block instead of its true zero capacity: with capacity 0 the router can
    never assign it traffic, rescale never sees demand, and the region is
    unreachable forever — even when its grid becomes the cleanest.  The
    routed rate itself triggers the spin-up: rescale() runs after routing
    but before serving in the same window."""
    graph, variants = r.controller.config, r.variants
    if graph.total_chips == 0:
        best = CAT.best_variant(variants)
        graph = CG.ConfigGraph.uniform(r.ctx.family, best.name,
                                       SL.BLOCK_CHIPS, 1)
    probe = OBJ.evaluate(graph, variants, 1e-9)

    def p95_at(rate: float) -> float:
        return OBJ.evaluate(graph, variants, max(rate, 1e-9)).p95_latency_s

    return RT.RegionSnapshot(
        r.name, probe.capacity_rps, r.ref_energy_j, r.trace.at(t),
        cfg.net_delay_s, p95_at,
        egress_gb_per_req=cfg.payload_gb_per_req,
        egress_g_per_gb=(cfg.egress_g_per_gb or {}).get(r.name, 0.0),
        gravity_cap_rps=(cfg.gravity_caps or {}).get(r.name, math.inf))


def _plan_slots(regions: Sequence[_Region], t: float, horizon_end: float,
                total_int_rps: float, cfg: FleetConfig) -> List[SH.Slot]:
    """Candidate (region × window) slots with forecast CI and spare capacity.

    Capacity assumes the region may scale to ``max_blocks`` when elastic
    (that is exactly what rescale() will do once the plan routes work there),
    sized against the conservative BASE per-block reference — the same one
    rescale() uses; optimized configs inflate capacity and over-promising
    spare is how deadlines get missed.

    The interactive share reserved per future slot is NOT the current routed
    rate: the router chases the same clean windows the shifter wants, so the
    planner replays the router's greedy water-fill against the *forecast* CI
    of each slot.  Without this, all spare appears to live in dirty-but-idle
    regions and deferrable work gets shifted exactly where it should not go."""
    blocks = {r.name: (cfg.resolved_max_blocks() if cfg.elastic
                       else r.ctx.n_blocks) for r in regions}
    cap_plan = {r.name: r.base_block_rps * blocks[r.name] for r in regions}
    slots: List[SH.Slot] = []
    s0 = t
    while s0 + cfg.plan_slot_s <= horizon_end + 1e-9:
        mid = s0 + 0.5 * cfg.plan_slot_s        # always > t: s0 starts at t
        ci_hat = {r.name: r.forecaster.predict(t, mid - t) for r in regions}
        # expected interactive routing at this slot: cleanest-first water-fill
        expected_int = {r.name: 0.0 for r in regions}
        remaining = total_int_rps
        for r in sorted(regions, key=lambda r: ci_hat[r.name]):
            take = min(remaining, cfg.max_rho * cap_plan[r.name])
            expected_int[r.name] = take
            remaining -= take
        for r in regions:
            spare = max(0.0, cfg.defer_cap_frac
                        * (cfg.max_rho * cap_plan[r.name]
                           - expected_int[r.name]))
            slots.append(SH.Slot(r.name, s0, cfg.plan_slot_s, spare,
                                 ci_hat[r.name], r.ref_energy_j))
        s0 += cfg.plan_slot_s
    return slots


def run_fleet(family: str, traces: Dict[str, CB.CarbonTrace],
              cfg: FleetConfig = FleetConfig(),
              engine_family=None) -> FleetReport:
    """Run the fleet over ``traces``.  With ``backend="real"`` every region
    serves its probes through a ``RealEngine`` over one shared ladder:
    ``engine_family`` when given (any width, on any device; pass
    ``build_real_family(..., device="cpu")`` for the CPU), else the
    reference's reduced SMOKE ladder from ``build_real_family`` on the GPU.
    The fluid backend ignores it."""
    if cfg.backend != "real":
        engine_family = None
    elif engine_family is None:
        # one ladder for the whole fleet: regions share weights (per-region
        # isolation lives in each engine's instance caches, not the
        # parameters)
        from repro_torch.serving import backends as BK
        engine_family = BK.build_real_family(
            cfg.engine_arch, cfg.engine_layers, seed=cfg.seed)
    regions = [_Region(name, tr, family, cfg, engine_family)
               for name, tr in traces.items()]
    by_name = {r.name: r for r in regions}
    duration = min(tr.duration_s for tr in traces.values())
    t_start = cfg.warmup_s        # traces before t_start are history only
    if t_start >= duration:
        raise ValueError("warmup_s consumes the whole trace")
    total_int = sum(r.base_arrival for r in regions)

    workload = WL.make_workload(total_int, duration - t_start,
                                deferrable_frac=cfg.deferrable_frac,
                                n_jobs=cfg.n_jobs,
                                min_slack_s=cfg.min_slack_s,
                                max_slack_s=cfg.max_slack_s, seed=cfg.seed)
    if t_start > 0:               # shift job times onto the absolute clock
        workload = WL.FleetWorkload(
            workload.interactive_rps,
            tuple(WL.DeferrableJob(j.job_id, j.arrival_s + t_start,
                                   j.work_req, j.deadline_s + t_start)
                  for j in workload.jobs))
    unscheduled = {j.job_id: j.work_req for j in workload.jobs}
    deadline = {j.job_id: j.deadline_s for j in workload.jobs}
    arrival_t = {j.job_id: j.arrival_s for j in workload.jobs}
    done_t: Dict[str, float] = {}
    plan = SH.ShiftPlan([], {})
    next_replan = t_start
    overflow_req = 0.0
    released_plan = {r.name: 0.0 for r in regions}
    released_emergency = {r.name: 0.0 for r in regions}

    for r in regions:
        r.controller.start(t_start, r.trace.at(t_start))
        if r.controller.invocations:
            r.pending_outcome = r.controller.invocations[-1].outcome

    t = t_start
    while t < duration - 1e-9:
        dur = min(cfg.window_s, duration - t)

        # 1. (re)plan temporal shifting over the forecast horizon
        if cfg.shifting_on and t >= next_replan:
            horizon_end = min(t + cfg.plan_horizon_s, duration)
            slots = _plan_slots(regions, t, horizon_end, total_int, cfg)
            live_jobs = [
                WL.DeferrableJob(
                    j, max(arrival_t[j], t), w,
                    # plan to finish a margin early; the true deadline still
                    # governs the emergency path and the miss report
                    max(deadline[j] - cfg.plan_deadline_margin_s,
                        max(arrival_t[j], t) + cfg.plan_slot_s))
                for j, w in unscheduled.items() if w > 1e-9]
            plan = SH.make_shifter(cfg.shifter)(live_jobs, slots)
            next_replan = t + cfg.replan_every_s

        # 2. route the interactive stream (before releases/rebalance so the
        # deferrable logic sees this window's spare, not last window's)
        sla = regions[0].ctx.obj_cfg.l_tail_s
        if cfg.routing_on:
            snaps = [_snapshot(r, t, cfg) for r in regions]
            decision = RT.route_interactive(
                total_int, snaps, sla, max_rho=cfg.max_rho,
                prev_rates={r.name: r.int_rate for r in regions})
            overflow_req += decision.overflow_rps * dur
            for r in regions:
                r.int_rate = decision.rate(r.name)
        else:
            for r in regions:
                r.int_rate = r.base_arrival

        # capacity snapshot for steps 3-4 (configs don't change again until
        # rescale/serve — re-evaluating the graph per job per region is the
        # same number many times over)
        caps = {r.name: r.capacity_rps() for r in regions}

        # 3. migrate deadline-threatened queued work before new releases
        # (charging checkpoint/transfer cost, skipping unpaying moves)
        _rebalance_queues(regions, t, caps, cfg=cfg)

        # 4. release planned deferrable work arriving in this window
        release: Dict[str, float] = {r.name: 0.0 for r in regions}
        if cfg.shifting_on:
            for a in plan.allocations:
                if unscheduled.get(a.job_id, 0.0) <= 1e-9:
                    continue
                overlap = max(0.0, min(a.t0 + a.dur_s, t + dur) - max(a.t0, t))
                if overlap <= 0.0:
                    continue
                w = min(a.work_req * overlap / a.dur_s,
                        unscheduled[a.job_id])
                unscheduled[a.job_id] -= w
                release[a.region] += w
                released_plan[a.region] += w
                by_name[a.region].enqueue(deadline[a.job_id], a.job_id, w)
        # emergency: deadline-threatened work *not covered by the plan* goes
        # out now, to the regions with the most configured capacity.  Work
        # the plan has slotted before the deadline is left to its slot —
        # preempting it would dump cleanly-schedulable work into whatever
        # region is idle (usually the dirtiest).  With shifting off, every
        # job routes through this path at its arrival time.
        planned_future: Dict[str, float] = {}
        for a in plan.allocations:
            # only the portion releasing in windows *after* this one — this
            # window's share was already released above and subtracted from
            # unscheduled; counting it again would understate uncovered work
            frac = max(0.0, (a.t0 + a.dur_s - max(a.t0, t + dur)) / a.dur_s)
            planned_future[a.job_id] = (planned_future.get(a.job_id, 0.0)
                                        + a.work_req * min(frac, 1.0))
        fleet_spare = sum(max(caps[r.name] - r.int_rate, 0.0)
                          for r in regions)
        for j, w in list(unscheduled.items()):
            uncovered = (w if not cfg.shifting_on
                         else w - planned_future.get(j, 0.0))
            # urgency scales with how long the uncovered work actually takes
            # to drain at half the fleet's current spare (a fixed margin
            # misses jobs whose tail is large relative to realized spare)
            drain_s = uncovered / max(0.5 * fleet_spare, 1e-6)
            urgent = (deadline[j] - (t + dur)
                      < max(cfg.emergency_margin_s, 1.5 * drain_s))
            due_now = not cfg.shifting_on and arrival_t[j] <= t
            if uncovered > 1e-9 and arrival_t[j] <= t and (urgent or due_now):
                # spread by spare (capacity minus assigned interactive), not
                # raw capacity: an interactive-saturated region contributes
                # nothing to draining an urgent queue
                spares = [(max(caps[r.name] - r.int_rate, 1e-6), r)
                          for r in regions]
                total_spare = sum(s for s, _ in spares)
                for s, r in spares:
                    share = uncovered * s / total_spare
                    release[r.name] += share
                    released_emergency[r.name] += share
                    r.enqueue(deadline[j], j, share)
                unscheduled[j] = w - uncovered

        # 5. elastic capacity follows the assigned load: this window's
        # release at its own rate, plus whatever drain rate the queued
        # backlog's deadlines actually demand (EDF feasibility: the binding
        # prefix of the deadline-sorted queue)
        for r in regions:
            defer_need = release[r.name] / dur
            cum = 0.0
            for dl, _, w in r.queue:               # queue is deadline-sorted
                cum += w
                if dl > t + 1e-9:
                    # 1.3× safety: optimizer eval windows and reconfig dead
                    # time eat realized spare, and a shortfall surfaces only
                    # at the EDF tail — exactly where deadlines live
                    defer_need = max(defer_need, 1.3 * cum / (dl - t))
            r.rescale(t, r.int_rate + defer_need, cfg)

        # 6. serve the window everywhere; drain deferrable queues EDF
        for r in regions:
            before = r.server.defer_served_total
            r.step(t, dur, r.int_rate, release[r.name] / dur,
                   cfg.net_delay_s, cfg.reconfig_cost)
            r.dequeue(r.server.defer_served_total - before, t + dur, done_t)
        t += dur

    # --- reporting ----------------------------------------------------------
    # thresholds in whole requests: jobs carry ~1e5-1e6 requests and the
    # fractional release arithmetic leaves sub-request dust
    misses = sorted(
        j.job_id for j in workload.jobs
        if unscheduled.get(j.job_id, 0.0) > 1.0
        or sum(e[2] for r in regions for e in r.queue if e[1] == j.job_id) > 1.0
        or done_t.get(j.job_id, math.inf) > j.deadline_s + 1.0)
    region_reports = {}
    all_lat: List[Tuple[float, float]] = []
    rollup = FleetRollup()
    for r in regions:
        all_lat.extend(r.server.lat_samples)
        # close the streaming telemetry window: whatever the feed still
        # holds becomes its final snapshot, carrying the region's SLA health
        r.feed.flush(t, sla_ok_frac=1.0 - r.server.sla_violation_frac)
        # fold the region's accounted totals into its registry and hand it
        # to the fleet rollup — the exporter then scrapes one merged
        # registry whose energy/carbon conserve against the regions exactly
        reg = r.registry
        reg.counter("energy_j").inc(r.acct.energy_j)
        reg.counter("carbon_g").inc(r.acct.carbon_g)
        reg.counter("requests_served").inc(r.server.served_total
                                           + r.server.defer_served_total)
        reg.labeled("requests_served", slo_class="interactive").inc(
            r.server.served_total)
        reg.labeled("requests_served", slo_class="deferrable").inc(
            r.server.defer_served_total)
        reg.counter("preemptions").inc(
            getattr(r.server, "real_preemptions", 0))
        reg.histogram("accuracy").observe(r.server.mean_accuracy)
        # per-class served-accuracy mix: measured per probe response under
        # the real backend; under the fluid model both classes sit at the
        # pool mean (no per-request variant routing happens there)
        mix_fn = getattr(r.server, "accuracy_mix", None)
        acc_mix = mix_fn() if mix_fn is not None else {}
        if not acc_mix:
            acc_mix = {"interactive": r.server.mean_accuracy,
                       "deferrable": r.server.mean_accuracy}
        for slo, acc in acc_mix.items():
            reg.labeled("accuracy", slo_class=slo).observe(acc)
        reg.gauge("wall_s").set(t)
        rollup.add(reg)
        region_reports[r.name] = RegionReport(
            name=r.name, carbon_g=r.acct.carbon_g, energy_j=r.acct.energy_j,
            served_interactive=r.server.served_total,
            served_deferrable=r.server.defer_served_total,
            accuracy=r.server.mean_accuracy,
            p95_s=r.server.weighted_p95(),
            sla_violation_frac=r.server.sla_violation_frac,
            n_invocations=len(r.controller.invocations),
            n_predictive=sum(i.predictive for i in r.controller.invocations),
            final_blocks=r.ctx.n_blocks, mean_ci=r.trace.mean(),
            released_plan=released_plan[r.name],
            released_emergency=released_emergency[r.name],
            real_p95_s=getattr(r.server, "real_p95", lambda: 0.0)(),
            real_served=getattr(r.server, "real_served", 0),
            real_energy_j=getattr(r.server, "real_energy_j", 0.0),
            real_carbon_g=getattr(r.server, "real_carbon_g", 0.0),
            real_preemptions=getattr(r.server, "real_preemptions", 0),
            real_reconfig_s=getattr(r.server, "reconfig_s_total", 0.0),
            real_reconfigs=getattr(r.server, "n_reconfigs", 0),
            accuracy_mix=acc_mix,
            feed_energy_j=r.feed.energy_j_total,
            feed_carbon_g=r.feed.carbon_g_total,
            feed_snapshots=len(r.feed.snapshots))
    rollup.conservation()
    return FleetReport(
        regions=region_reports,
        carbon_g=sum(r.acct.carbon_g for r in regions),
        served_interactive=sum(r.server.served_total for r in regions),
        served_deferrable=sum(r.server.defer_served_total for r in regions),
        accuracy=(sum(r.server.acc_weighted for r in regions)
                  / max(sum(r.server.served_total + r.server.defer_served_total
                            for r in regions), 1e-9)),
        p95_s=SIM.weighted_p95(all_lat),
        sla_target_s=regions[0].ctx.obj_cfg.l_tail_s,
        sla_violation_frac=(sum(r.server.sla_over for r in regions)
                            / max(sum(r.server.sla_windows for r in regions), 1)),
        jobs_total=len(workload.jobs), deadline_misses=misses,
        overflow_req=overflow_req,
        job_lateness_s={j.job_id: done_t.get(j.job_id, math.inf)
                        - j.deadline_s for j in workload.jobs},
        real_p95_s=SIM.weighted_p95(
            [(l, 1.0) for r in regions
             for l in getattr(r.server, "real_latencies", [])]),
        real_served=sum(getattr(r.server, "real_served", 0)
                        for r in regions),
        rollup=rollup)


def single_region_baseline(family: str, trace: CB.CarbonTrace,
                           cfg: FleetConfig = FleetConfig()) -> SIM.SimReport:
    """The strongest non-fleet comparator: one Clover cluster in one region
    carrying the same work *mix* — the deferrable volume folded into its
    arrival stream (served on arrival, no shifting, no routing).  Runs over
    the same post-warmup span of the trace as the fleet does.

    The SLA target is pinned to what the fleet's regions use (BASE p95 at
    ``target_rho``): folding the deferrable volume into ``target_rho`` would
    otherwise also *derive* the baseline's SLA at the inflated load — a
    looser bar that lets its optimizer deploy slow low-carbon configs the
    fleet's own SLA forbids, making the comparison apples-to-oranges."""
    fleet_ctx, _ = SIM.make_context(
        family, SIM.SimConfig(n_blocks=cfg.n_blocks, target_rho=cfg.target_rho,
                              lam=cfg.lam, seed=cfg.seed, sa=cfg.sa))
    simcfg = SIM.SimConfig(
        n_blocks=cfg.n_blocks, window_s=cfg.window_s,
        target_rho=cfg.target_rho * (1.0 + cfg.deferrable_frac),
        lam=cfg.lam, ci_threshold=cfg.ci_threshold, seed=cfg.seed,
        reconfig_cost=cfg.reconfig_cost,
        sla_target_s=fleet_ctx.obj_cfg.l_tail_s, sa=cfg.sa)
    if cfg.warmup_s > 0:
        trace = trace.slice(cfg.warmup_s, trace.duration_s)
    return SIM.run_trace(cfg.scheme, family, trace, simcfg)


def compare_fleet_vs_single(family: str, traces: Dict[str, CB.CarbonTrace],
                            cfg: FleetConfig = FleetConfig()
                            ) -> Dict[str, object]:
    """{fleet report} + {region → single-region CLOVER baseline}."""
    singles = {name: single_region_baseline(family, tr, cfg)
               for name, tr in traces.items()}
    fleet = run_fleet(family, traces, cfg)
    best_name = min(singles, key=lambda n: singles[n].carbon_per_req_g())
    return {"fleet": fleet, "singles": singles, "best_single": best_name}
