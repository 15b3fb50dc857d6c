"""The carbon-aware fleet on the port against the reference's, on the same
inputs: the two-class workload, the forecasters and their backtests (on
the synthetic traces and on the bundled ElectricityMaps-style CSV), the
greedy and LP shifting plans, the router (egress carbon, data-gravity
caps, overload spread), the queue rebalancer's migration costs, the fluid
``ServingBackend``, the streaming histogram and the fleet rollup, fluid
``run_fleet`` runs (every field of the report), and the real backend:
``_Region.probe_window`` and a real-backend ``run_fleet`` on the port's
engine (CPU, SMOKE ladder carried over from the reference through
``models/bridge.py``) against the reference's engine, in both KV layouts.

Everything but the real engine is numpy, scipy and the standard library on
both sides, so those floats are held to ``==``.  The real engines are held
to equal greedy token streams by request id; their wall-clock numbers
(latency, measured joules) are not compared."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import carbon as CBJ
from repro.core import config_graph as CGJ
from repro.fleet import fleet_sim as FSJ
from repro.fleet import forecast as FCJ
from repro.fleet import router as RTJ
from repro.fleet import shifting as SHJ
from repro.fleet import workload as WLJ
from repro.obs import aggregate as AGJ
from repro.obs import CarbonFeed as FeedJ
from repro.obs import MetricsRegistry as RegJ
from repro.obs import Telemetry as TelJ
from repro.obs import TraceRecorder as TraceJ
from repro.serving import backends as BKJ
from repro.train.checkpoint import _flatten
from repro_torch.core import carbon as CBT
from repro_torch.core import config_graph as CGT
from repro_torch.fleet import fleet_sim as FST
from repro_torch.fleet import forecast as FCT
from repro_torch.fleet import router as RTT
from repro_torch.fleet import shifting as SHT
from repro_torch.fleet import workload as WLT
from repro_torch.models import bridge
from repro_torch.obs import aggregate as AGT
from repro_torch.obs import CarbonFeed as FeedT
from repro_torch.obs import MetricsRegistry as RegT
from repro_torch.obs import Telemetry as TelT
from repro_torch.obs import TraceRecorder as TraceT
from repro_torch.serving import backends as BKT

REGIONS = ("CISO-March", "CISO-September", "ESO-March")
EM_FIXTURE = __file__.rsplit("/", 1)[0] + "/fixtures/electricitymaps_sample.csv"
PKGS = ((CBJ, FCJ, SHJ, RTJ, WLJ), (CBT, FCT, SHT, RTT, WLT))


def _t(x):
    return dataclasses.astuple(x)


def _same_requests(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in dataclasses.fields(rb):
            x, y = getattr(ra, f.name), getattr(rb, f.name)
            if f.name == "prompt":
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, (f.name, x, y)


# =============================================================================
# workload
# =============================================================================
def test_workload_and_request_stream_match_reference():
    wj = WLJ.make_workload(100.0, 48 * 3600.0, deferrable_frac=0.25,
                           n_jobs=8, seed=3)
    wt = WLT.make_workload(100.0, 48 * 3600.0, deferrable_frac=0.25,
                           n_jobs=8, seed=3)
    assert _t(wt) == _t(wj)
    assert wt.deferrable_work == wj.deferrable_work
    assert wt.total_work(48 * 3600.0) == wj.total_work(48 * 3600.0)
    for a, b in zip(wt.jobs, wj.jobs):
        assert a.slack_s == b.slack_s
        assert a.feasible_in(b.arrival_s, b.deadline_s)
    kw = dict(vocab_size=97, prompt_lens=(4, 6, 9), n_new=5,
              time_scale=1 / 3600.0, max_interactive=30, requests_per_job=3,
              seed=2)
    _same_requests(WLT.request_stream(wt, 48 * 3600.0, **kw),
                   WLJ.request_stream(wj, 48 * 3600.0, **kw))
    for shape in WLJ.WORKLOAD_SHAPES:
        _same_requests(
            WLT.shaped_request_stream(12, 60.0, vocab_size=50, shape=shape,
                                      deadline_slack_s=5.0, seed=4),
            WLJ.shaped_request_stream(12, 60.0, vocab_size=50, shape=shape,
                                      deadline_slack_s=5.0, seed=4))
    with pytest.raises(ValueError):
        WLT.make_workload(1.0, 3600.0, min_slack_s=7200.0)


# =============================================================================
# traces and forecasters
# =============================================================================
@pytest.mark.parametrize("region", REGIONS)
def test_trace_views_and_forecasters_match_reference(region):
    tj = CBJ.make_trace(region, hours=48.0)
    tt = CBT.make_trace(region, hours=48.0)
    hj, ht = tj.history(7000.0), tt.history(7000.0)
    np.testing.assert_array_equal(ht.times_s, hj.times_s)
    for rebase in (True, False):
        sj = tj.slice(3600.0, 9000.5, rebase=rebase)
        st = tt.slice(3600.0, 9000.5, rebase=rebase)
        np.testing.assert_array_equal(st.times_s, sj.times_s)
        np.testing.assert_array_equal(st.intensity, sj.intensity)
    assert tt.window_mean(1000.0, 20000.0) == tj.window_mean(1000.0, 20000.0)
    for name in ("persistence", "harmonic", "ensemble"):
        fj = FCJ.make_forecaster(name, tj)
        ft = FCT.make_forecaster(name, tt)
        for t in (0.0, 1800.0, 13 * 3600.0, 30 * 3600.0, 40 * 3600.0):
            for h in (0.0, 1800.0, 6 * 3600.0):
                assert ft.predict(t, h) == fj.predict(t, h), (name, t, h)
        np.testing.assert_array_equal(
            ft.predict_series(20 * 3600.0, 6 * 3600.0, 1800.0),
            fj.predict_series(20 * 3600.0, 6 * 3600.0, 1800.0))
        # the policies' ci_fn: scaled session clock, re-anchored epoch
        cj, ct = FCJ.ForecastCIFn(fj, 900.0), FCT.ForecastCIFn(ft, 900.0)
        for epoch in (3600.0, 25 * 3600.0):
            cj.set_epoch(epoch)
            ct.set_epoch(epoch)
            for now in (None, 0.5, 2.0):
                assert ct(now, 1.0) == cj(now, 1.0)
                assert ct(now) == cj(now)
        assert _t(FCT.backtest(ft, 3600.0, step_s=3600.0)) == \
            _t(FCJ.backtest(fj, 3600.0, step_s=3600.0))
    tab_j = FCJ.backtest_table(tj, horizons_s=(1800.0, 6 * 3600.0))
    tab_t = FCT.backtest_table(tt, horizons_s=(1800.0, 6 * 3600.0))
    assert {n: {h: _t(r) for h, r in d.items()} for n, d in tab_t.items()} \
        == {n: {h: _t(r) for h, r in d.items()} for n, d in tab_j.items()}


def test_csv_traces_and_backtest_csv_match_reference(tmp_path):
    tj = CBJ.load_trace_csv(EM_FIXTURE, name="em-ciso")
    tt = CBT.load_trace_csv(EM_FIXTURE, name="em-ciso")
    assert tt.name == tj.name == "em-ciso"
    np.testing.assert_array_equal(tt.times_s, tj.times_s)
    np.testing.assert_array_equal(tt.intensity, tj.intensity)
    assert len(tt.times_s) == 24
    path = tmp_path / "t.csv"
    path.write_text("when,zone,gco2eq\n10,CA,100\n0,CA,300\n20,CA,\n"
                    "30,CA,50\n")
    a = CBT.load_trace_csv(str(path), time_col="when", ci_col="gco2eq")
    b = CBJ.load_trace_csv(str(path), time_col="when", ci_col="gco2eq")
    np.testing.assert_array_equal(a.times_s, b.times_s)
    np.testing.assert_array_equal(a.intensity, b.intensity)
    with pytest.raises(KeyError):
        CBT.load_trace_csv(str(path), time_col="nope")
    tab_j = FCJ.backtest_csv(EM_FIXTURE, horizons_s=(1800.0, 3600.0))
    tab_t = FCT.backtest_csv(EM_FIXTURE, horizons_s=(1800.0, 3600.0))
    assert set(tab_t) == {"persistence", "harmonic", "ensemble"}
    assert {n: {h: _t(r) for h, r in d.items()} for n, d in tab_t.items()} \
        == {n: {h: _t(r) for h, r in d.items()} for n, d in tab_j.items()}


# =============================================================================
# shifting and routing
# =============================================================================
def _shift_case(SH, WL, seed):
    """Jobs and (region × window) slots drawn from one numpy seed."""
    rng = np.random.default_rng(seed)
    slots = [SH.Slot(reg, k * 1800.0, 1800.0, float(rng.uniform(0, 20)),
                     float(rng.uniform(60, 400)), float(rng.uniform(200, 600)))
             for k in range(12) for reg in ("a", "b", "c")]
    jobs = []
    for i in range(6):
        arr = float(rng.uniform(0, 4 * 3600.0))
        jobs.append(WL.DeferrableJob(f"j{i}", arr,
                                     float(rng.uniform(1e3, 6e4)),
                                     arr + float(rng.uniform(1800, 5 * 3600))))
    return jobs, slots


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_and_lp_shift_plans_match_reference(seed):
    for name in ("greedy", "lp"):
        plans = []
        for CB, FC, SH, RT, WL in PKGS:
            jobs, slots = _shift_case(SH, WL, seed)
            plan = SH.make_shifter(name)(jobs, slots)
            plans.append((
                [_t(a) for a in plan.allocations], plan.unplaced,
                plan.feasible, plan.placed_work,
                plan.forecast_carbon_g(slots), plan.by_slot(),
                [plan.rate(r, t) for r in "abc"
                 for t in (0.0, 4000.0, 15000.0)]))
        assert plans[1] == plans[0], name
    # a job with no feasible slot at all is reported unplaced by both
    for CB, FC, SH, RT, WL in PKGS:
        late = [WL.DeferrableJob("late", 1e6, 10.0, 1e6 + 60.0)]
        assert SH.lp_shift(late, _shift_case(SH, WL, 0)[1]).unplaced == \
            {"late": 10.0}


def _snaps(RT, egress=True, gravity=True):
    def p95(cap):
        return lambda r: 0.05 + 0.5 * (r / cap) ** 4
    return [
        RT.RegionSnapshot("clean", 100.0, 500.0, 90.0, 0.002, p95(100.0),
                          egress_gb_per_req=0.5 if egress else 0.0,
                          egress_g_per_gb=0.2 if egress else 0.0,
                          gravity_cap_rps=40.0 if gravity else math.inf),
        RT.RegionSnapshot("mid", 300.0, 500.0, 200.0, 0.004, p95(300.0),
                          egress_gb_per_req=0.5 if egress else 0.0,
                          egress_g_per_gb=0.01 if egress else 0.0),
        RT.RegionSnapshot("dirty", 1000.0, 500.0, 400.0, 0.2, p95(1000.0)),
    ]


@pytest.mark.parametrize("egress", [False, True])
@pytest.mark.parametrize("gravity", [False, True])
def test_router_decisions_match_reference(egress, gravity):
    for total in (30.0, 150.0, 600.0, 5000.0):
        for prev in (None, {"mid": 10.0}, {"dirty": 5.0}):
            out = []
            for CB, FC, SH, RT, WL in PKGS:
                snaps = _snaps(RT, egress, gravity)
                d = RT.route_interactive(total, snaps, sla_s=0.4,
                                         max_rho=0.85, prev_rates=prev)
                out.append((d.rates, d.overflow_rps,
                            [(s.carbon_g_per_req(), s.egress_g_per_req(),
                              s.effective_g_per_req()) for s in snaps],
                            [RT._sla_rate_cap(s, 0.4, 80.0)
                             for s in snaps]))
            assert out[1] == out[0], (total, prev)


class _StubServer:
    def __init__(self):
        self.defer_backlog = 0.0


class _StubRegion:
    """The rebalancer's view of a region (the reference's
    tests/test_fleet.py:193)."""

    def __init__(self, CB, name, int_rate):
        t = np.arange(0, 24 * 3600.0 + 1, 1800.0)
        self.name = name
        self.int_rate = int_rate
        self.queue = []
        self.server = _StubServer()
        self.acct = CB.CarbonAccountant(
            CB.CarbonTrace("flat", t, np.full_like(t, 300.0)))

    def enqueue(self, deadline_s, job_id, work):
        self.queue.append([deadline_s, job_id, work])
        self.queue.sort()


@pytest.mark.parametrize("overhead", [None, 60.0, 550.0])
def test_rebalance_migration_matches_reference(overhead):
    out = []
    for CB, FS in ((CBJ, FSJ), (CBT, FST)):
        src = _StubRegion(CB, "src", 95.0)
        dst = _StubRegion(CB, "dst", 0.0)
        src.queue = [[600.0, "a", 20_000.0], [3600.0, "b", 50_000.0],
                     [9 * 3600.0, "c", 10.0]]
        src.server.defer_backlog = 70_010.0
        cfg = (None if overhead is None else FS.FleetConfig(
            migrate_overhead_s=overhead, migrate_j_per_req=0.05))
        FS._rebalance_queues([src, dst], 0.0, {"src": 100.0, "dst": 100.0},
                             cfg=cfg)
        out.append((src.queue, dst.queue, src.server.defer_backlog,
                    dst.server.defer_backlog, src.acct.energy_j,
                    src.acct.carbon_g))
    assert out[1] == out[0]


# =============================================================================
# the fluid ServingBackend
# =============================================================================
def _fluid_run(pkg, selector):
    CB, WL, BK, Tel, Trace, Feed, CG, SIM = pkg
    ctx, _ = SIM.make_context("efficientnet", SIM.SimConfig(n_blocks=1))
    g = CG.ConfigGraph.from_dict("efficientnet", {("B1", 1): 8, ("B7", 8): 1})
    tel = Tel(tracer=Trace("fluid"), feed=Feed(250.0, interval_s=1e9),
              backend="fluid")
    be = BK.FluidBackend(g, ctx.variants, ctx.obj_cfg.l_tail_s,
                         trace=CB.make_trace("CISO-March", hours=2.0),
                         window_s=60.0, telemetry=tel,
                         quality_selector=selector)
    wl = WL.make_workload(1.5, 600.0, deferrable_frac=0.4, n_jobs=3,
                          min_slack_s=120.0, max_slack_s=300.0, seed=1)
    reqs = WL.request_stream(wl, 600.0, vocab_size=100, requests_per_job=4,
                             seed=5)
    for r in reqs:
        be.submit(r)
    first = be.step()
    rest = be.drain()
    resp = [(r.rid, r.slo, r.priority, r.state, r.t_arrival, r.t_finish,
             r.queue_delay_s, r.ttft_s, r.latency_s, r.energy_j, r.carbon_g,
             r.accuracy, r.variant, r.deadline_s, r.deadline_met)
            for r in rest]
    reg = be.registry
    values = {n: reg.value(n) for n in sorted(reg.names())
              if reg.get(n).kind != "histogram"}
    spans = [(s["name"], s["t0"], s["t1"], sorted(s.get("args", {}).items()))
             for s in tel.tracer.spans()]
    return (len(first), resp, be.stats(), values, spans,
            tel.feed.energy_j_total, tel.feed.carbon_g_total,
            None if be.quality_selector is None
            else be.quality_selector.decision_sequence())


@pytest.mark.parametrize("with_selector", [False, True])
def test_fluid_backend_matches_reference(with_selector):
    from repro.serving import quality as QJ
    from repro.serving import simulator as SIMJ
    from repro_torch.serving import quality as QT
    from repro_torch.serving import simulator as SIMT
    runs = []
    for pkg, Q in (((CBJ, WLJ, BKJ, TelJ, TraceJ, FeedJ, CGJ, SIMJ), QJ),
                   ((CBT, WLT, BKT, TelT, TraceT, FeedT, CGT, SIMT), QT)):
        sel = (Q.make_selector("greedy", ci_fn=lambda t: 400.0 if t < 200
                               else 80.0, dirty_threshold_g=300.0,
                               sustain_s=60.0) if with_selector else None)
        runs.append(_fluid_run(pkg, sel))
    assert runs[1] == runs[0]
    stats = runs[1][2]
    assert stats["served"] == len(runs[1][1]) > 0
    assert sum(r[9] for r in runs[1][1]) == pytest.approx(stats["energy_j"])


# =============================================================================
# streaming histogram and rollup
# =============================================================================
def _hist_state(h):
    return (h.count, h.sum, h.mean, h.spilled, h.n_buckets,
            list(h.samples), dict(h._buckets),
            [h.percentile(q) for q in (0, 1, 50, 95, 99, 100)])


@pytest.mark.parametrize("max_raw", [8, 64, 4096])
def test_streaming_histogram_is_bit_identical_to_reference(max_raw):
    rng = np.random.default_rng(max_raw)
    values = np.concatenate([rng.lognormal(-3, 2, 150), [0.0, -0.5, 1e-310],
                             -rng.exponential(2.0, 20), [1e30, 1e-30]])
    hs = [AG.StreamingHistogram("latency_s", max_raw=max_raw, alpha=0.02)
          for AG in (AGJ, AGT)]
    for h in hs:
        for v in values[:40]:
            h.observe(v)
        h.observe_many(values[40:])
    assert _hist_state(hs[1]) == _hist_state(hs[0])
    # merges: an exact histogram, a small and a spilled sketch
    for AG, Reg, h in zip((AGJ, AGT), (RegJ, RegT), hs):
        exact = Reg.standard("x").histogram("latency_s")
        for v in values[:30]:
            exact.observe(v)
        h.merge(exact)
        small = AG.StreamingHistogram("s", max_raw=10 ** 6, alpha=0.02)
        small.observe_many(values[:5])
        h.merge(small)
        big = AG.StreamingHistogram("b", max_raw=4, alpha=0.02)
        big.observe_many(values)
        h.merge(big)
    assert _hist_state(hs[1]) == _hist_state(hs[0])
    with pytest.raises(AssertionError):
        hs[1].merge(AGT.StreamingHistogram("c", alpha=0.05))
    assert AGT.LABEL_KEYS == AGJ.LABEL_KEYS


def _rollup_state(rollup):
    m = rollup.merged()
    out = []
    for name in sorted(m.names()):
        x = m.get(name)
        out.append((name, x.kind, _hist_state(x) if x.kind == "histogram"
                    else (x.value, getattr(x, "peak", None))))
    for name, labels, x in m.labeled_series():
        out.append((name, sorted(labels.items()),
                    _hist_state(x) if x.kind == "histogram"
                    else (x.value, getattr(x, "peak", None))))
    return out, rollup.conservation()


def test_fleet_rollup_matches_reference():
    states = []
    for AG, Reg in ((AGJ, RegJ), (AGT, RegT)):
        rollup = AG.FleetRollup(max_raw=16)
        rng = np.random.default_rng(0)
        for region in ("a", "b", "c"):
            reg = Reg.standard(region, labels={"region": region})
            reg.counter("energy_j").inc(float(rng.uniform(1, 1e6)))
            reg.counter("carbon_g").inc(float(rng.uniform(1, 1e3)))
            reg.gauge("wall_s").set(float(rng.uniform(1, 100)))
            for v in rng.exponential(0.1, 12):
                reg.histogram("latency_s").observe(float(v))
                reg.labeled("latency_s", slo_class="interactive").observe(
                    float(v))
            reg.labeled("requests_served", slo_class="deferrable").inc(3.0)
            rollup.add(reg)
        with pytest.raises(AssertionError, match="duplicate"):
            rollup.add(reg)
        states.append(_rollup_state(rollup))
    assert states[1] == states[0]


# =============================================================================
# fluid run_fleet
# =============================================================================
FLUID_CFGS = {
    # the reference's tests/test_fleet.py:409 and :425
    "smoke": dict(warmup_s=24 * 3600.0, n_jobs=4, min_slack_s=2 * 3600.0,
                  max_slack_s=4 * 3600.0, plan_horizon_s=6 * 3600.0),
    "suspend": dict(warmup_s=24 * 3600.0, n_jobs=2, min_slack_s=2 * 3600.0,
                    max_slack_s=4 * 3600.0, plan_horizon_s=6 * 3600.0),
    # egress carbon, a data-gravity cap on the cleanest region, migration
    # costs and the LP shifter
    "costs": dict(warmup_s=24 * 3600.0, n_jobs=4, min_slack_s=2 * 3600.0,
                  max_slack_s=4 * 3600.0, plan_horizon_s=6 * 3600.0,
                  payload_gb_per_req=0.5,
                  egress_g_per_gb={"CISO-March": 0.2, "ESO-March": 0.05},
                  gravity_caps={"ESO-March": 150.0}, migrate_overhead_s=300.0,
                  migrate_j_per_req=0.05, shifter="lp"),
    # the ablations, a harmonic forecaster and no elasticity
    "ablated": dict(warmup_s=24 * 3600.0, n_jobs=3, min_slack_s=2 * 3600.0,
                    max_slack_s=4 * 3600.0, plan_horizon_s=6 * 3600.0,
                    routing_on=False, predictive_on=False, elastic=False,
                    forecaster="harmonic", scheme="BLOVER"),
}


def _same_fleet_report(got, want, skip=()):
    for f in dataclasses.fields(want):
        if f.name in skip:
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "regions":
            assert list(a) == list(b)
            for name in b:
                for g in dataclasses.fields(b[name]):
                    if g.name in skip:
                        continue
                    assert getattr(a[name], g.name) == \
                        getattr(b[name], g.name), (name, g.name)
        elif f.name == "rollup":
            assert _rollup_state(a) == _rollup_state(b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", sorted(FLUID_CFGS))
def test_fluid_run_fleet_matches_reference(case):
    reps = []
    for CB, FS in ((CBJ, FSJ), (CBT, FST)):
        traces = {r: CB.make_trace(r, hours=30.0, seed=7) for r in REGIONS}
        reps.append(FS.run_fleet("efficientnet", traces,
                                 FS.FleetConfig(**FLUID_CFGS[case])))
    _same_fleet_report(reps[1], reps[0])
    rep = reps[1]
    assert rep.served_interactive > 0 and rep.served_deferrable > 0
    assert not rep.deadline_misses
    assert rep.carbon_per_req_g() == reps[0].carbon_per_req_g()
    totals = rep.rollup.conservation()
    assert totals["energy_j"] == sum(r.energy_j
                                     for r in rep.regions.values())


def test_single_region_baseline_and_comparison_match_reference():
    cfg = dict(warmup_s=24 * 3600.0, n_jobs=2, min_slack_s=2 * 3600.0,
               max_slack_s=4 * 3600.0, plan_horizon_s=6 * 3600.0)
    outs = []
    for CB, FS in ((CBJ, FSJ), (CBT, FST)):
        traces = {r: CB.make_trace(r, hours=30.0, seed=7)
                  for r in REGIONS[:2]}
        outs.append(FS.compare_fleet_vs_single("efficientnet", traces,
                                               FS.FleetConfig(**cfg)))
    assert outs[1]["best_single"] == outs[0]["best_single"]
    for name in REGIONS[:2]:
        a, b = outs[1]["singles"][name], outs[0]["singles"][name]
        for f in dataclasses.fields(b):
            if f.name != "timeline":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
    _same_fleet_report(outs[1]["fleet"], outs[0]["fleet"])


# =============================================================================
# the real backend on the port's engine (CPU)
# =============================================================================
@pytest.fixture(scope="module")
def families():
    """The reference's fleet ladder (SMOKE widths, 2 layers, f32, x0.25 /
    x0.5 / x1) and the port's with the same weights, on the CPU."""
    fam_j = BKJ.build_real_family("qwen3-1.7b", 2, seed=0)
    fam_t = BKT.build_real_family("qwen3-1.7b", 2, seed=0, device="cpu")
    for ev_j, ev_t in zip(fam_j, fam_t):
        assert _t(ev_j.variant)[:2] == _t(ev_t.variant)[:2]
        assert ev_j.cfg.dtype == jnp.float32
        bridge.load_reference(ev_t.params, _flatten(ev_j.params))
    return fam_j, fam_t


def _regions(families, **kw):
    """A reference and a port ``_Region`` of one FleetConfig over one
    trace, each on its package's engine."""
    out = []
    for CB, FS, fam in ((CBJ, FSJ, families[0]), (CBT, FST, families[1])):
        cfg = FS.FleetConfig(backend="real", **kw)
        out.append(FS._Region("r0", CB.make_trace("CISO-March", hours=2.0),
                              fam[0].variant.family, cfg,
                              engine_family=fam))
    return out


WINDOWS = (({("x1", 16): 1}, 0.0),
           ({("x0.25", 4): 2, ("x1", 8): 1}, 600.0),
           ({("x0.5", 8): 2}, 1200.0),
           ({}, 1800.0),                          # suspended: no probe
           ({("x0.25", 4): 2, ("x1", 8): 1}, 2400.0))


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_region_probe_window_streams_match_reference(families, layout):
    regions = _regions(families, engine_kv_layout=layout, probe_requests=5,
                       probe_prompt_len=7, probe_new_tokens=5)
    for CG, r in zip((CGJ, CGT), regions):
        assert r.server.engine.kv_layout == layout
        r.streams, r.stats = [], []
        for spec, t in WINDOWS:
            m = r.server.probe_window(CG.ConfigGraph.from_dict(
                r.ctx.family, spec), t)
            if m is None:
                r.stats.append(None)
                continue
            r.streams.append({rid: list(map(int, toks)) for rid, toks in
                              r.server.engine.last_outputs.items()})
            r.stats.append((m["served"], m["tokens"]))
    ref, port = regions
    assert port.streams == ref.streams and len(port.streams) == 4
    assert port.stats == ref.stats
    assert port.stats[3] is None
    for name in ("real_served", "real_tokens", "n_reconfigs", "real_acc_n",
                 "real_acc_sum", "_rid"):
        assert getattr(port.server, name) == getattr(ref.server, name), name
    assert port.server.real_served == 4 * 5
    assert port.server.real_energy_j > 0 and port.server.real_carbon_g > 0
    assert port.server.real_p95() > 0
    assert port.server.accuracy_mix() == ref.server.accuracy_mix()


def test_region_plumbs_layout_policy_and_selector(families):
    """The reference's tests/test_fleet.py:257 and :308 on the port: the
    region's engine takes the configured KV layout, a ``carbon_forecast``
    policy over the REGION's forecaster with the probe deadline mapped onto
    the trace horizon, and a greedy selector on the same nowcast; a mixed
    probe batch runs through the hold/release path."""
    from repro_torch.core import config_graph as CG
    from repro_torch.serving.policies import CarbonForecastPolicy
    from repro_torch.serving.quality import GreedyDownshiftSelector
    _, region = _regions(families, engine_kv_layout="paged",
                         engine_policy="carbon_forecast",
                         engine_policy_horizon_s=1800.0,
                         engine_ci_threshold_g=250.0,
                         engine_quality_selector="greedy",
                         probe_deferrable_frac=0.5, probe_deadline_s=1.0)
    eng = region.server.engine
    assert eng.kv_layout == "paged" and eng.device.type == "cpu"
    pol = eng.policy
    assert isinstance(pol, CarbonForecastPolicy)
    assert pol.ci_threshold == 250.0 and pol.horizon_s == 1.0
    assert pol.ci_fn.time_scale == pytest.approx(1800.0)
    assert pol.deadline_margin_s == pytest.approx(0.5)
    assert pol.ci_fn.forecaster is region.forecaster
    assert region.server.ci_fn is pol.ci_fn
    assert isinstance(eng.quality_selector, GreedyDownshiftSelector)
    assert eng.quality_selector.ci_fn is pol.ci_fn
    g = CG.ConfigGraph.from_dict(region.ctx.family,
                                 {("x0.5", 8): 1, ("x1", 8): 1})
    m = region.server.probe_window(g, 1800.0)
    assert m is not None and m["served"] == 4
    assert pol.ci_fn.t0 == 1800.0
    slos = [r.slo for r in eng.last_responses]
    assert slos.count("deferrable") == 2
    assert region.server.real_carbon_g > 0.0


def test_engine_topology_asserts_paged_then_engine_refuses(families):
    """A region in ``engine_topology`` needs the paged layout, and then
    gets a disaggregated engine with the map's worker counts."""
    from repro_torch.serving.disagg import DisaggEngine
    with pytest.raises(AssertionError, match="paged"):
        _regions(families[:1] * 2, engine_kv_layout="slotted",
                 engine_topology={"r0": (1, 1)})
    cfg = FST.FleetConfig(backend="real", engine_kv_layout="paged",
                          engine_topology={"r0": (2, 1)})
    split = FST._Region("r0", CBT.make_trace("CISO-March", hours=2.0),
                        families[1][0].variant.family, cfg,
                        engine_family=families[1])
    assert isinstance(split.server.engine, DisaggEngine)
    assert split.server.engine.roles == {"prefill": 2, "decode": 1}
    # a region not in the map stays monolithic
    other = FST._Region("r1", CBT.make_trace("CISO-March", hours=2.0),
                        families[1][0].variant.family, cfg,
                        engine_family=families[1])
    assert other.server.engine.kv_layout == "paged"


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_real_backend_run_fleet_matches_reference(families, layout,
                                                  monkeypatch):
    """A one-region, one-hour real-backend fleet (the reference's defaults:
    SMOKE ladder, fifo) through each package's ``run_fleet``: the same
    configurations applied in the same order, the same per-rid token
    streams every window, and every fluid field of the report equal; only
    the wall-clock readings (real p95, measured joules, reconfiguration
    seconds) differ."""
    monkeypatch.setattr(BKJ, "build_real_family",
                        lambda *a, **k: families[0])
    logs = []
    for BK in (BKJ, BKT):
        log = {"configs": [], "streams": []}
        apply, probe = BK.RealWindowServer.apply_config, \
            BK.RealWindowServer.probe_window

        def apply_logged(self, g, apply=apply, log=log):
            if self._configured_edges != g.edges:
                log["configs"].append(g.edges)
            return apply(self, g)

        def probe_logged(self, g, t=0.0, probe=probe, log=log):
            m = probe(self, g, t)
            if m is not None:
                log["streams"].append(
                    {rid: list(map(int, v)) for rid, v in
                     self.engine.last_outputs.items()})
            return m
        monkeypatch.setattr(BK.RealWindowServer, "apply_config",
                            apply_logged)
        monkeypatch.setattr(BK.RealWindowServer, "probe_window",
                            probe_logged)
        logs.append(log)
    reps = []
    for CB, FS, kw in ((CBJ, FSJ, {}),
                       (CBT, FST, {"engine_family": families[1]})):
        cfg = FS.FleetConfig(n_blocks=1, window_s=600.0, backend="real",
                             deferrable_frac=0.1, n_jobs=2,
                             min_slack_s=1800.0, max_slack_s=3600.0,
                             engine_kv_layout=layout)
        reps.append(FS.run_fleet(
            "efficientnet", {"CISO-March": CB.make_trace("CISO-March",
                                                         hours=1.0, seed=3)},
            cfg, **kw))
    assert logs[1] == logs[0]
    assert len(logs[1]["configs"]) >= 2 and len(logs[1]["streams"]) >= 1
    wall = ("real_p95_s", "real_energy_j", "real_carbon_g", "real_reconfig_s",
            "rollup")
    _same_fleet_report(reps[1], reps[0], skip=wall)
    rep = reps[1]
    region = rep.regions["CISO-March"]
    assert rep.real_served == region.real_served == \
        4 * len(logs[1]["streams"])
    assert region.real_energy_j > 0 and rep.real_p95_s > 0
    assert rep.deadlines_met
    assert rep.rollup.conservation()["energy_j"] == region.energy_j
