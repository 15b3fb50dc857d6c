"""The rest of the observability plane on the port against the reference's,
on the same inputs, float for float (``==``): the discrete-event backend
(``serving/queue.py``: ``DESBackend`` and ``run_des``), the OpenMetrics
exposition and its parser and the snapshot writer (``obs/export.py``), the
burn-rate alerts (``obs/slo.py``) and the controller's forced
re-optimisation on a firing alert, and the validation CLI
(``obs/validate.py``), which also runs as ``python -m
repro_torch.obs.validate`` with no ``jax`` or ``repro`` module loaded.

The cases are the reference's: ``tests/test_api.py:141``, ``:192``,
``:206`` and ``:335``; ``tests/test_obs_plane.py:193-366``; and
``tests/test_obs.py:218`` and ``:257``.  Each runs on both packages and
holds the port's results to the reference's exactly."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import catalog as CATJ
from repro.core import config_graph as CGJ
from repro.core import controller as CTRLJ
from repro.core import perf_model as PMJ
from repro.core import schemes as SCHJ
from repro.fleet import workload as WLJ
from repro.obs import CarbonFeed as FeedJ
from repro.obs import MetricsRegistry as RegJ
from repro.obs import Telemetry as TelJ
from repro.obs import TraceRecorder as TraceJ
from repro.obs import export as EXJ
from repro.obs import slo as SLOJ
from repro.obs import validate as VJ
from repro.serving import api as APIJ
from repro.serving import backends as BKJ
from repro.serving import policies as POLJ
from repro.serving import queue as QJ
from repro.serving import simulator as SIMJ
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import catalog as CATT
from repro_torch.core import config_graph as CGT
from repro_torch.core import controller as CTRLT
from repro_torch.core import perf_model as PMT
from repro_torch.core import schemes as SCHT
from repro_torch.fleet import workload as WLT
from repro_torch.obs import CATALOG, CarbonFeed as FeedT
from repro_torch.obs import MetricsRegistry as RegT
from repro_torch.obs import Telemetry as TelT
from repro_torch.obs import TraceRecorder as TraceT
from repro_torch.obs import export as EXT
from repro_torch.obs import slo as SLOT
from repro_torch.obs import validate as VT
from repro_torch.obs import validate_trace
from repro_torch.serving import api as APIT
from repro_torch.serving import backends as BKT
from repro_torch.serving import engine as ENG
from repro_torch.serving import policies as POLT
from repro_torch.serving import queue as QT
from repro_torch.serving import simulator as SIMT

ROOT = Path(__file__).resolve().parents[1]
REF = dict(CAT=CATJ, CG=CGJ, CTRL=CTRLJ, PM=PMJ, SCH=SCHJ, WL=WLJ,
           Feed=FeedJ, Reg=RegJ, Tel=TelJ, Trace=TraceJ, EX=EXJ, SLO=SLOJ,
           V=VJ, API=APIJ, BK=BKJ, POL=POLJ, Q=QJ, SIM=SIMJ)
PORT = dict(CAT=CATT, CG=CGT, CTRL=CTRLT, PM=PMT, SCH=SCHT, WL=WLT,
            Feed=FeedT, Reg=RegT, Tel=TelT, Trace=TraceT, EX=EXT, SLO=SLOT,
            V=VT, API=APIT, BK=BKT, POL=POLT, Q=QT, SIM=SIMT)
POLICY = dict(short_s=60.0, long_s=300.0, fire_burn=2.0, clear_burn=1.0)


def _both(fn):
    """``fn`` run once on the reference's modules and once on the port's:
    (reference result, port result)."""
    return fn(**REF), fn(**PORT)


def _des_graph(CG, **_):
    # ONE instance: policy orderings are only observable when service
    # serializes
    return CG.ConfigGraph.from_dict("efficientnet", {("B3", 1): 1})


def _same_responses(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, (a.rid, f.name, x, y)


def _same_registry(want, got):
    """Equal expositions: every family, label and value (``repr`` of each
    float) is the reference's."""
    assert EXT.to_openmetrics(got) == EXJ.to_openmetrics(want)


def _des(Q, CG, CAT, jitter=0.0, **kw):
    return Q.DESBackend(_des_graph(CG), CAT.get_family("efficientnet"),
                        Q.DESConfig(jitter_sigma=jitter), **kw)


# =============================================================================
# the DES backend (the reference's tests/test_api.py:141, :192, :206, :335)
# =============================================================================
def test_des_and_engines_run_one_workload_through_the_protocol():
    """One workload through the port's DES (equal to the reference's, field
    for field) and the port's slotted and paged engines (equal streams)."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, size=L).astype(np.int32)
               for L in (4, 10, 24, 4)]

    def run(Q, CG, CAT, API, **_):
        des = _des(Q, CG, CAT, ci_g_per_kwh=300.0)
        assert isinstance(des, API.ServingBackend)
        reqs = [API.InferenceRequest(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        out = API.serve_workload(des, reqs)
        assert all(r.tokens is None for r in out)
        return out, des.stats(), des.registry, API.summarize_responses(out)
    (rj, mj, gj, sj), (rt, mt, gt, st) = _both(run)
    _same_responses(rj, rt)
    assert mt == mj and st == sj and st["carbon_g"] > 0
    _same_registry(gj, gt)
    family = ENG.build_engine_family(qwen3_1_7b.SMOKE.with_(n_layers=2),
                                     fracs=(1.0,), device="cpu")
    graph = CGT.ConfigGraph.from_dict("qwen3-1.7b", {("x1", 16): 1})
    outs = []
    for kw in ({}, {"kv_layout": "paged", "block_size": 8}):
        eng = ENG.RealEngine(family, n_slots=2, max_len=48, device="cpu",
                             **kw)
        eng.configure(graph)
        assert isinstance(eng, APIT.ServingBackend)
        APIT.serve_workload(eng, [
            APIT.InferenceRequest(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)])
        assert eng.stats()["served"] == len(prompts)
        outs.append(eng.last_outputs)
    for rid in range(len(prompts)):
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


@pytest.mark.parametrize("pol", ["fifo", "edf"])
def test_des_edf_meets_deadline_fifo_misses(pol):
    def run(Q, CG, CAT, API, PM, **_):
        svc = PM.cached_point(CAT.get_family("efficientnet")[1],
                              _des_graph(CG).edges[0][0][1]).latency_s
        des = _des(Q, CG, CAT, policy=pol)
        reqs = [API.InferenceRequest(rid=i, prompt=[1], max_new_tokens=8,
                                     arrival_s=0.0, deadline_s=d * svc,
                                     slo=API.DEFERRABLE)
                for i, d in enumerate((10.0, 10.0, 2.5))]
        out = API.serve_workload(des, reqs)
        return out, des.stats()
    (rj, mj), (rt, mt) = _both(run)
    _same_responses(rj, rt)
    assert mt == mj and mt["served"] == 3
    misses = sum(not r.deadline_met for r in rt)
    assert misses == (1 if pol == "fifo" else 0)


def test_des_carbon_policy_holds_deferrable_until_grid_cleans():
    def run(Q, CG, CAT, API, POL, **_):
        pol = POL.CarbonAwarePolicy(
            lambda now: 500.0 if (now or 0) < 120.0 else 50.0,
            ci_threshold=200.0)
        des = _des(Q, CG, CAT, policy=pol, hold_retry_s=30.0)
        reqs = [API.InferenceRequest(rid=0, prompt=[1], arrival_s=0.0,
                                     slo=API.DEFERRABLE,
                                     deadline_s=10_000.0),
                API.InferenceRequest(rid=1, prompt=[1], arrival_s=1.0,
                                     slo=API.INTERACTIVE)]
        return API.serve_workload(des, reqs), des.stats()
    (rj, mj), (rt, mt) = _both(run)
    _same_responses(rj, rt)
    assert mt == mj
    by_rid = {r.rid: r for r in rt}
    assert by_rid[1].t_finish < 120.0
    assert by_rid[0].t_finish >= 120.0 and by_rid[0].deadline_met


@pytest.mark.parametrize("ci", [350.0, "trace"])
def test_des_attribution_sums_to_total(ci):
    """Jittered service (stdlib ``random`` with the reference's seed) at a
    constant and at a time-varying grid: equal responses, stats and
    registry, and per-request joules and grams that sum to the totals."""
    ci_fn = 350.0 if ci != "trace" else (lambda t: 200.0 + 50.0 * (t > 2.0))

    def run(Q, CG, CAT, API, **_):
        des = _des(Q, CG, CAT, jitter=0.05, ci_g_per_kwh=ci_fn)
        rng = np.random.default_rng(0)
        reqs = [API.InferenceRequest(rid=i, prompt=[1], max_new_tokens=8,
                                     arrival_s=float(a))
                for i, a in enumerate(np.sort(rng.uniform(0, 5.0, size=12)))]
        return API.serve_workload(des, reqs), des.stats(), des.registry
    (rj, mj, gj), (rt, mt, gt) = _both(run)
    _same_responses(rj, rt)
    assert mt == mj
    _same_registry(gj, gt)
    assert sum(r.energy_j for r in rt) == pytest.approx(mt["energy_j"],
                                                        rel=1e-9)
    assert sum(r.carbon_g for r in rt) == pytest.approx(mt["carbon_g"],
                                                        rel=1e-9)


@pytest.mark.parametrize("case", [
    {},
    {"straggler_prob": 0.1, "hedge": True},
    {"fail_rate_per_instance_hz": 0.05, "repair_time_s": 5.0, "seed": 4}])
def test_run_des_matches_reference(case):
    """The closed-form rate-driven simulation, with stragglers and hedged
    requests, and with instances failing and repairing: every latency and
    counter of the result equals the reference's."""
    def run(Q, CG, CAT, **_):
        g = CG.ConfigGraph.from_dict("efficientnet",
                                     {("B1", 2): 1, ("B3", 2): 2})
        return Q.run_des(g, CAT.get_family("efficientnet"), 40.0, 60.0,
                         des=Q.DESConfig(**case))
    rj, rt = _both(run)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    assert rt.p50() == rj.p50() and rt.p99() == rj.p99()
    assert rt.mean_accuracy() == rj.mean_accuracy() and rt.latencies


# =============================================================================
# OpenMetrics exposition (tests/test_obs_plane.py:193-244)
# =============================================================================
def test_openmetrics_round_trip_matches_reference():
    def run(Reg, EX, **_):
        reg = Reg.standard("r", labels={"region": "east"})
        odd = 0.1 + 0.2
        reg.counter("energy_j").inc(odd)
        reg.gauge("blocks_in_use").set(7.0)
        reg.histogram("latency_s").observe(odd)
        reg.labeled("latency_s", slo_class="interactive").observe(1.5)
        text = EX.to_openmetrics(reg)
        fams = EX.parse_openmetrics(text)
        assert EX.render_families(fams) == text
        for bad in ("no_help_line 1.0\n# EOF\n",
                    "# HELP x y\n# TYPE x counter\nx 1.0\n"):
            with pytest.raises(AssertionError):
                EX.parse_openmetrics(bad)
        return text, fams
    (tj, fj), (tt, ft) = _both(run)
    assert tt == tj and ft == fj
    assert tt.endswith("# EOF\n")
    e = [v for n, _, v in ft["repro_energy_j"]["samples"]
         if n == "repro_energy_j_total"]
    assert [float(v) for v in e] == [0.1 + 0.2]
    assert "repro_blocks_in_use_peak" in ft


def test_exporter_family_parity_des_vs_fluid():
    def run(Q, CG, CAT, API, BK, WL, EX, **_):
        def workload():
            return WL.shaped_request_stream(
                6, 0.5, vocab_size=64, shape="peak", prompt_lens=(4, 8),
                n_new=4, seed=9)
        des = _des(Q, CG, CAT, ci_g_per_kwh=300.0)
        API.serve_workload(des, workload())
        fluid = BK.FluidBackend(_des_graph(CG), CAT.get_family("efficientnet"),
                                sla_target_s=2.0, window_s=0.25,
                                ci_g_per_kwh=300.0)
        API.serve_workload(fluid, workload())
        return des.registry, fluid.registry
    (dj, fj), (dt, ft) = _both(run)
    _same_registry(dj, dt)
    _same_registry(fj, ft)
    sets = [frozenset(EXT.parse_openmetrics(EXT.to_openmetrics(r)))
            for r in (dt, ft)]
    assert sets[0] == sets[1]


def test_snapshot_writer_matches_reference(tmp_path):
    def run(Reg, EX, **kw):
        reg = Reg.standard("r")
        reg.counter("requests_served").inc(1)
        path = tmp_path / f"snap-{kw['Q'].__name__}.jsonl"
        w = EX.SnapshotWriter(str(path), interval_s=60.0)
        gates = [w.maybe_write(t, reg) for t in (0.0, 30.0, 59.9, 60.0)]
        w.write(70.0, reg)
        return gates, w.writes, path.read_text()
    (gj, nj, tj), (gt, nt, tt) = _both(run)
    assert (gt, nt, tt) == (gj, nj, tj)
    assert gt == [True, False, False, True] and nt == 3
    assert [json.loads(x)["t"] for x in tt.splitlines()] == [0.0, 60.0, 70.0]


# =============================================================================
# burn-rate alerts (tests/test_obs_plane.py:250-334)
# =============================================================================
def _transitions(ev):
    return {name: (st.transitions, st.fire_count, st.firing, st.t_fired,
                   st.t_cleared) for name, st in ev.states.items()}


def test_latency_burn_rate_fire_and_clear_ticks():
    def run(SLO, API, **_):
        ev = SLO.SLOEvaluator([SLO.LatencyObjective("ttft", threshold_s=0.5,
                                                    target=0.9)],
                              SLO.BurnRatePolicy(**POLICY))
        burns = []
        for t in range(1, 501):
            bad = 101 <= t <= 160
            ev.record_request(float(t), API.INTERACTIVE,
                              ttft_s=1.0 if bad else 0.1)
            if t % 10 == 0:
                burns.append([dataclasses.astuple(s)
                              for s in ev.evaluate(float(t))])
        return _transitions(ev), burns, ev.total_fires
    want, got = _both(run)
    assert got == want
    assert got[0]["ttft"][0] == [(130.0, "fire"), (440.0, "clear")]


def test_carbon_burn_rate_fire_and_clear_ticks():
    def run(SLO, **_):
        ev = SLO.SLOEvaluator([SLO.CarbonBudget("cb", budget_g=60.0,
                                                window_s=3600.0)],
                              SLO.BurnRatePolicy(**POLICY))
        for t in range(1, 401):
            if t <= 100:
                ev.record_carbon(float(t), 0.125)
            if t % 10 == 0:
                ev.evaluate(float(t))
        return _transitions(ev)
    want, got = _both(run)
    assert got == want
    assert got["cb"][0] == [(80.0, "fire"), (370.0, "clear")]


def test_evaluator_memory_is_bounded_by_the_long_window():
    def run(SLO, API, **_):
        ev = SLO.SLOEvaluator(SLO.default_rules(),
                              SLO.BurnRatePolicy(**POLICY))
        for t in range(20_000):
            ev.record_request(float(t), API.INTERACTIVE, ttft_s=0.1,
                              latency_s=1.0)
            ev.record_carbon(float(t), 1e-6)
            if t % 1000 == 0:
                ev.evaluate(float(t))
        ev.evaluate(19_999.0)
        return ({k: list(dq) for k, dq in ev._lat.items()}, list(ev._carbon),
                _transitions(ev))
    want, got = _both(run)
    assert got == want
    assert all(len(dq) <= POLICY["long_s"] + 1 for dq in got[0].values())
    assert len(got[1]) <= POLICY["long_s"] + 1


def test_evaluator_rule_validation():
    for SLO in (SLOJ, SLOT):
        with pytest.raises(AssertionError):
            SLO.SLOEvaluator([SLO.CarbonBudget("x", 1.0),
                              SLO.CarbonBudget("x", 2.0)])
        with pytest.raises(AssertionError):
            SLO.LatencyObjective("y", threshold_s=1.0, metric="p99_s")
        with pytest.raises(AssertionError):
            SLO.BurnRatePolicy(short_s=600.0, long_s=60.0)
    assert [dataclasses.astuple(r) for r in SLOT.default_rules()] == \
        [dataclasses.astuple(r) for r in SLOJ.default_rules()]
    assert [r.name for r in SLOT.default_rules()] == \
        ["interactive-ttft", "deferrable-latency", "hourly-carbon"]


# =============================================================================
# controller: a firing alert forces re-optimisation (test_obs_plane.py:338)
# =============================================================================
def test_controller_consumes_burn_alert_as_forced_reopt():
    def run(CTRL, SCH, SIM, SLO, API, **_):
        ctx, _ = SIM.make_context("efficientnet", SIM.SimConfig(n_blocks=1))
        c = CTRL.Controller(SCH.make_scheme("CLOVER"), ctx)
        c.start(0.0, 300.0)
        quiet = c.maybe_reoptimize(600.0, 300.0)[1] is None
        n0 = len(c.invocations)
        ev = SLO.SLOEvaluator([SLO.LatencyObjective("ttft", threshold_s=0.5,
                                                    target=0.9)],
                              SLO.BurnRatePolicy(**POLICY))
        for ts in range(1150, 1200):
            ev.record_request(float(ts), API.INTERACTIVE, ttft_s=1.0)
        c.alerts = ev
        _, outcome = c.maybe_reoptimize(1200.0, 300.0)
        forced = outcome is not None
        again = c.maybe_reoptimize(1210.0, 300.0)[1] is None
        return (quiet, n0, forced, again, ev.states["ttft"].t_fired,
                [(i.t_s, i.ci, i.predictive, i.alert, i.config.edges)
                 for i in c.invocations],
                [dataclasses.astuple(s) for s in c.last_alerts])
    want, got = _both(run)
    assert got == want
    quiet, n0, forced, again, t_fired, invs, alerts = got
    assert quiet and forced and again and t_fired == 1200.0
    assert len(invs) == n0 + 1 and invs[-1][3] and not invs[-1][2]
    assert alerts[0][0][0] == "ttft" and alerts[0][1]      # still firing


# =============================================================================
# DES holds + trace (tests/test_obs.py:218) and the CLI (:257)
# =============================================================================
def test_des_holds_carry_reason_and_trace_conserves():
    def run(Q, CG, CAT, API, POL, Tel, Trace, Feed, **_):
        pol = POL.CarbonAwarePolicy(
            lambda now: 500.0 if (now or 0) < 90.0 else 50.0,
            ci_threshold=200.0, est_service_s=1.0)
        tel = Tel(tracer=Trace("des"),
                  feed=Feed(300.0, interval_s=1e9, region="des"),
                  backend="des")
        des = _des(Q, CG, CAT, policy=pol, ci_g_per_kwh=300.0,
                   hold_retry_s=10.0, telemetry=tel)
        reqs = [API.InferenceRequest(rid=0, prompt=[1], arrival_s=0.0,
                                     slo=API.DEFERRABLE, deadline_s=10_000.0),
                API.InferenceRequest(rid=1, prompt=[1], arrival_s=1.0,
                                     slo=API.INTERACTIVE),
                API.InferenceRequest(rid=2, prompt=[1], arrival_s=2.0,
                                     slo=API.DEFERRABLE, deadline_s=10_000.0)]
        out = API.serve_workload(des, reqs)
        m = des.stats()
        tel.feed.flush(m["wall_s"])
        return out, m, des.registry, tel.tracer.records, \
            tel.feed.energy_j_total
    (rj, mj, gj, trj, ej), (rt, mt, gt, trt, et) = _both(run)
    _same_responses(rj, rt)
    assert mt == mj and trt == trj and et == ej
    _same_registry(gj, gt)
    by_rid = {r.rid: r for r in rt}
    for rid in (0, 2):
        assert by_rid[rid].release_reason == "threshold"
        assert 0.0 < by_rid[rid].held_s <= by_rid[rid].queue_delay_s + 1e-9
    assert by_rid[1].release_reason is None and by_rid[1].held_s == 0.0
    assert gt.names() == set(CATALOG)
    tracer = TraceT("des")
    tracer.records = trt
    validate_trace(tracer, expect_energy_j=mt["energy_j"], expect_requests=3)


def test_validate_main_matches_reference(capsys):
    """Both CLIs' ``main`` pass all ten checks and print the same line
    (served, spans, events, holds, joules, families, rollup, downshifts)."""
    assert VJ.main() == 0
    want = capsys.readouterr().out
    assert VT.main() == 0
    assert capsys.readouterr().out == want
    assert "disagg role-split conservation enforced" in want


def test_validate_cli_runs_without_jax_or_reference():
    """``python -m repro_torch.obs.validate`` exits 0, and no ``jax`` or
    ``repro`` module is imported while it runs (``-X importtime`` lists
    every import)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.obs.validate"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "obs.validate OK" in out.stdout
    names = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines()
             if ln.startswith("import time:")]
    assert "repro_torch.serving.queue" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "repro")]
    assert not bad, bad


@pytest.mark.parametrize("stats", [
    {"energy_j": 10.0, "prefill_energy_j": 6.0, "decode_energy_j": 3.5,
     "handoff_energy_j": 0.5, "both_energy_j": 0.0},
    {"energy_j": 0.1 + 0.2 + 0.3, "prefill_energy_j": 0.1,
     "decode_energy_j": 0.2, "handoff_energy_j": 0.3},
    {"energy_j": 1514.25, "both_energy_j": 1514.25},
    {"energy_j": 10.0, "prefill_energy_j": 6.0},
    {"energy_j": 0.0}])
def test_check_disagg_conservation_matches_reference(stats):
    """The same total on every conserving split, and the same refusal of a
    split that loses joules."""
    assert VT.ROLE_ENERGY_KEYS == VJ.ROLE_ENERGY_KEYS
    try:
        want = VJ.check_disagg_conservation(stats)
    except AssertionError:
        with pytest.raises(AssertionError, match="conserve"):
            VT.check_disagg_conservation(stats)
        return
    assert VT.check_disagg_conservation(stats) == want
