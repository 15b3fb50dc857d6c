"""Clover's trace simulator and control plane on the port against the
reference's, on the same inputs: the slice catalog, the variant catalogs,
the analytic performance model, the configuration graph's algebra, the
objective's service model, the five schemes, the controller (re-invocation
threshold, elastic scaling, the predictive trigger), the fluid server,
``run_trace`` for every scheme on three families, and ``--mode sim``.

All of it is numpy and the standard library on both sides, so every float
is held to ``==`` (arrays to ``assert_array_equal``): no tolerance."""
import contextlib
import dataclasses
import io
import json
import random

import numpy as np
import pytest

from repro.core import carbon as CBJ
from repro.core import catalog as CATJ
from repro.core import config_graph as CGJ
from repro.core import controller as CTRLJ
from repro.core import objective as OBJJ
from repro.core import perf_model as PMJ
from repro.core import schemes as SCHJ
from repro.core import slices as SLJ
from repro.launch import serve as SERVEJ
from repro.serving import simulator as SIMJ
from repro_torch.core import carbon as CBT
from repro_torch.core import catalog as CATT
from repro_torch.core import config_graph as CGT
from repro_torch.core import controller as CTRLT
from repro_torch.core import objective as OBJT
from repro_torch.core import perf_model as PMT
from repro_torch.core import schemes as SCHT
from repro_torch.core import slices as SLT
from repro_torch.launch import serve as SERVET
from repro_torch.serving import simulator as SIMT

SCHEMES = ("BASE", "CO2OPT", "BLOVER", "CLOVER", "ORACLE")
FAMILIES = ("efficientnet", "albert", "qwen3-1.7b")


def _astuple(x):
    return dataclasses.astuple(x)


def _same_report(got, want):
    """Every field of two ``SimReport``s equal, the timeline array by
    array."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "timeline":
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a == b, (f.name, a, b)


# =============================================================================
# slices, catalogs, performance model
# =============================================================================
def test_slices_match_reference():
    assert SLT.partition_catalog() == SLJ.partition_catalog()
    assert len(SLT.partition_catalog()) == 36
    for block in (1, 2, 4, 8):
        assert SLT.partition_catalog(block) == SLJ.partition_catalog(block)
    for part in SLJ.partition_catalog():
        assert SLT.config_number(part[::-1]) == SLJ.config_number(part)
        assert SLT.slice_counts(part) == SLJ.slice_counts(part)
    for name in ("BLOCK_CHIPS", "SLICE_SIZES", "HBM_PER_CHIP_GB",
                 "CHIP_POWER_PEAK_W", "CHIP_POWER_IDLE_W", "PEAK_FLOPS_BF16",
                 "HBM_BW", "ICI_BW"):
        assert getattr(SLT, name) == getattr(SLJ, name), name
    for chips in SLJ.SLICE_SIZES:
        assert SLT.slice_name(chips) == SLJ.slice_name(chips)
        for u in (-0.5, 0.0, 0.37, 1.0, 2.0):
            assert SLT.power_w(chips, u) == SLJ.power_w(chips, u)
        for mem in (0.5, 14.4, 14.5, 100.0):
            assert SLT.fits(mem, chips) == SLJ.fits(mem, chips)


@pytest.mark.parametrize("family", FAMILIES + ("yolov5", "mamba2-2.7b",
                                               "zamba2-2.7b"))
def test_catalog_and_perf_model_match_reference(family):
    vj, vt = CATJ.get_family(family), CATT.get_family(family)
    assert [_astuple(v) for v in vt] == [_astuple(v) for v in vj]
    assert _astuple(CATT.best_variant(vt)) == _astuple(CATJ.best_variant(vj))
    assert _astuple(CATT.worst_variant(vt)) == \
        _astuple(CATJ.worst_variant(vj))
    for a, b in zip(vt, vj):
        assert a.key == b.key
        assert CATT.feasible_slices(a) == CATJ.feasible_slices(b)
        for chips in SLJ.SLICE_SIZES:
            assert PMT.latency_s(a, chips) == PMJ.latency_s(b, chips)
            assert _astuple(PMT.service_point(a, chips)) == \
                _astuple(PMJ.service_point(b, chips))
            assert _astuple(PMT.cached_point(a, chips)) == \
                _astuple(PMJ.cached_point(b, chips))
            assert PMT.reconfig_seconds(a, chips) == \
                PMJ.reconfig_seconds(b, chips)
            for busy in (0.0, 0.3, 1.0):
                assert PMT.instance_power_w(chips, busy) == \
                    PMJ.instance_power_w(chips, busy)
    assert (PMT.P_IDLE_W, PMT.P_BUSY_W) == (PMJ.P_IDLE_W, PMJ.P_BUSY_W)


# =============================================================================
# configuration graph and objective
# =============================================================================
@pytest.mark.parametrize("family", FAMILIES)
def test_graph_algebra_and_evaluate_match_reference(family):
    vj, vt = CATJ.get_family(family), CATT.get_family(family)
    best = CATJ.best_variant(vj).name
    uj = CGJ.ConfigGraph.uniform(family, best, 16, 2)
    ut = CGT.ConfigGraph.uniform(family, best, 16, 2)
    assert ut.edges == uj.edges
    rj, rt = random.Random(4), random.Random(4)
    for _ in range(12):
        gj = CGJ.random_config(family, vj, 2, rj)
        gt = CGT.random_config(family, vt, 2, rt)
        assert gt.edges == gj.edges
        assert gt.is_valid(2, vt) == gj.is_valid(2, vj)
        assert gt.instances() == gj.instances()
        assert gt.add(ut).edges == gj.add(uj).edges
        assert gt.add(ut).subtract(ut).edges == gt.edges
        assert [n.edges for n in CGT.neighbors(gt, vt)] == \
            [n.edges for n in CGJ.neighbors(gj, vj)]
        for rate in (1e-9, 3.0, 50.0, 400.0, 1e5):
            assert _astuple(OBJT.evaluate(gt, vt, rate)) == \
                _astuple(OBJJ.evaluate(gj, vj, rate))
    with pytest.raises(ValueError):
        ut.subtract(ut.add(ut))
    empty = CGT.ConfigGraph.from_dict(family, {})
    assert _astuple(OBJT.evaluate(empty, vt, 1.0)) == \
        _astuple(OBJJ.evaluate(CGJ.ConfigGraph.from_dict(family, {}), vj,
                               1.0))


# =============================================================================
# schemes, context, controller
# =============================================================================
def _contexts(family="efficientnet", **kw):
    cj, aj = SIMJ.make_context(family, SIMJ.SimConfig(**kw))
    ct, at = SIMT.make_context(family, SIMT.SimConfig(**kw))
    return (cj, aj), (ct, at)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_context_matches_reference(family):
    (cj, aj), (ct, at) = _contexts(family, n_blocks=3, lam=0.3,
                                   accuracy_threshold_pct=2.0)
    assert at == aj
    assert _astuple(ct.obj_cfg) == _astuple(cj.obj_cfg)
    assert (ct.family, ct.n_blocks, ct.arrival_rps) == \
        (cj.family, cj.n_blocks, cj.arrival_rps)
    assert [_astuple(v) for v in ct.variants] == \
        [_astuple(v) for v in cj.variants]
    assert _astuple(ct.sa_cfg) == _astuple(cj.sa_cfg)
    # the fleet's pinned SLA and an explicit ladder
    (cj, _), (ct, _) = _contexts(family, sla_target_s=0.25)
    assert ct.obj_cfg.l_tail_s == cj.obj_cfg.l_tail_s == 0.25
    vt = CATT.get_family(family)[:2]
    ct, at = SIMT.make_context("x", SIMT.SimConfig(), variants=vt)
    cj, aj = SIMJ.make_context("x", SIMJ.SimConfig(),
                               variants=CATJ.get_family(family)[:2])
    assert at == aj and _astuple(ct.obj_cfg) == _astuple(cj.obj_cfg)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_reoptimize_matches_reference(scheme):
    (cj, _), (ct, _) = _contexts("albert", n_blocks=2)
    sj, st = SCHJ.make_scheme(scheme), SCHT.make_scheme(scheme)
    assert (st.name, st.carbon_aware) == (sj.name, sj.carbon_aware)
    gj, gt = sj.initial(cj), st.initial(ct)
    assert gt.edges == gj.edges
    for ci in (320.0, 140.0, 260.0):
        gj, oj = sj.reoptimize(cj, ci, gj)
        gt, ot = st.reoptimize(ct, ci, gt)
        assert gt.edges == gj.edges
        assert (ot is None) == (oj is None)
        if oj is not None:
            assert (ot.best_f, ot.duration_s, ot.n_evals) == \
                (oj.best_f, oj.duration_s, oj.n_evals)
            assert [e.graph.edges for e in ot.evaluations] == \
                [e.graph.edges for e in oj.evaluations]
    assert SCHT.co2opt_config(ct).edges == SCHJ.co2opt_config(cj).edges
    assert sorted(SCHT.SCHEMES) == sorted(SCHJ.SCHEMES)


def _invocations(c):
    return [(i.t_s, i.ci, i.predictive, i.config.edges,
             None if i.outcome is None else i.outcome.best_f)
            for i in c.invocations]


def test_controller_reinvocation_threshold_matches_reference():
    """The reference's tests/test_serving.py:99: a 1.7 % change stays
    below the 5 % threshold, a 10 % change re-invokes."""
    out = []
    for CTRL, SCH, (ctx, _) in zip((CTRLJ, CTRLT), (SCHJ, SCHT),
                                   _contexts(n_blocks=1)):
        seen = []
        c = CTRL.Controller(SCH.make_scheme("CLOVER"), ctx,
                            on_config_change=lambda g: seen.append(g.edges))
        c.start(0.0, 300.0)
        n0 = len(c.invocations)
        assert not c.should_reoptimize(305.0)
        assert c.should_reoptimize(330.0)
        cfg, outcome = c.maybe_reoptimize(60.0, 330.0)
        assert len(c.invocations) == n0 + 1 and outcome is not None
        assert c.maybe_reoptimize(120.0, 331.0) == (cfg, None)
        out.append((_invocations(c), seen, c.last_opt_ci, c.last_opt_hat))
    assert out[1] == out[0]


def test_controller_elastic_scaling_matches_reference():
    """The reference's tests/test_serving.py:113, on a BASE and a CLOVER
    controller: adding blocks adds the best variant unpartitioned, removing
    them subtracts an exact 16-chip cover."""
    for scheme in ("BASE", "CLOVER"):
        out = []
        for CTRL, SCH, (ctx, _) in zip((CTRLJ, CTRLT), (SCHJ, SCHT),
                                       _contexts(n_blocks=2)):
            c = CTRL.Controller(SCH.make_scheme(scheme), ctx)
            g0 = c.start(0.0, 300.0)
            g1 = c.scale_blocks(+2)
            assert g1.total_chips == g0.total_chips * 2
            g2 = c.scale_blocks(-3)
            assert g2.total_chips == g0.total_chips // 2
            g3 = c.scale_blocks(+1)
            out.append((g0.edges, g1.edges, g2.edges, g3.edges,
                        ctx.n_blocks))
        assert out[1] == out[0]


class _Ramp:
    def __init__(self, ci_future):
        self.ci_future = ci_future

    def predict(self, t, horizon_s):
        return self.ci_future


def test_controller_predictive_triggers_match_reference():
    """The reference's tests/test_fleet.py:364-405: the forecast trigger
    fires before the reactive one and optimizes against the blend; a
    stable pair does not re-trip it; without a forecaster it is silent."""
    out = []
    for CTRL, SCH, (ctx, _) in zip((CTRLJ, CTRLT), (SCHJ, SCHT),
                                   _contexts(n_blocks=1)):
        fc = _Ramp(300.0)
        c = CTRL.Controller(SCH.make_scheme("CLOVER"), ctx, forecaster=fc)
        c.start(0.0, 300.0)
        assert not c.should_reoptimize(300.0, t=0.0)
        fc.ci_future = 400.0
        assert c.should_reoptimize(300.0, t=60.0)
        c.maybe_reoptimize(60.0, 300.0)
        inv = c.invocations[-1]
        assert inv.predictive and 300.0 < inv.ci < 400.0
        n = len(c.invocations)
        for k in range(10):
            c.maybe_reoptimize(120.0 + 60.0 * k, 300.0)
        assert len(c.invocations) == n
        silent = CTRL.Controller(SCH.make_scheme("CLOVER"), ctx)
        silent.start(0.0, 300.0)
        assert not silent.should_reoptimize(302.0, t=0.0)
        out.append(_invocations(c))
    assert out[1] == out[0]


def test_controller_reads_carbon_feed_like_reference():
    """``maybe_reoptimize(t)`` without a ci acts on the attached feed's
    latest snapshot."""
    from repro.obs import CarbonFeed as FeedJ
    from repro_torch.obs import CarbonFeed as FeedT
    out = []
    for CTRL, SCH, Feed, (ctx, _) in zip((CTRLJ, CTRLT), (SCHJ, SCHT),
                                         (FeedJ, FeedT),
                                         _contexts(n_blocks=1)):
        feed = Feed(lambda t: 200.0 + t / 60.0, interval_s=60.0)
        c = CTRL.Controller(SCH.make_scheme("CLOVER"), ctx, feed=feed)
        c.start(0.0, 200.0)
        with pytest.raises(AssertionError, match="snapshot"):
            c.maybe_reoptimize(10.0)
        for k in range(40):
            feed.record_segment(60.0 * k, 60.0, 1000.0, 0.1)
        c.maybe_reoptimize(2400.0)
        out.append(_invocations(c))
    assert out[1] == out[0] and len(out[0]) == 2


# =============================================================================
# fluid server and run_trace
# =============================================================================
def test_fluid_server_serve_segment_matches_reference():
    trace_j = CBJ.make_trace("ESO-March", hours=2.0)
    trace_t = CBT.make_trace("ESO-March", hours=2.0)
    (cj, aj), (ct, at) = _contexts("albert", n_blocks=1)
    sj = SIMJ.FluidServer(cj.variants, CBJ.CarbonAccountant(trace_j),
                          cj.obj_cfg.l_tail_s)
    st = SIMT.FluidServer(ct.variants, CBT.CarbonAccountant(trace_t),
                          ct.obj_cfg.l_tail_s)
    rj, rt = random.Random(1), random.Random(1)
    t = 0.0
    for k in range(16):
        gj = CGJ.random_config("albert", cj.variants, 1, rj)
        gt = CGT.random_config("albert", ct.variants, 1, rt)
        # under- and overload, with and without deferrable work
        load = aj * (0.3 + 0.25 * k)
        a = sj.serve_segment(gj, t, 300.0, load, 0.2 * load * (k % 2),
                             0.002 * (k % 3))
        b = st.serve_segment(gt, t, 300.0, load, 0.2 * load * (k % 2),
                             0.002 * (k % 3))
        assert _astuple(b) == _astuple(a)
        t += 300.0
    for name in ("backlog", "defer_backlog", "served_total",
                 "defer_served_total", "acc_weighted", "lat_samples",
                 "sla_over", "sla_windows", "mean_accuracy",
                 "sla_violation_frac"):
        assert getattr(st, name) == getattr(sj, name), name
    assert st.weighted_p95() == sj.weighted_p95()
    assert (st.acct.energy_j, st.acct.carbon_g) == \
        (sj.acct.energy_j, sj.acct.carbon_g)
    samples = [(0.3, 2.0), (0.1, 5.0), (0.9, 0.5), (0.2, 1.0)]
    assert SIMT.weighted_p95(samples) == SIMJ.weighted_p95(samples)
    assert SIMT.weighted_p95([]) == SIMJ.weighted_p95([]) == 0.0


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_run_trace_matches_reference(family, scheme):
    sim = dict(n_blocks=2, window_s=120.0, seed=3)
    want = SIMJ.run_trace(scheme, family,
                          CBJ.make_trace("CISO-March", hours=3.0),
                          SIMJ.SimConfig(**sim))
    got = SIMT.run_trace(scheme, family,
                         CBT.make_trace("CISO-March", hours=3.0),
                         SIMT.SimConfig(**sim))
    _same_report(got, want)
    assert got.carbon_per_req_g() == want.carbon_per_req_g()
    if scheme in ("BLOVER", "CLOVER", "ORACLE"):
        assert got.n_invocations >= 2


def test_compare_schemes_and_savings_match_reference():
    sim = dict(n_blocks=1, seed=5, accuracy_threshold_pct=1.0)
    want = SIMJ.compare_schemes("efficientnet",
                                CBJ.make_trace("ESO-March", hours=4.0),
                                sim=SIMJ.SimConfig(**sim))
    got = SIMT.compare_schemes("efficientnet",
                               CBT.make_trace("ESO-March", hours=4.0),
                               sim=SIMT.SimConfig(**sim))
    assert list(got) == list(want) == list(SCHEMES)
    for s in SCHEMES:
        _same_report(got[s], want[s])
    assert SIMT.savings_vs_base(got) == SIMJ.savings_vs_base(want)


@pytest.mark.parametrize("argv", [
    ["--mode", "sim", "--hours", "6"],
    ["--mode", "sim", "--hours", "3", "--family", "albert", "--scheme",
     "BLOVER", "--region", "ESO-March", "--blocks", "2", "--lam", "0.3"],
])
def test_serve_mode_sim_prints_reference_json(argv):
    outs = []
    for mod in (SERVEJ, SERVET):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    out = json.loads(outs[1])
    assert set(out) == {"scheme", "family", "region", "carbon_saving_pct",
                        "accuracy_delta_pct", "p95_vs_sla", "opt_time_pct",
                        "invocations"}
