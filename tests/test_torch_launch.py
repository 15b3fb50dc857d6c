"""Clover's real-mode control loop on the port: the copies of the
configuration graph's neighbourhood, the carbon traces, the objective and
the annealer against the reference's on the same inputs (equal values,
and the same graphs visited under the same ``random.Random(0)`` and
evaluator), the config registry, and ``repro_torch.launch.serve --mode
real`` on the CPU."""
import json
import random

import numpy as np
import pytest

from repro.core import annealing as SAJ
from repro.core import carbon as CBJ
from repro.core import catalog as CATJ
from repro.core import config_graph as CGJ
from repro.core import objective as OBJJ
from repro_torch.configs import get_config, get_smoke_config, \
    mamba2_2_7b, qwen2_moe_a2_7b, qwen2_vl_7b, qwen3_1_7b, \
    qwen3_moe_30b_a3b, seamless_m4t_large_v2
from repro_torch.core import annealing as SAT
from repro_torch.core import carbon as CBT
from repro_torch.core import catalog as CATT
from repro_torch.core import config_graph as CGT
from repro_torch.core import objective as OBJT
from repro_torch.launch import serve as SERVE
from repro_torch.serving import engine as ENG


def _ladders():
    """The same three-rung ladder as both packages' Variant records (the
    real-mode loop's mem_gb is small: every slice fits)."""
    spec = [("x0.25", 1, 0.80, 0.5), ("x0.5", 2, 0.85, 1.0),
            ("x1", 3, 0.90, 40.0)]                # x1 does not fit 1c/2c
    return tuple([mod.Variant("qwen3-1.7b-smoke", name, q, acc, 1.0, 1.0, mem)
                  for name, q, acc, mem in spec] for mod in (CATJ, CATT))


@pytest.mark.parametrize("spec", [
    {("x0.25", 8): 2},
    {("x1", 8): 1, ("x0.5", 4): 2},
    {("x0.5", 2): 3, ("x0.25", 1): 2, ("x1", 8): 1},
])
def test_neighbourhood_matches_reference(spec):
    vj, vt = _ladders()
    gj = CGJ.ConfigGraph.from_dict("f", spec)
    gt = CGT.ConfigGraph.from_dict("f", spec)
    want = [n.edges for n in CGJ.neighbors(gj, vj)]
    got = [n.edges for n in CGT.neighbors(gt, vt)]
    assert got == want and got
    for nj, nt in zip(CGJ.neighbors(gj, vj), CGT.neighbors(gt, vt)):
        assert CGT.ged(gt, nt) == CGJ.ged(gj, nj)


@pytest.mark.parametrize("region", ["CISO-March", "CISO-September",
                                    "ESO-March"])
def test_carbon_trace_matches_reference(region):
    tj = CBJ.make_trace(region, hours=6.0)
    tt = CBT.make_trace(region, hours=6.0)
    np.testing.assert_array_equal(tt.times_s, tj.times_s)
    np.testing.assert_array_equal(tt.intensity, tj.intensity)
    for t in (0.0, 1234.5, 6 * 3600.0):
        assert tt.at(t) == tj.at(t)
    assert tt.mean() == tj.mean() and tt.duration_s == tj.duration_s
    with pytest.raises(KeyError):
        CBT.make_trace("nowhere")


def test_objective_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        acc, cap, rho, p95, pw, e = rng.uniform(0.1, 2.0, size=6)
        ci = float(rng.uniform(50, 400))
        kw = dict(lam=float(rng.uniform()), a_base=0.9, c_base=2e-3,
                  l_tail_s=1.0, max_accuracy_loss_pct=(
                      None if rng.uniform() < 0.5 else 5.0))
        rj = OBJJ.EvalResult(acc, cap, rho, p95, pw, e)
        rt = OBJT.EvalResult(acc, cap, rho, p95, pw, e)
        cj, ct = OBJJ.ObjectiveConfig(**kw), OBJT.ObjectiveConfig(**kw)
        assert OBJT.objective_f(rt, ci, ct) == OBJJ.objective_f(rj, ci, cj)
        assert OBJT.sa_energy(rt, ci, ct) == OBJJ.sa_energy(rj, ci, cj)
        assert OBJT.meets_sla(rt, ct) == OBJJ.meets_sla(rj, cj)
        assert rt.carbon_per_req_g(ci) == rj.carbon_per_req_g(ci)


@pytest.mark.parametrize("stale_limit", [3, 5])
def test_anneal_visits_the_same_graphs_as_the_reference(stale_limit):
    """The port's annealer, under the same ``random.Random(0)`` and a
    deterministic evaluator, evaluates the same sequence of graphs and
    picks the same best as the reference's."""
    vj, vt = _ladders()

    def evaluator(mod):
        def ev(g):
            acc = {v.name: v.accuracy for v in vj}
            n = g.n_instances
            a = sum(acc[vn] * w for (vn, _), w in g.edges) / n
            chips = sum(c * w for (_, c), w in g.edges)
            p95 = 0.1 + 0.05 * n / chips + (1.0 - a)
            return mod.EvalResult(a, 10.0 * n, 0.5, p95, 0.0,
                                  100.0 * a * chips / n)
        return ev

    kw = dict(lam=0.5, a_base=0.9, c_base=5e-3, l_tail_s=0.3)
    start = {("x1", 8): 2}
    outs = []
    for sa, cg, obj, variants in ((SAJ, CGJ, OBJJ, vj),
                                  (SAT, CGT, OBJT, vt)):
        outs.append(sa.anneal(
            cg.ConfigGraph.from_dict("f", start), variants, evaluator(obj),
            ci=250.0, obj_cfg=obj.ObjectiveConfig(**kw),
            sa_cfg=sa.SAConfig(stale_limit=stale_limit, eval_window_s=0.0),
            rng=random.Random(0)))
    want, got = outs
    assert [e.graph.edges for e in got.evaluations] == \
        [e.graph.edges for e in want.evaluations]
    assert got.n_evals > 1
    assert got.best.edges == want.best.edges and got.best_f == want.best_f
    assert [e.h for e in got.evaluations] == [e.h for e in want.evaluations]


def test_config_registry():
    assert get_smoke_config("qwen3-1.7b") == qwen3_1_7b.SMOKE
    assert get_config("qwen3-1.7b") == qwen3_1_7b.FULL
    assert get_config("qwen3-moe-30b-a3b") == qwen3_moe_30b_a3b.FULL
    assert get_smoke_config("qwen2-moe-a2.7b") == qwen2_moe_a2_7b.SMOKE
    assert get_smoke_config("mamba2-2.7b") == mamba2_2_7b.SMOKE
    assert get_smoke_config("qwen2-vl-7b") == qwen2_vl_7b.SMOKE
    assert get_config("seamless-m4t-large-v2") == \
        seamless_m4t_large_v2.FULL
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_run_real_on_cpu_anneals_over_the_slotted_engine(monkeypatch,
                                                         capsys):
    """``--mode real`` with ``--device cpu``: the loop serves the BASE
    configuration, evaluates candidate graphs on the slotted engine
    (reconfiguring it for each), and returns 0."""
    configured = []
    real = ENG.RealEngine.configure

    def counting(self, graph):
        assert self.kv_layout == "slotted"
        configured.append(graph.edges)
        return real(self, graph)

    monkeypatch.setattr(ENG.RealEngine, "configure", counting)
    assert SERVE.main(["--mode", "real", "--device", "cpu",
                       "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "Clover chose" in out and "device cpu" in out
    # BASE, then one configure per evaluation, then the chosen graph
    assert len(configured) >= 4
    assert len(set(configured)) >= 2          # it did reconfigure


def test_sim_mode_runs_without_a_device(capsys):
    """``--mode sim`` is ported now (tests/test_torch_sim.py holds its
    JSON to the reference's): it runs without a device and prints the
    scheme's savings against BASE."""
    assert SERVE.main(["--mode", "sim", "--hours", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["scheme"] == "CLOVER" and out["invocations"] >= 1
