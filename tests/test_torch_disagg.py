"""Prefill/decode disaggregation in the port against the reference's, at
SMOKE size on the CPU with the reference's weights carried across
(``models/bridge.py``): ``RealEngine(roles=...)`` dispatch and the
role-split workers; per-rid token streams, handoffs, handoff pages and
preemptions equal to the reference's ``DisaggEngine`` and to the port's
monolithic paged engine, with a roomy arena and with a starved decode
arena that preempts; the per-role joules conserve under the reference's
``check_disagg_conservation`` and the port's; a handoff before the first
token lands is refused; both placement errors; a one-region real-backend
``run_fleet`` with ``engine_topology`` against the reference's; and a
monolithic engine that reports every joule under ``"both"``."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import carbon as CBJ
from repro.core import config_graph as CGJ
from repro.fleet import fleet_sim as FSJ
from repro.obs.validate import check_disagg_conservation as conserve_j
from repro.serving import backends as BKJ
from repro.serving import engine as ENGJ
from repro.serving.api import InferenceRequest as RequestJ
from repro.serving.api import serve_workload as serve_workload_j
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import carbon as CBT
from repro_torch.core import config_graph as CGT
from repro_torch.fleet import fleet_sim as FST
from repro_torch.launch import mesh as MESH
from repro_torch.models import bridge
from repro_torch.obs.validate import check_disagg_conservation as conserve_t
from repro_torch.serving import backends as BKT
from repro_torch.serving import engine as ENG
from repro_torch.serving.api import InferenceRequest, serve_workload
from repro_torch.serving.disagg import BlockHandoff, DisaggEngine

CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE


@pytest.fixture(scope="module")
def families():
    """(reference family, port family with the same weights)."""
    fam_j = ENGJ.build_engine_family(CFG, fracs=(1.0,))
    fam_t = ENG.build_engine_family(CFG_T, fracs=(1.0,), device="cpu")
    bridge.load_reference(fam_t[0].params, _flatten(fam_j[0].params))
    return fam_j, fam_t


def _port(families, **kw):
    eng = ENG.RealEngine(families[1], device="cpu", **kw)
    eng.configure(CGT.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    return eng


def _ref(families, **kw):
    eng = ENGJ.RealEngine(families[0], **kw)
    eng.configure(CGJ.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    return eng


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=L).astype(np.int32)
            for L in lens]


def _serve(eng, Req, serve, prompts, n_new):
    reqs = [Req(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    return {r.rid: r for r in serve(eng, reqs)}, eng.stats()


def _same_as(got, m, want, m_want):
    """Per rid: equal token streams and preemptions; per session: equal
    handoffs, handoff pages and preemptions."""
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].preemptions == want[rid].preemptions, rid
    for key in ("served", "tokens", "handoffs", "handoff_pages",
                "preemptions"):
        assert m[key] == m_want[key], key


def _conserves(m, responses):
    conserve_j(m)
    conserve_t(m)
    for r in responses.values():
        assert sum(r.energy_by_role.values()) == \
            pytest.approx(r.energy_j, rel=1e-9)


# =============================================================================
# construction / dispatch (the reference's tests/test_disagg.py:59, :75)
# =============================================================================
def test_roles_kwarg_builds_disagg_engine(families):
    """``roles=`` builds a ``DisaggEngine`` (and only on the paged layout);
    an abstract ``mesh=`` of two devices (shapes only) is refused with
    ``ValueError`` (a mesh of several devices runs as ranks:
    ``tests/test_torch_tp_disagg.py``) and a (1, 1) mesh passes through
    to the workers."""
    fam = families[1]
    eng = ENG.RealEngine(fam, n_slots=2, max_len=32, kv_layout="paged",
                         roles={"prefill": 1, "decode": 1}, device="cpu")
    assert isinstance(eng, DisaggEngine)
    assert eng.roles == {"prefill": 1, "decode": 1}
    eng2 = ENG.RealEngine(fam, kv_layout="paged", roles=(2, 1),
                          device="cpu")
    assert isinstance(eng2, DisaggEngine) and eng2.roles["prefill"] == 2
    mono = ENG.RealEngine(fam, kv_layout="paged", roles=None, device="cpu")
    assert type(mono) is ENG.RealEngine
    with pytest.raises(AssertionError):
        ENG.RealEngine(fam, kv_layout="slotted", roles=(1, 1), device="cpu")
    with pytest.raises(AssertionError):
        ENG.RealEngine(fam, kv_layout="paged", roles={"prefill": 1},
                       device="cpu")
    with pytest.raises(ValueError, match="abstract"):
        ENG.RealEngine(fam, kv_layout="paged", roles=(1, 1),
                       mesh=MESH.Mesh((1, 2), ("data", "model")),
                       device="cpu")
    one = MESH.make_mesh_for(1, device="cpu")
    eng = ENG.RealEngine(fam, kv_layout="paged", roles=(1, 1), mesh=one,
                         device="cpu")
    assert isinstance(eng, DisaggEngine) and eng.mesh is one


def test_configure_builds_role_split_workers(families):
    eng = _port(families, n_slots=2, max_len=32, kv_layout="paged",
                roles={"prefill": 2, "decode": 1})
    assert sorted(i.role for i in eng.instances) == \
        ["decode", "prefill", "prefill"]
    assert eng.profilers["prefill"].role == "prefill"
    assert eng.profilers["decode"].role == "decode"
    for inst in eng.instances:
        assert inst.profiler is eng.profilers[inst.role]


# =============================================================================
# token parity + conservation (:92, :134)
# =============================================================================
def test_disagg_token_parity_and_role_conservation(families):
    prompts = _prompts((7, 13, 5, 9, 11, 6), seed=0)
    kw = dict(n_slots=2, max_len=32, kv_layout="paged")
    rj, mj = _serve(_ref(families, roles={"prefill": 1, "decode": 1}, **kw),
                    RequestJ, serve_workload_j, prompts, 6)
    rd, md = _serve(_port(families, roles={"prefill": 1, "decode": 1}, **kw),
                    InferenceRequest, serve_workload, prompts, 6)
    rm, mm = _serve(_port(families, **kw), InferenceRequest, serve_workload,
                    prompts, 6)
    _same_as(rd, md, rj, mj)
    assert md["handoffs"] == len(prompts)
    assert md["handoff_pages"] >= len(prompts)
    assert mm["handoffs"] == 0 and mm["handoff_pages"] == 0
    for rid in rm:
        np.testing.assert_array_equal(rd[rid].tokens, rm[rid].tokens)
    _conserves(md, rd)
    assert md["prefill_energy_j"] > 0 and md["decode_energy_j"] > 0
    assert md["handoff_energy_j"] > 0 and md["both_energy_j"] == 0.0
    for r in rd.values():
        assert set(r.energy_by_role) <= {"prefill", "decode", "handoff"}
        assert r.preemptions == 0
    assert md["preemptions"] == 0


def test_disagg_decode_preemption_token_identical(families):
    """A starved decode arena after handoff swaps victims out and restores
    them bit-exactly: the streams equal a monolithic engine's on a roomy
    arena and the reference's disaggregated engine's, preemption for
    preemption; handoffs never count as preemptions."""
    prompts = _prompts((6, 6, 6, 6), seed=5)
    kw = dict(n_slots=2, max_len=48, kv_layout="paged", block_size=8,
              max_seqs=4)
    starved = dict(n_blocks=9, preemption=True, prefix_caching=False,
                   roles={"prefill": 1, "decode": 1}, **kw)
    rm, mm = _serve(_port(families, n_blocks=33, **kw), InferenceRequest,
                    serve_workload, prompts, 20)
    assert mm["preemptions"] == 0
    rj, mj = _serve(_ref(families, **starved), RequestJ, serve_workload_j,
                    prompts, 20)
    eng = _port(families, **starved)
    rd, md = _serve(eng, InferenceRequest, serve_workload, prompts, 20)
    _same_as(rd, md, rj, mj)
    assert md["preemptions"] >= 1, "starved decode arena must preempt"
    assert md["handoffs"] == len(prompts) and md["served"] == len(prompts)
    for rid in rm:
        np.testing.assert_array_equal(rd[rid].tokens, rm[rid].tokens)
    assert sum(r.preemptions for r in rd.values()) == md["preemptions"]
    pre = next(i for i in eng.instances if i.role == "prefill")
    assert pre.preemptions == 0
    _conserves(md, rd)
    for inst in eng.instances:
        inst.alloc.check()
        assert inst.alloc.num_free == inst.alloc.num_allocatable


def test_handoff_stage_requires_landed_first_token(families):
    eng = _port(families, n_slots=2, max_len=32, kv_layout="paged",
                roles=(1, 1))
    pre = next(i for i in eng.instances if i.role == "prefill")
    eng.submit(InferenceRequest(rid=0, prompt=_prompts((7,), seed=3)[0],
                                max_new_tokens=4))
    eng.step()
    seq = next(q for q in pre.rows if q is not None)
    # the one chunk ran and its first token is still in flight
    assert seq.prefilled and seq.pending_first is not None
    with pytest.raises(AssertionError, match="first token"):
        BlockHandoff.stage(pre, seq)
    eng.drain()
    assert eng.stats()["handoffs"] == 1


@pytest.mark.parametrize("fault", ["no_decode_worker", "arena_too_small"])
def test_place_errors(families, fault):
    """A handoff with no decode worker of its variant, and one that fits
    no idle decode worker, raise instead of waiting forever."""
    eng = _port(families, n_slots=2, max_len=48, kv_layout="paged",
                block_size=8, max_seqs=2, roles=(1, 1))
    dec = next(i for i in eng.instances if i.role == "decode")
    if fault == "no_decode_worker":
        dec.role, match = "both", "no decode worker"
    else:
        dec.alloc.alloc(dec.alloc.num_free - 1)
        match = "fits no idle decode worker"
    eng.submit(InferenceRequest(rid=0, prompt=_prompts((20,), seed=4)[0],
                                max_new_tokens=4))
    with pytest.raises(RuntimeError, match=match):
        eng.drain()


# =============================================================================
# monolithic engine: every joule under "both"
# =============================================================================
def test_monolithic_joules_all_under_both(families):
    prompts = _prompts((7, 13, 5), seed=1)
    rm, mm = _serve(_port(families, n_slots=2, max_len=32, kv_layout="paged"),
                    InferenceRequest, serve_workload, prompts, 5)
    assert mm["both_energy_j"] == mm["energy_j"]
    assert mm["prefill_energy_j"] == mm["decode_energy_j"] == \
        mm["handoff_energy_j"] == 0.0
    _conserves(mm, rm)
    for r in rm.values():
        assert set(r.energy_by_role) == {"both"}
        assert r.energy_by_role["both"] == pytest.approx(r.energy_j,
                                                         rel=1e-9)


# =============================================================================
# the fleet's engine_topology
# =============================================================================
def test_run_fleet_engine_topology_matches_reference(families, monkeypatch):
    """A one-region, one-hour real-backend fleet whose region is in
    ``engine_topology``: each package's region gets a disaggregated
    engine, and the configurations applied and the per-rid token streams
    of every probe window are the reference's."""
    fam_j = BKJ.build_real_family("qwen3-1.7b", 2, seed=0)
    fam_t = BKT.build_real_family("qwen3-1.7b", 2, seed=0, device="cpu")
    for ev_j, ev_t in zip(fam_j, fam_t):
        bridge.load_reference(ev_t.params, _flatten(ev_j.params))
    monkeypatch.setattr(BKJ, "build_real_family", lambda *a, **k: fam_j)
    logs = []
    for BK in (BKJ, BKT):
        log = {"configs": [], "streams": [], "handoffs": 0}
        probe = BK.RealWindowServer.probe_window

        def probe_logged(self, g, t=0.0, probe=probe, log=log):
            m = probe(self, g, t)
            if m is not None:
                log["configs"].append(g.edges)
                log["streams"].append(
                    {rid: list(map(int, v)) for rid, v in
                     self.engine.last_outputs.items()})
                log["handoffs"] += m["handoffs"]
                conserve_j(m)
                conserve_t(m)
            log["engine"] = type(self.engine).__name__
            return m
        monkeypatch.setattr(BK.RealWindowServer, "probe_window",
                            probe_logged)
        logs.append(log)
    for CB, FS, kw in ((CBJ, FSJ, {}), (CBT, FST, {"engine_family": fam_t})):
        cfg = FS.FleetConfig(n_blocks=1, window_s=600.0, backend="real",
                             deferrable_frac=0.1, n_jobs=2,
                             min_slack_s=1800.0, max_slack_s=3600.0,
                             engine_kv_layout="paged",
                             engine_topology={"CISO-March": (1, 1)})
        FS.run_fleet("efficientnet",
                     {"CISO-March": CB.make_trace("CISO-March", hours=1.0,
                                                  seed=3)}, cfg, **kw)
    assert logs[1] == logs[0]
    assert logs[1]["engine"] == "DisaggEngine"
    assert len(logs[1]["streams"]) >= 1
    assert logs[1]["handoffs"] == sum(len(s) for s in logs[1]["streams"])
