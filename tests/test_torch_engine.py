"""The port's paged serving engine against the reference's, at SMOKE size
on the CPU, with the reference's weights carried across: equal per-request
greedy token streams on mixed prompts with a shared prefix; and the
engine's own invariants — prefix sharing, full arena reclamation,
per-request joules summing to the session total, pipelined and synchronous
loops agreeing, and no per-tick host→device uploads in steady decode.
Token streams must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import config_graph as CGJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import config_graph as CGT
from repro_torch.launch import mesh as MESH
from repro_torch.models import bridge
from repro_torch.serving import engine as ENG
from repro_torch.serving.api import InferenceRequest

CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE


@pytest.fixture(scope="module")
def families():
    """(reference family, port family with the same weights)."""
    fam_j = ENGJ.build_engine_family(CFG, fracs=(1.0,))
    fam_t = ENG.build_engine_family(CFG_T, fracs=(1.0,), device="cpu")
    bridge.load_reference(fam_t[0].params, _flatten(fam_j[0].params))
    return fam_j, fam_t


@pytest.fixture(scope="module")
def family(families):
    return families[1]


def _graph(cg=CGT):
    return cg.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1})


def _mixed_prompts(vocab, seed=3):
    """Mixed-length prompts, the longer ones sharing a 16-token prefix
    (the reference's ``tests/test_kvpool.py`` workload)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    prompts = []
    for n in (4, 10, 24, 40, 4, 24):
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if n >= 24:
            p[:16] = shared
        prompts.append(p)
    return prompts


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=int(n)).astype(np.int32)
            for n in lens]


def _engine(family, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seqs", 4)
    eng = ENG.RealEngine(family, kv_layout="paged", device="cpu", **kw)
    eng.configure(_graph())
    return eng


def _assert_same_outputs(a, b):
    assert set(a.last_outputs) == set(b.last_outputs)
    for rid in a.last_outputs:
        np.testing.assert_array_equal(a.last_outputs[rid],
                                      b.last_outputs[rid])


# =============================================================================
# parity with the reference engine
# =============================================================================
def test_paged_engine_matches_reference_engine(families):
    """The acceptance gate: on mixed prompt lengths with a shared prefix the
    port's paged engine reproduces the reference paged engine's greedy
    outputs exactly, with the same scheduling counters."""
    fam_j, fam_t = families
    prompts = _mixed_prompts(CFG.vocab_size)
    ref = ENGJ.RealEngine(fam_j, n_slots=2, max_len=48, kv_layout="paged",
                          block_size=8, max_seqs=6)
    ref.configure(_graph(CGJ))
    m_ref = ref._serve_prompts(prompts, n_new=6)
    eng = _engine(fam_t, n_slots=2, max_seqs=6)
    m = eng._serve_prompts(prompts, n_new=6)
    _assert_same_outputs(ref, eng)
    assert ref.last_admit_order == eng.last_admit_order
    for key in ("served", "tokens", "prefix_hit_tokens", "prefill_chunks",
                "decode_steps", "decode_dispatches", "h2d_transfers",
                "host_syncs", "compile_retraces", "blocks_peak"):
        assert m[key] == m_ref[key], key
    assert m["prefix_hit_tokens"] > 0          # the shared prefix was shared


# =============================================================================
# the engine's own invariants
# =============================================================================
def test_arena_fully_reclaimed_and_joules_conserved(family):
    """After a serve, live sequences hold nothing; after dropping the prefix
    cache the allocator is whole again; per-request joules sum to the
    session total and carbon follows the intensity."""
    eng = _engine(family, n_slots=2, ci_g_per_kwh=400.0)
    m = eng._serve_prompts(_mixed_prompts(CFG.vocab_size, seed=9), n_new=4)
    inst = eng.instances[0]
    inst.alloc.check()
    assert all(s is None for s in inst.rows)
    assert inst.alloc.blocks_in_use() == len(inst.prefix)
    inst.prefix.clear()
    inst.alloc.check()
    assert inst.alloc.num_free == inst.alloc.num_allocatable
    total = sum(r.energy_j for r in eng.last_responses)
    assert total == pytest.approx(m["energy_j"], rel=1e-12)
    assert sum(r.carbon_g for r in eng.last_responses) == \
        pytest.approx(m["carbon_g"], rel=1e-12)
    assert all(r.energy_j > 0 for r in eng.last_responses)


def test_pipelined_and_synchronous_loops_agree(family):
    """Admissions, releases and bucket changes force event re-uploads
    mid-stream in the pipelined loop — its tokens must equal the
    synchronous reference loop's."""
    prompts = _prompts((6, 14, 9, 22, 6, 11), seed=1)
    pipe = _engine(family)
    sync = _engine(family, decode_pipeline=False)
    m_pipe = pipe._serve_prompts(prompts, n_new=10)
    m_sync = sync._serve_prompts(prompts, n_new=10)
    _assert_same_outputs(pipe, sync)
    assert m_pipe["served"] == m_sync["served"] == len(prompts)
    assert m_pipe["tokens"] == m_sync["tokens"]
    assert m_pipe["decode_dispatches"] == m_pipe["decode_steps"]
    assert m_sync["decode_dispatches"] == m_sync["decode_steps"]


def test_steady_state_decode_has_no_per_tick_host_traffic(family):
    """In steady-state decode the pipelined loop adds ZERO host→device
    uploads per tick (uploads stay bound to events) and ZERO blocking
    round-trips, while the synchronous loop pays its per-step freight; one
    fused dispatch covers several steps."""
    prompts = _prompts((6, 6, 6, 6), seed=7)
    pipe = _engine(family)
    sync = _engine(family, decode_pipeline=False)
    m_pipe = pipe._serve_prompts(prompts, n_new=32)
    m_sync = sync._serve_prompts(prompts, n_new=32)
    _assert_same_outputs(pipe, sync)
    assert m_pipe["decode_steps"] >= 30
    n_events = 2 * len(prompts)
    assert m_pipe["h2d_transfers"] <= (2 * m_pipe["prefill_chunks"]
                                       + 4 * n_events)
    assert m_pipe["h2d_transfers"] * 3 < m_sync["h2d_transfers"]
    assert m_sync["h2d_transfers"] >= 4 * m_sync["decode_steps"]
    assert m_pipe["host_syncs"] == 0
    assert m_sync["host_syncs"] >= m_sync["decode_steps"]
    assert m_pipe["decode_dispatches"] * 2 <= m_pipe["decode_steps"]


def test_warmup_seeds_every_shape_and_serving_never_misses(family):
    eng = _engine(family)
    inst = eng.instances[0]
    for B in (1, 2, 4):
        for k in (1, inst.fused_steps):
            assert ("decode_multi", B, k) in inst._shapes
    m1 = eng._serve_prompts(_prompts((6, 6, 6, 6), seed=2), n_new=12)
    m2 = eng._serve_prompts(_prompts((6, 9), seed=4), n_new=12)
    assert m1["compile_retraces"] == m2["compile_retraces"] == 0
    assert m1["decode_dispatches"] < m1["decode_steps"]   # fusion engaged


def test_paged_admission_beyond_slot_count_and_open_loop(family):
    """Block-availability admission runs more sequences at once than the
    equal-arena slotted cache has slots; open-loop arrivals report finite
    queueing delay and TTFT."""
    eng = _engine(family, n_slots=2, max_seqs=8)
    rng = np.random.default_rng(11)
    m = eng._serve_prompts([rng.integers(0, CFG.vocab_size, size=6)
                            .astype(np.int32) for _ in range(12)], n_new=4)
    assert m["served"] == 12 and m["mean_inflight"] > 2.0
    m = eng.serve_poisson(rate_rps=50.0, n_requests=12,
                          prompt_lens=(4, 10, 24), n_new=4, seed=1)
    assert m["served"] == 12
    assert np.isfinite(m["queue_delay_p95_s"]) and m["ttft_p95_s"] > 0


def test_token_stream_callbacks_and_single_token_requests(family):
    """``on_token`` sees every token in order; a request for one token is
    its prefill's first token (a counted host sync)."""
    eng = _engine(family)
    seen = {}
    prompts = _prompts((5, 12), seed=3)
    for rid, (p, n) in enumerate(zip(prompts, (1, 7))):
        eng.submit(InferenceRequest(
            rid=rid, prompt=p, max_new_tokens=n,
            on_token=lambda r, t: seen.setdefault(r, []).append(t)))
    eng.drain()
    assert len(eng.last_outputs[0]) == 1 and len(eng.last_outputs[1]) == 7
    for rid, toks in eng.last_outputs.items():
        assert seen[rid] == list(toks)
    assert eng.stats()["host_syncs"] >= 1


@pytest.mark.parametrize("kw", [{"preemption": True},
                                {"telemetry": object(),
                                 "roles": {"prefill": 1, "decode": 1}},
                                {"quality_selector": "greedy"},
                                {},
                                {"roles": (1, 1)}])
def test_unported_engine_options_raise(family, kw):
    """``mesh=`` of two devices made outside a process group is refused
    with ``ValueError`` (one process cannot drive them: a mesh of several
    devices runs as ranks, ``launch.ranks.spawn``, which
    ``tests/test_torch_tp_engine.py`` serves through), alone and beside
    preemption, telemetry, the quality selector and ``roles=``
    (disaggregation); the same options on a (1, 1) mesh build
    (``tests/test_torch_launch_tools.py`` serves through it)."""
    cpus = np.empty((1, 2), dtype=object)
    cpus[:] = [[torch.device("cpu"), torch.device("cpu")]]
    two = MESH.Mesh((1, 2), ("data", "model"), cpus)
    with pytest.raises(ValueError, match="no process group"):
        ENG.RealEngine(family, kv_layout="paged", device="cpu", mesh=two,
                       **kw)
    one = MESH.make_mesh_for(1, device="cpu")
    eng = ENG.RealEngine(family, kv_layout="paged", device="cpu", mesh=one,
                         **kw)
    assert eng.mesh is one


def test_default_layout_builds_slotted_instances(family):
    """With no ``kv_layout`` the engine serves the slotted layout, as the
    reference's ``RealEngine`` does."""
    eng = ENG.RealEngine(family, device="cpu")
    assert eng.kv_layout == "slotted"
    eng.configure(_graph())
    assert eng.instances and all(type(i) is ENG.Instance
                                 for i in eng.instances)
    m = eng._serve_prompts(_prompts((5, 9), seed=6), n_new=3)
    assert m["served"] == 2 and m["prefill_chunks"] == 0


def test_engine_refuses_weights_on_another_device(family):
    with pytest.raises(ValueError, match="lives on"):
        ENG.RealEngine(family, device="meta")
