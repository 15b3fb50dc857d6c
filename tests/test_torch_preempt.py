"""Paged preemption in the port against the reference engine, at SMOKE size
on the CPU with the reference's weights carried across: forced preemption
is token-identical to a never-preempted serve; the victim is the lowest
priority; the pipelined loop equals the synchronous one through swap-outs
and partial swap-ins; a partial swap-in copies back fewer pages than a full
restore; per-request joules stay exact with policy holds and partial
swap-ins interleaved.  Each case runs the reference's engine on the same
inputs and must match it exactly in token streams, admit order,
preemptions and pages saved; joules conserve at rel 1e-9."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import config_graph as CGJ
from repro.serving import engine as ENGJ
from repro.serving import policies as POLJ
from repro.serving.api import InferenceRequest as RequestJ
from repro.serving.api import serve_workload as serve_workload_j
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import config_graph as CGT
from repro_torch.models import bridge
from repro_torch.serving import engine as ENG
from repro_torch.serving import policies as POLT
from repro_torch.serving.api import DEFERRABLE, INTERACTIVE, \
    InferenceRequest, serve_workload

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


def _pair(families, **kw):
    """(reference engine, port engine), configured alike."""
    ref = ENGJ.RealEngine(families[0], **kw)
    ref.configure(CGJ.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    return ref, _port(families, **kw)


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=L).astype(np.int32)
            for L in lens]


def _preamble_prompts(n=4, preamble=16, tail=6, seed=5):
    """n prompts sharing a 16-token (two-block) preamble."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, CFG.vocab_size, size=preamble).astype(np.int32)
    return [np.concatenate([pre, rng.integers(0, CFG.vocab_size, size=tail)
                            .astype(np.int32)]) for _ in range(n)]


def _same_outputs(a, b):
    assert set(a.last_outputs) == set(b.last_outputs)
    for rid in a.last_outputs:
        np.testing.assert_array_equal(a.last_outputs[rid],
                                      b.last_outputs[rid])


# stats keys of the reference's disaggregation, not ported yet
DISAGG_KEYS = {"handoffs", "handoff_pages", "prefill_energy_j",
               "decode_energy_j", "handoff_energy_j", "both_energy_j"}


def _matches_reference(ref, eng, m_ref, m):
    """The port's serve equals the reference's: the stats keys (less
    disaggregation's; plus the port's TTFT median), token streams, admit
    order, preemption and swap-in counts, per-response preemptions."""
    assert set(m_ref) - set(m) == DISAGG_KEYS
    assert set(m) - set(m_ref) == {"ttft_p50_s"}
    _same_outputs(ref, eng)
    assert ref.last_admit_order == eng.last_admit_order
    for key in ("served", "tokens", "preemptions", "swapin_pages_copied",
                "partial_swapin_pages_saved", "prefill_chunks",
                "decode_steps", "decode_dispatches", "h2d_transfers",
                "host_syncs", "blocks_peak"):
        assert m[key] == m_ref[key], key
    pre_ref = {r.rid: r.preemptions for r in ref.last_responses}
    assert {r.rid: r.preemptions for r in eng.last_responses} == pre_ref
    assert sum(r.energy_j for r in eng.last_responses) == \
        pytest.approx(m["energy_j"], rel=1e-9)


def _fully_reclaimed(eng, prefix: bool):
    inst = eng.instances[0]
    inst.alloc.check()
    assert all(s is None for s in inst.rows)
    assert not inst._inflight and not inst._pending_first
    if prefix:
        inst.prefix.clear()
    assert inst.alloc.num_free == inst.alloc.num_allocatable


# =============================================================================
# forced preemption (the reference's test_api.py:268 and :298)
# =============================================================================
def test_forced_preemption_token_identical(families):
    """4 sequences wanting ceil(26/8) = 4 blocks each on an arena of 8:
    admission reserves only the prompt's block, decode growth runs the
    arena dry and must preempt — the streams equal a never-preempted
    serve's and the reference's."""
    prompts = _prompts((6, 6, 6, 6), seed=5)
    kw = dict(n_slots=2, max_len=48, kv_layout="paged", block_size=8,
              max_seqs=4)
    plain = _port(families, n_blocks=33, **kw)
    assert plain._serve_prompts(prompts, n_new=20)["preemptions"] == 0
    ref, eng = _pair(families, n_blocks=9, preemption=True,
                     prefix_caching=False, **kw)
    m_ref = ref._serve_prompts(prompts, n_new=20)
    m = eng._serve_prompts(prompts, n_new=20)
    assert m["preemptions"] >= 1 and m["served"] == len(prompts)
    _same_outputs(plain, eng)
    _matches_reference(ref, eng, m_ref, m)
    assert sum(r.preemptions for r in eng.last_responses) == \
        m["preemptions"]
    _fully_reclaimed(eng, prefix=False)


def test_preemption_victim_is_lowest_priority(families):
    prompts = _prompts((6, 6, 6), seed=7)

    def requests(Req):                    # rid 0 is the designated victim
        return [Req(rid=i, prompt=p, max_new_tokens=16, priority=prio)
                for i, (p, prio) in enumerate(zip(prompts, (0, 3, 3)))]
    ref, eng = _pair(families, n_slots=2, max_len=48, kv_layout="paged",
                     block_size=8, max_seqs=4, n_blocks=8, policy="priority",
                     preemption=True, prefix_caching=False)
    serve_workload_j(ref, requests(RequestJ))
    responses = {r.rid: r for r in serve_workload(eng,
                                                  requests(InferenceRequest))}
    _matches_reference(ref, eng, ref.stats(), eng.stats())
    assert eng.stats()["preemptions"] >= 1
    assert responses[0].preemptions >= 1, "low-priority victim swaps out"
    assert responses[0].preemptions >= \
        responses[1].preemptions + responses[2].preemptions


# =============================================================================
# pipelined loop through preemption (the reference's
# test_decode_hotpath.py:124)
# =============================================================================
def test_pipelined_parity_preemption_and_partial_swapin(families):
    """An overcommitted arena forces decode-time preemption (staged
    swap-out, partial swap-in through the radix tree) while in-flight
    pipelined work must land before every victim snapshot: the pipelined
    loop equals the synchronous one, and each equals the reference's."""
    rng = np.random.default_rng(5)
    pre = rng.integers(0, CFG.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, CFG.vocab_size, size=6)
                               .astype(np.int32)]) for _ in range(4)]
    kw = dict(n_slots=4, max_len=48, kv_layout="paged", block_size=8,
              max_seqs=4, n_blocks=14, preemption=True)
    engines = {}
    for pipe in (True, False):
        ref, eng = _pair(families, decode_pipeline=pipe, **kw)
        m_ref = ref._serve_prompts(prompts, n_new=16)
        m = eng._serve_prompts(prompts, n_new=16)
        _matches_reference(ref, eng, m_ref, m)
        assert m["preemptions"] >= 1
        assert m["swapin_pages_copied"] + m["partial_swapin_pages_saved"] >= 1
        _fully_reclaimed(eng, prefix=True)
        engines[pipe] = eng
    _same_outputs(engines[True], engines[False])


# =============================================================================
# partial swap-in (the reference's test_forecast_serving.py:240)
# =============================================================================
def test_partial_swapin_restores_fewer_pages_token_identical(families):
    """4 sequences x ceil(38/8) = 5 blocks at completion on 13 allocatable
    blocks: the shared two-block preamble stays pinned by the survivors,
    so a victim's resume re-acquires it from the radix tree and copies back
    only its tail."""
    prompts = _preamble_prompts()
    kw = dict(n_slots=2, max_len=64, kv_layout="paged", block_size=8,
              max_seqs=4)
    plain = _port(families, n_blocks=41, **kw)
    assert plain._serve_prompts(prompts, n_new=16)["preemptions"] == 0
    ref, eng = _pair(families, n_blocks=14, preemption=True, **kw)
    m_ref = ref._serve_prompts(prompts, n_new=16)
    m = eng._serve_prompts(prompts, n_new=16)
    _matches_reference(ref, eng, m_ref, m)
    _same_outputs(plain, eng)
    full_pages = m["swapin_pages_copied"] + m["partial_swapin_pages_saved"]
    assert m["preemptions"] >= 1 and full_pages > 0
    assert m["partial_swapin_pages_saved"] >= 1
    assert m["swapin_pages_copied"] < full_pages
    eng.instances[0].alloc.check()


# =============================================================================
# holds + partial swap-ins (the reference's test_forecast_serving.py:281)
# =============================================================================
def _hold_policy(pkg, flag):
    """A forecast policy that holds deferrable work while the grid is
    dirty: the nowcast is 500 g/kWh until ``flag`` is set (then 50), and
    the forecast always shows a 50 g/kWh valley a second ahead.  The flag
    is set by a token callback, so the hold ends at the same tick on both
    engines (a wall-clock end would move with each package's speed)."""
    def ci_fn(now=None, horizon_s=0.0):
        return 50.0 if flag or horizon_s >= 1.0 else 500.0
    return pkg.CarbonForecastPolicy(ci_fn, horizon_s=2.0, step_s=0.05,
                                    ci_threshold=200.0)


def test_attribution_exact_with_holds_and_partial_swapins(families):
    """A forecast hold parks deferrable work while interactive requests
    preempt each other on an overcommitted arena; the grid cleans when rid
    0 has streamed 6 tokens and the held work flows in beside the rest.
    Per-request joules still sum to the session total, carbon follows the
    intensity, and the held request's queue delay runs from arrival."""
    prompts = _preamble_prompts(n=4, seed=7)
    ci = 410.0
    runs = {}
    for pkg, POL, Req in (("ref", POLJ, RequestJ),
                          ("port", POLT, InferenceRequest)):
        flag = []
        seen = []

        def on_tok(rid, tok, seen=seen, flag=flag):
            seen.append(rid)
            if seen.count(0) == 6:
                flag.append(True)
        reqs = [Req(rid=i, prompt=p, max_new_tokens=16, slo=INTERACTIVE,
                    priority=1, on_token=on_tok)
                for i, p in enumerate(prompts[:3])]
        reqs.append(Req(rid=3, prompt=prompts[3], max_new_tokens=16,
                        slo=DEFERRABLE, priority=0, deadline_s=30.0,
                        on_token=on_tok))
        runs[pkg] = (reqs, _hold_policy(POL, flag))
    kw = dict(n_slots=2, max_len=64, kv_layout="paged", block_size=8,
              max_seqs=4, n_blocks=14, preemption=True, ci_g_per_kwh=ci)
    ref = ENGJ.RealEngine(families[0], policy=runs["ref"][1], **kw)
    ref.configure(CGJ.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    eng = _port(families, policy=runs["port"][1], **kw)
    serve_workload_j(ref, runs["ref"][0])
    responses = {r.rid: r for r in serve_workload(eng, runs["port"][0])}
    m = eng.stats()
    _matches_reference(ref, eng, ref.stats(), m)
    assert m["served"] == 4
    assert m["preemptions"] >= 1, "want swap churn under the hold"
    held = responses[3]
    assert held.held_s > 0.0 and held.release_reason == "threshold"
    assert held.queue_delay_s >= held.held_s
    assert {r.rid: r.release_reason for r in ref.last_responses} == \
        {r.rid: r.release_reason for r in responses.values()}
    total_j = sum(r.energy_j for r in responses.values())
    assert total_j == pytest.approx(m["energy_j"], rel=1e-9)
    assert sum(r.carbon_g for r in responses.values()) == pytest.approx(
        m["energy_j"] / 3.6e6 * ci, rel=1e-9)
