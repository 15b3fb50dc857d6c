"""The port's slotted serving path against the reference's, at SMOKE size on
the CPU, with the reference's weights carried across by
``models/bridge.py``: one-pass prefill and batched slot decode against the
reference's model functions (logits within 2e-4, f32 sums in another
order, and equal greedy tokens), and ``RealEngine(kv_layout="slotted")``
against the reference's slotted engine (equal token streams and counters),
with the engine's own invariants — FIFO admission, slot isolation, warm
reconfiguration, warmup covering every bucket, batched ``generate``, the
quality ladder, paged equal to slotted, and per-request joules summing to
the session total."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import config_graph as CGJ
from repro.models import registry as RJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import config_graph as CGT
from repro_torch.core import perf_model as PM
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.serving import engine as ENG
from repro_torch.serving.api import InferenceRequest

CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=4, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE.with_(n_layers=4)
TOL = 2e-4


@pytest.fixture(scope="module")
def params():
    """(reference params, the same weights in the port's model)."""
    p_j = RJ.init_params(jax.random.PRNGKey(0), CFG)
    model = RT.init_params(CFG_T, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    return p_j, model


@pytest.fixture(scope="module")
def families():
    """(reference family, port family with the same weights): the x0.5 and
    x1 rungs of the 4-layer ladder."""
    fam_j = ENGJ.build_engine_family(CFG, fracs=(1.0, 0.5))
    fam_t = ENG.build_engine_family(CFG_T, fracs=(1.0, 0.5), device="cpu")
    for ev_j, ev_t in zip(fam_j, fam_t):
        assert ev_j.variant.name == ev_t.variant.name
        bridge.load_reference(ev_t.params, _flatten(ev_j.params))
    return fam_j, fam_t


@pytest.fixture(scope="module")
def family(families):
    return families[1]


def _graph(spec=None, cg=CGT):
    return cg.ConfigGraph.from_dict(CFG.name, spec or {("x1", 16): 1})


def _prompts(n, length=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=(1, length)).astype(np.int32)
            for _ in range(n)]


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


def _engine(family, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    eng = ENG.RealEngine(family, kv_layout="slotted", device="cpu", **kw)
    eng.configure(_graph())
    return eng


def _assert_same_outputs(a, b):
    assert set(a.last_outputs) == set(b.last_outputs)
    for rid in a.last_outputs:
        np.testing.assert_array_equal(a.last_outputs[rid],
                                      b.last_outputs[rid])


# =============================================================================
# model: one-pass prefill and batched slot decode
# =============================================================================
def test_prefill_kv_matches_forward_logits(params):
    """One-pass prefill reproduces the reference's full forward and the
    reference's ``prefill_kv`` — logits and every layer's K/V."""
    p_j, model = params
    toks = np.random.default_rng(2).integers(
        0, CFG.vocab_size, size=(2, 8)).astype(np.int32)
    ref, _ = RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, CFG)
    lg_j, k_j, v_j = RJ.prefill_kv(p_j, {"tokens": jnp.asarray(toks)}, CFG)
    lg, k_all, v_all = RT.prefill_kv(model, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), rtol=TOL,
                               atol=TOL)
    assert k_all.shape == (CFG.n_layers, 2, 8, CFG.n_kv_heads, CFG.d_head)
    np.testing.assert_allclose(k_all.numpy(), np.asarray(k_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(v_all.numpy(), np.asarray(v_j), rtol=TOL,
                               atol=TOL)


def _write_slot_j(cache, k_all, v_all, slot, true_len):
    s = k_all.shape[2]
    return {"k": cache["k"].at[:, slot, :s].set(k_all[:, 0]),
            "v": cache["v"].at[:, slot, :s].set(v_all[:, 0]),
            "lengths": cache["lengths"].at[slot].set(true_len)}


def _write_slot_t(cache, k_all, v_all, slot, true_len):
    s = k_all.shape[2]
    cache["k"][:, slot, :s] = k_all[:, 0]
    cache["v"][:, slot, :s] = v_all[:, 0]
    cache["lengths"][slot] = true_len


def _sequential_reference(p_j, row_toks, n_new):
    """Greedy continuation logits via the reference's scalar-position
    decode path (no slots)."""
    cache = RJ.make_cache(p_j, CFG, 1, row_toks.shape[1] + n_new,
                          dtype=jnp.float32)
    for t in range(row_toks.shape[1]):
        lg, cache = RJ.decode_step(p_j, cache,
                                   {"tokens": row_toks[:, t:t + 1]}, CFG)
    outs = []
    nxt = jnp.argmax(lg, -1)[:, None]
    for _ in range(n_new):
        lg, cache = RJ.decode_step(p_j, cache, {"tokens": nxt}, CFG)
        outs.append(lg)
        nxt = jnp.argmax(lg, -1)[:, None]
    return np.asarray(jnp.stack(outs, 1))


def test_batched_decode_matches_sequential_reference_per_slot(params):
    """Slots of different lengths decode exactly what the per-request
    sequential path decodes — a free slot riding along — and a slot
    admitted mid-flight reproduces its own sequential reference; every
    step also matches the reference's ``decode_slots``."""
    p_j, model = params
    S = 8
    toks = np.random.default_rng(1).integers(
        0, CFG.vocab_size, size=(2, S)).astype(np.int32)
    cache_j = RJ.make_slot_cache(CFG, 3, S + 6, dtype=jnp.float32)
    cache_t = RT.make_slot_cache(CFG_T, 3, S + 6, dtype=torch.float32,
                                 device="cpu")
    firsts = []
    for slot, row in ((0, toks[:1]), (2, toks[1:, :5])):
        lg_j, k_j, v_j = RJ.prefill_kv(p_j, {"tokens": jnp.asarray(row)}, CFG)
        cache_j = _write_slot_j(cache_j, k_j, v_j, slot, row.shape[1])
        lg_t, k_t, v_t = RT.prefill_kv(model, {"tokens": torch.tensor(row)})
        _write_slot_t(cache_t, k_t, v_t, slot, row.shape[1])
        firsts.append(int(lg_t[0, -1].argmax()))
        assert firsts[-1] == int(jnp.argmax(lg_j[0, -1]))
    refA = _sequential_reference(p_j, jnp.asarray(toks[:1]), 3)
    refB = _sequential_reference(p_j, jnp.asarray(toks[1:, :5]), 3)

    active = np.array([True, False, True])
    nxt = np.array([[firsts[0]], [0], [firsts[1]]], np.int32)
    outs = []
    for _ in range(3):
        lg_j, cache_j = RJ.decode_slots(p_j, cache_j,
                                        {"tokens": jnp.asarray(nxt)}, CFG,
                                        jnp.asarray(active))
        lg_t, cache_t = RT.decode_slots(model, cache_t,
                                        {"tokens": torch.tensor(nxt)},
                                        torch.tensor(active))
        np.testing.assert_allclose(lg_t.numpy()[active],
                                   np.asarray(lg_j)[active], rtol=TOL,
                                   atol=TOL)
        outs.append(lg_t.numpy())
        nxt = np.where(active, lg_t.numpy().argmax(-1), 0)[:, None].astype(
            np.int32)
    dec = np.stack(outs, 1)
    np.testing.assert_allclose(dec[0], refA[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dec[2], refB[0], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                  np.asarray(cache_j["lengths"]))

    # mid-flight admission into the free slot
    row = toks[1:, :6]
    lgC, kC, vC = RT.prefill_kv(model, {"tokens": torch.tensor(row)})
    _write_slot_t(cache_t, kC, vC, 1, 6)
    refC = _sequential_reference(p_j, jnp.asarray(row), 2)
    active = np.array([True, True, True])
    nxt = dec[:, -1].argmax(-1)[:, None].astype(np.int32)
    nxt[1, 0] = int(lgC[0, 5].argmax())
    outs2 = []
    for _ in range(2):
        lg_t, cache_t = RT.decode_slots(model, cache_t,
                                        {"tokens": torch.tensor(nxt)},
                                        torch.tensor(active))
        outs2.append(lg_t.numpy())
        nxt = lg_t.numpy().argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_allclose(np.stack(outs2, 1)[1], refC[0], rtol=TOL,
                               atol=TOL)


def test_decode_slots_drops_the_write_of_a_full_slot(params):
    """A slot whose length equals the cache size writes nothing (the
    reference's ``mode="drop"`` scatter) and attends over the whole row;
    the other slots decode as the reference's."""
    p_j, model = params
    S = 12
    rng = np.random.default_rng(4)
    kv = {key: rng.standard_normal((CFG.n_layers, 3, S, CFG.n_kv_heads,
                                    CFG.d_head)).astype(np.float32) * 0.3
          for key in ("k", "v")}
    lengths = np.array([5, S, 9], np.int32)
    active = np.array([True, False, True])
    nxt = rng.integers(0, CFG.vocab_size, size=(3, 1)).astype(np.int32)
    cache_j = {"k": jnp.asarray(kv["k"]), "v": jnp.asarray(kv["v"]),
               "lengths": jnp.asarray(lengths)}
    cache_t = {"k": torch.tensor(kv["k"]), "v": torch.tensor(kv["v"]),
               "lengths": torch.tensor(lengths)}
    lg_j, new_j = RJ.decode_slots(p_j, cache_j, {"tokens": jnp.asarray(nxt)},
                                  CFG, jnp.asarray(active))
    lg_t, new_t = RT.decode_slots(model, cache_t,
                                  {"tokens": torch.tensor(nxt)},
                                  torch.tensor(active))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=TOL,
                               atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_array_equal(new_t[key][:, 1].numpy(), kv[key][:, 1])
        np.testing.assert_allclose(new_t[key].numpy(), np.asarray(new_j[key]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(new_t["lengths"].numpy(), [6, S, 10])


def test_slotted_cache_refuses_unported_families():
    """The slot cache refuses SSM, enc-dec, the VLM family and M-RoPE, as
    the reference's ``supports_slots`` does, and serves MoE (ported)."""
    for kw in ({"family": "ssm"}, {"n_enc_layers": 2}, {"family": "vlm"},
               {"mrope_sections": (2, 3, 3)}):
        cfg = CFG_T.with_(**kw)
        assert not RT.supports_slots(cfg)
        with pytest.raises((AssertionError, NotImplementedError)):
            RT.make_slot_cache(cfg, 2, 16, device="cpu")
    cfg = CFG_T.with_(family="moe", n_experts=4, top_k=2, d_expert_ff=32)
    assert RT.supports_slots(cfg)
    cache = RT.make_slot_cache(cfg, 2, 16, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                cfg.d_head)


# =============================================================================
# engine: parity with the reference's slotted engine
# =============================================================================
def test_slotted_engine_matches_reference_engine(families):
    """The acceptance gate: on mixed prompt lengths the port's slotted
    engine reproduces the reference's greedy outputs exactly, with the
    same admission order and the same sync / transfer / dispatch
    counters."""
    fam_j, fam_t = families
    prompts = _mixed_prompts(CFG.vocab_size)
    ref = ENGJ.RealEngine(fam_j, n_slots=2, max_len=48)
    ref.configure(_graph(cg=CGJ))
    m_ref = ref._serve_prompts(prompts, n_new=6)
    eng = _engine(fam_t, max_len=48)
    m = eng._serve_prompts(prompts, n_new=6)
    _assert_same_outputs(ref, eng)
    assert ref.last_admit_order == eng.last_admit_order
    for key in ("served", "tokens", "decode_steps", "decode_dispatches",
                "h2d_transfers", "host_syncs", "compile_retraces",
                "prefill_chunks", "prefix_hit_tokens", "blocks_peak"):
        assert m[key] == m_ref[key], key
    # the synchronous loop's freight: one sync per admission and per step
    assert m["host_syncs"] == len(prompts) + m["decode_steps"]
    assert m["h2d_transfers"] == len(prompts) + 2 * m["decode_steps"]


def test_slotted_layout_refuses_a_model_of_another_type():
    fam = ENG.build_engine_family(qwen3_1_7b.SMOKE.with_(
        dtype=torch.bfloat16), fracs=(1.0,), device="cpu")
    eng = ENG.RealEngine(fam, device="cpu")
    with pytest.raises(ValueError, match="f32"):
        eng.configure(_graph())


# =============================================================================
# engine: admission, warm reconfiguration, generate (test_engine.py)
# =============================================================================
def test_continuous_batching_fifo_admission(family):
    """Mid-flight admission preserves FIFO fairness: requests enter slots in
    submission order, every request completes, occupancy stays high."""
    eng = _engine(family)
    m = eng._serve_prompts(_prompts(5), n_new=4)
    assert eng.last_admit_order == [0, 1, 2, 3, 4]
    assert m["served"] == 5
    assert m["tokens"] == 20
    assert 0.0 < m["mean_occupancy"] <= 1.0
    assert m["p95_s"] >= m["p50_s"] > 0
    assert m["energy_j"] > 0
    assert m["decode_steps"] >= 6       # the 5th admits after a completion
    assert all(len(t) == 4 for t in eng.last_outputs.values())
    assert sorted(eng.last_latencies) == sorted(
        r.latency_s for r in eng.last_responses)


def test_slot_isolation_outputs_independent_of_slot_count(family):
    """Greedy outputs are a property of the request, not of who shares the
    batch: n_slots=1 (pure sequential) and n_slots=4 agree token for
    token."""
    prompts = _prompts(4, seed=5)
    outs = {}
    for n_slots in (1, 4):
        eng = _engine(family, n_slots=n_slots)
        eng._serve_prompts(prompts, n_new=4)
        outs[n_slots] = dict(eng.last_outputs)
    for rid in range(4):
        np.testing.assert_array_equal(outs[1][rid], outs[4][rid])


def test_warm_configure_identical_outputs_and_faster(family):
    """Reconfiguring back to a previous graph reuses pooled instances: much
    faster than cold, token-identical, and the seconds are kept as
    ``last_reconfig_s``."""
    eng = ENG.RealEngine(family, n_slots=2, max_len=32, device="cpu")
    g1 = _graph({("x0.5", 8): 1, ("x1", 8): 1})
    g2 = _graph({("x1", 16): 1})
    t_cold = eng.configure(g1)
    assert eng.last_reconfig_s == t_cold
    prompts = _prompts(6, seed=7)
    eng._serve_prompts(prompts, n_new=4)
    cold_out = dict(eng.last_outputs)
    eng.configure(g2)                      # move away ...
    t_warm = eng.configure(g1)             # ... and warm-return
    eng._serve_prompts(prompts, n_new=4)
    assert set(cold_out) == set(eng.last_outputs)
    for rid, toks in cold_out.items():
        np.testing.assert_array_equal(toks, eng.last_outputs[rid])
    assert t_warm < t_cold / 10, (t_warm, t_cold)
    assert eng.last_reconfig_s == t_warm


def test_warmup_covers_every_serve_bucket_no_recompiles(family):
    """``warmup`` runs EXACTLY the shapes the serve loop can reach
    (``serve_buckets``, a non-power-of-two max_len's top bucket included):
    serving a prompt at every bucket adds no shape key and no retrace."""
    eng = ENG.RealEngine(family, n_slots=2, max_len=42, device="cpu")
    eng.configure(_graph())
    assert ENG.serve_buckets(42) == [8, 16, 32, 64]
    inst = eng.instances[0]
    before = set(inst._shapes)
    assert before == {("prefill", b) for b in (8, 16, 32, 64)} | {("decode",)}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, size=(1, n)).astype(np.int32)
               for n in (3, 8, 13, 27, 41)]              # one per bucket
    m = eng._serve_prompts(prompts, n_new=1)
    assert m["compile_retraces"] == 0 and inst._shapes == before
    assert m["served"] == 5 and m["decode_steps"] == 0


def test_generate_batched_rows_decode_their_own_argmax(family):
    """Each row of a batched prompt matches its own single-row
    generation (argmax per row, not broadcast from row 0)."""
    inst = ENG.Instance(family[1], 8, n_slots=2, max_len=32)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, CFG.vocab_size, size=(3, 6)).astype(np.int32)
    batched, _ = inst.generate(prompt, n_new=5)
    assert batched.shape == (3, 5)
    for i in range(3):
        single, _ = inst.generate(prompt[i:i + 1], n_new=5)
        np.testing.assert_array_equal(batched[i], single[0])
    assert not (batched[0] == batched[1]).all() \
        or not (batched[0] == batched[2]).all()


def test_generate_matches_reference_generate(families):
    fam_j, fam_t = families
    prompt = np.random.default_rng(12).integers(
        0, CFG.vocab_size, size=(2, 7)).astype(np.int32)
    want, _ = ENGJ.Instance(fam_j[1], 8, n_slots=2,
                            max_len=32).generate(prompt, n_new=6)
    got, _ = ENG.Instance(fam_t[1], 8, n_slots=2,
                          max_len=32).generate(prompt, n_new=6)
    np.testing.assert_array_equal(got, want)


def test_engine_real_generation_quality_ladder():
    """Deeper variants are measurably slower (test_serving.py's ladder
    test on the port)."""
    base = qwen3_1_7b.SMOKE.with_(n_layers=8)
    fam = ENG.build_engine_family(base, fracs=(1.0, 0.25), device="cpu")
    eng = ENG.RealEngine(fam, device="cpu")
    eng.configure(CGT.ConfigGraph.from_dict(base.name, {("x0.25", 8): 1,
                                                        ("x1", 8): 1}))
    prompts = [np.array([[1, 2, 3, 4]], dtype=np.int32) for _ in range(4)]
    m = eng._serve_prompts(prompts, n_new=4)
    assert m["served"] == 4 and m["p95_s"] > 0 and m["energy_j"] > 0
    i_small = ENG.Instance(fam[0], 8, max_len=64)
    i_big = ENG.Instance(fam[1], 8, max_len=64)
    n_new = 32
    i_small.generate(prompts[0], n_new)
    i_big.generate(prompts[0], n_new)
    # best of 5, the two variants timed in turn so that a burst of load
    # from other processes falls on both alike
    times = [(i_small.generate(prompts[0], n_new)[1],
              i_big.generate(prompts[0], n_new)[1]) for _ in range(5)]
    t_small = min(t for t, _ in times)
    t_big = min(t for _, t in times)
    assert t_big > t_small, (t_big, t_small)


def test_paged_engine_matches_slotted_token_for_token(family):
    """Within the port: on mixed prompt lengths with a shared prefix the
    paged engine reproduces the slotted engine's greedy outputs exactly,
    while admitting more concurrency than slots would allow."""
    prompts = _mixed_prompts(CFG.vocab_size)
    slotted = _engine(family, max_len=48)
    slotted._serve_prompts(prompts, n_new=6)
    paged = ENG.RealEngine(family, n_slots=2, max_len=48, kv_layout="paged",
                           block_size=8, max_seqs=6, device="cpu")
    paged.configure(_graph())
    m = paged._serve_prompts(prompts, n_new=6)
    _assert_same_outputs(slotted, paged)
    assert m["prefix_hit_tokens"] > 0
    assert m["prefill_chunks"] >= len(prompts)
    assert paged.last_admit_order == sorted(paged.last_admit_order)


# =============================================================================
# engine: energy attribution and streaming at admission
# =============================================================================
def test_joules_conserved_with_streaming_and_single_token_requests(family):
    """The slotted layout prefills at admission: its first token streams
    through ``on_token`` at once, an ``n_new == 1`` request completes
    there, and per-request joules (prefill charged at admission included)
    sum to the session total; carbon follows the intensity."""
    eng = _engine(family, n_slots=2, ci_g_per_kwh=400.0)
    seen = {}
    lens = (1, 5, 1, 3, 2, 1)
    for rid, (p, n) in enumerate(zip(_prompts(len(lens), seed=9), lens)):
        eng.submit(InferenceRequest(
            rid=rid, prompt=p, max_new_tokens=n,
            on_token=lambda r, t: seen.setdefault(r, []).append(t)))
    resps = eng.drain()
    m = eng.stats()
    assert m["served"] == len(lens) and m["tokens"] == sum(lens)
    for rid, n in enumerate(lens):
        assert len(eng.last_outputs[rid]) == n
        assert seen[rid] == list(eng.last_outputs[rid])
    assert sum(r.energy_j for r in resps) == pytest.approx(m["energy_j"],
                                                           rel=1e-12)
    assert sum(r.carbon_g for r in resps) == pytest.approx(m["carbon_g"],
                                                           rel=1e-12)
    assert m["host_syncs"] == len(lens) + m["decode_steps"]


def test_prefill_seconds_are_charged_to_the_request(family, monkeypatch):
    """The (state, seconds) that admission returns is charged at busy
    power into the session, the request's meter and the instance's
    accounted time: with admission reporting 1 s per prefill, every
    request carries at least its prefill's joules, and no idle floor is
    charged for that time."""
    real = ENG.Instance.admit_next

    def slow_admit(self, *a, **kw):
        state, _ = real(self, *a, **kw)
        return state, 1.0

    monkeypatch.setattr(ENG.Instance, "admit_next", slow_admit)
    eng = _engine(family, n_slots=2)
    m = eng._serve_prompts(_prompts(3, seed=2), n_new=1)
    e_pf = 16 * PM.P_BUSY_W * 1.0
    assert m["served"] == 3 and m["decode_steps"] == 0
    assert all(r.energy_j >= e_pf for r in eng.last_responses)
    assert m["energy_j"] == pytest.approx(3 * e_pf, rel=1e-12)
