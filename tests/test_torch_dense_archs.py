"""The rest of the dense family on the port — gemma3-27b (5:1 local/global
attention, window 8 at SMOKE, two rotary bases, qk-norm), glm4-9b (partial
rotary, QKV bias) and qwen2-0.5b (QKV bias, tied embedding, g = 7) — against
the reference at SMOKE size on the CPU, with the reference's weights carried
across by ``models/bridge.py`` (biases and norm scales drawn at random first,
so that they matter).  A fourth variant, glm4 SMOKE with 16 query heads over
one KV head, is the query group of 16 rows that the decode kernels cut into
row-chunks on the card.

Held to the reference: the layer pattern and rotary tables (depth-reduced
rungs included), ``registry.forward`` and the ``make_cache`` /
``decode_step`` replay, the slotted and paged entry points on prompts longer
than gemma3 SMOKE's window, both engines' greedy streams (against the
reference model's) and counters (against the reference engine's), the
windowed plain decode versions, and the bridge's round trip.  Tolerance:
logits within 2e-4 (f32, sums in another order), tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.core import config_graph as CGJ
from repro.models import layers as LJ
from repro.models import registry as RJ
from repro.models import transformer as TJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import config_graph as CGT
from repro_torch.kernels import ref as REFT
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as ENG

ARCHS = ("gemma3-27b", "glm4-9b", "qwen2-0.5b")
# (arch, SMOKE overrides): the three SMOKE configs and glm4's with g = 16
VARIANTS = [(a, {}) for a in ARCHS] + [
    ("glm4-9b", {"n_heads": 16, "n_kv_heads": 1, "d_head": 16})]
TOL = 2e-4


def _ids(variant):
    arch, kw = variant
    return arch + ("-g16" if kw else "")


def _configs(variant):
    arch, kw = variant
    return (get_smoke_config_j(arch).with_(**kw),
            get_smoke_config(arch).with_(**kw))


def _randomize(p_j, seed: int):
    """The reference's params with every bias and norm scale drawn at
    random (their init is zeros and ones, which would hide a dropped bias
    or norm)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1])
        if "'b'" in name or "'scale'" in name:
            return leaf + jnp.asarray(
                0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, p_j)


@pytest.fixture(scope="module", params=VARIANTS, ids=_ids)
def setup(request):
    """(reference config, port config, reference params, the same weights
    in the port's model)."""
    cfg_j, cfg_t = _configs(request.param)
    p_j = _randomize(RJ.init_params(jax.random.PRNGKey(0), cfg_j), 1)
    model = RT.init_params(cfg_t, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    return cfg_j, cfg_t, p_j, model


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


# =============================================================================
# layer pattern, rotary tables, bridge
# =============================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_pattern_and_rope_tables_match_reference(arch):
    """Windows, global flags and both rotary tables equal the reference's
    for FULL, SMOKE and depth-reduced rungs (a rung's pattern comes from
    its own n_layers, as the reference's ``build_engine_family`` gives it
    one)."""
    fam = ENG.build_engine_family(get_smoke_config(arch), fracs=(0.5, 1.0),
                                  device="cpu")
    pairs = [(get_config_j(arch), get_config(arch)),
             (get_smoke_config_j(arch), get_smoke_config(arch))]
    pairs += [(get_smoke_config_j(arch).with_(n_layers=ev.cfg.n_layers),
               ev.cfg) for ev in fam]
    for n in (1, 7, 13, 31):
        pairs.append((get_config_j(arch).with_(n_layers=n),
                      get_config(arch).with_(n_layers=n)))
    for cfg_j, cfg_t in pairs:
        for got, want in zip(TT.layer_pattern(cfg_t),
                             TJ.layer_pattern(cfg_j)):
            np.testing.assert_array_equal(got, want)
        pos = np.array([0, 1, 7, 8, 1023, 1024, 4095], np.int32)
        for lg in (0, 1):
            for i in (0, 1):
                got = TT._rope_tables(cfg_t, torch.tensor(pos))[lg][i]
                want = TJ._rope_tables(cfg_j, jnp.asarray(pos))[lg][i]
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
    windows, is_global = TT.layer_pattern(get_config(arch))
    if arch == "gemma3-27b":
        assert is_global.sum() == 10 and set(windows) == {0, 1024}
        assert list(TT.layer_pattern(fam[0].cfg)[1]) == [False] * 3
    else:
        assert is_global.all() and not windows.any()


def test_bridge_round_trips_every_leaf(setup):
    """Every leaf of the reference's params lands in the port's model and
    comes back unchanged: QKV biases (glm4, qwen2), q/k norms (gemma3) and
    the untied LM head (gemma3, glm4)."""
    cfg_j, cfg_t, p_j, model = setup
    want = _flatten(p_j)
    got = bridge.export_reference(model)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    names = set(want)
    assert ("layers/attn/wq/b" in names) == cfg_t.qkv_bias
    assert ("layers/attn/q_norm/scale" in names) == cfg_t.qk_norm
    assert ("lm_head/w" in names) == (not cfg_t.tie_embeddings)


# =============================================================================
# generic entry points
# =============================================================================
def test_forward_matches_reference(setup):
    """``registry.forward`` logits over 2 prompts of 19 tokens (past
    gemma3 SMOKE's window of 8)."""
    cfg_j, cfg_t, p_j, model = setup
    toks = _tokens(cfg_t, 5, (2, 19))
    want, _ = RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j)
    got, aux = RT.forward(model, {"tokens": torch.tensor(toks)}, cfg_t)
    assert got.shape == (2, 19, cfg_t.padded_vocab) and float(aux) == 0.0
    _close(got, want)
    hidden, _ = RT.forward(model, {"tokens": torch.tensor(toks)}, cfg_t,
                           return_hidden=True)
    _close(hidden, RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j,
                              return_hidden=True)[0])


def test_decode_step_replay_matches_reference(setup):
    """``make_cache`` / ``decode_step``: a 19-token replay and 3 greedy
    steps, logits held to the reference's at every step; the replay's last
    logits equal the forward's."""
    cfg_j, cfg_t, p_j, model = setup
    toks = _tokens(cfg_t, 6, (2, 19))
    cache_j = RJ.make_cache(p_j, cfg_j, 2, 24, dtype=jnp.float32)
    cache_t = RT.make_cache(model, cfg_t, 2, 24, dtype=torch.float32,
                            device="cpu")
    assert set(cache_t) == set(cache_j)
    step_j = jax.jit(lambda p, c, t: RJ.decode_step(p, c, {"tokens": t},
                                                    cfg_j))
    col = toks[:, :1]
    for i in range(22):
        lg_j, cache_j = step_j(p_j, cache_j, jnp.asarray(col))
        lg_t, cache_t = RT.decode_step(model, cache_t,
                                       {"tokens": torch.tensor(col)}, cfg_t)
        _close(lg_t, lg_j)
        if i == 18:
            fwd = RT.forward(model, {"tokens": torch.tensor(toks)},
                             cfg_t)[0][:, -1]
            _close(lg_t, fwd.numpy())
        col = (toks[:, i + 1:i + 2] if i + 1 < 19
               else lg_t.argmax(-1, keepdim=True).to(torch.int32).numpy())
    assert int(cache_t["pos"]) == int(cache_j["pos"]) == 22
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key])


# =============================================================================
# slotted and paged entry points
# =============================================================================
def test_prefill_kv_and_decode_slots_match_reference(setup):
    """One-pass prefill of prompts of 13 and 10 tokens into two slots, then
    4 batched slot decodes with greedy feedback: logits, K/V and lengths
    against the reference's."""
    cfg_j, cfg_t, p_j, model = setup
    cache_j = RJ.make_slot_cache(cfg_j, 2, 32, dtype=jnp.float32)
    cache_t = RT.make_slot_cache(cfg_t, 2, 32, dtype=torch.float32,
                                 device="cpu")
    nxt = np.zeros((2, 1), np.int32)
    for slot, n in enumerate((13, 10)):
        toks = _tokens(cfg_t, 7 + slot, (1, n))
        lg_j, k_j, v_j = RJ.prefill_kv(p_j, {"tokens": jnp.asarray(toks)},
                                       cfg_j)
        lg_t, k_t, v_t = RT.prefill_kv(model, {"tokens": torch.tensor(toks)})
        _close(lg_t, lg_j)
        _close(k_t, k_j)
        _close(v_t, v_j)
        cache_j["k"] = cache_j["k"].at[:, slot, :n].set(k_j[:, 0])
        cache_j["v"] = cache_j["v"].at[:, slot, :n].set(v_j[:, 0])
        cache_j["lengths"] = cache_j["lengths"].at[slot].set(n)
        cache_t["k"][:, slot, :n] = k_t[:, 0]
        cache_t["v"][:, slot, :n] = v_t[:, 0]
        cache_t["lengths"][slot] = n
        nxt[slot, 0] = int(lg_t[0, -1].argmax())
    active = np.array([True, True])
    for _ in range(4):
        lg_j, cache_j = RJ.decode_slots(p_j, cache_j,
                                        {"tokens": jnp.asarray(nxt)}, cfg_j,
                                        jnp.asarray(active))
        lg_t, cache_t = RT.decode_slots(model, cache_t,
                                        {"tokens": torch.tensor(nxt)},
                                        torch.tensor(active))
        _close(lg_t, lg_j)
        nxt = lg_t.argmax(-1, keepdim=True).to(torch.int32).numpy()
        assert (nxt[:, 0] == np.asarray(jnp.argmax(lg_j, -1))).all()
    np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                  np.asarray(cache_j["lengths"]))
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key])


def _prefill_both(setup, toks, bs=4, C=8):
    """Chunked prefill of ``toks`` through both packages' paged arenas
    (table [1..6]); returns (jax arena, port arena, last logits of each)."""
    cfg_j, cfg_t, p_j, model = setup
    n = toks.shape[1]
    arena_j = RJ.make_block_arena(cfg_j, 16, bs, dtype=jnp.float32)
    arena_t = RT.make_block_arena(cfg_t, 16, bs, dtype=torch.float32,
                                  device="cpu")
    table = np.array([1, 2, 3, 4, 5, 6, 0, 0], np.int32)
    n_past = 0
    while n_past < n:
        true_c = min(C, n - n_past)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :true_c] = toks[0, n_past:n_past + true_c]
        lg_j, arena_j = RJ.prefill_paged(p_j, {"tokens": jnp.asarray(chunk)},
                                         cfg_j, arena_j, jnp.asarray(table),
                                         n_past, true_c)
        lg_t = RT.prefill_paged(model, {"tokens": torch.tensor(chunk)},
                                arena_t, torch.tensor(table), n_past, true_c)
        _close(lg_t[0, :true_c], lg_j[0, :true_c])
        n_past += true_c
    return arena_j, arena_t, lg_t[0, true_c - 1]


def test_paged_prefill_and_decode_match_reference(setup):
    """Chunked paged prefill of a 19-token prompt (chunks of 8 over blocks
    of 4: the window's edge crosses chunk and block boundaries), its last
    logits against the reference's full forward, then 4 paged decode steps
    with inactive rows riding along, logits and arena against the
    reference's."""
    cfg_j, cfg_t, p_j, model = setup
    toks = _tokens(cfg_t, 11, (1, 19))
    arena_j, arena_t, last = _prefill_both(setup, toks)
    ref, _ = RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j)
    _close(last, ref[0, 18])
    tables = np.zeros((3, 8), np.int32)
    tables[1] = [1, 2, 3, 4, 5, 6, 0, 0]
    lengths = np.array([0, 19, 0], np.int32)
    active = np.array([False, True, False])
    nxt = np.zeros((3, 1), np.int32)
    nxt[1, 0] = int(last.argmax())
    for _ in range(4):
        lg_j, arena_j = RJ.decode_paged(p_j, arena_j,
                                        {"tokens": jnp.asarray(nxt)}, cfg_j,
                                        jnp.asarray(tables),
                                        jnp.asarray(lengths),
                                        jnp.asarray(active))
        lg_t = RT.decode_paged(model, arena_t, {"tokens": torch.tensor(nxt)},
                               torch.tensor(tables), torch.tensor(lengths),
                               torch.tensor(active))
        _close(lg_t[1], lg_j[1])
        tok = int(lg_t[1].argmax())
        assert tok == int(jnp.argmax(lg_j[1]))
        lengths[1] += 1
        nxt[1, 0] = tok
    for key in ("k", "v"):
        _close(arena_t[key][:, 1:7], np.asarray(arena_j[key])[:, 1:7])


def test_decode_paged_multi_matches_reference(setup):
    """The fused greedy loop over 3 rows of 11, 17 and 9 positions (one
    inactive) against the reference's fused loop, token for token, and
    against single steps of the port exactly."""
    cfg_j, cfg_t, p_j, model = setup
    rng = np.random.default_rng(3)
    k_steps, bs, nb, b, n_pages = 5, 4, 24, 3, 7
    arena = {key: rng.standard_normal((cfg_t.n_layers, nb, bs,
                                       cfg_t.n_kv_heads, cfg_t.d_head)
                                      ).astype(np.float32) * 0.5
             for key in ("k", "v")}
    tables = rng.permutation(np.arange(1, nb))[:b * n_pages].reshape(
        b, n_pages).astype(np.int32)
    lengths = np.array([11, 17, 9], np.int32)
    active = np.array([True, True, False])
    nxt = rng.integers(1, cfg_t.vocab_size, size=(b, 1)).astype(np.int32)
    arena_m = {key: torch.tensor(v) for key, v in arena.items()}
    t = [torch.tensor(x) for x in (tables, lengths, active)]
    toks_m, nxt_m, ln_m = RT.decode_paged_multi(
        model, arena_m, {"tokens": torch.tensor(nxt)}, *t, k_steps)
    arena_s = {key: torch.tensor(v) for key, v in arena.items()}
    cur, ln = torch.tensor(nxt), t[1]
    for i in range(k_steps):
        tok = RT.decode_paged(model, arena_s, {"tokens": cur}, t[0], ln,
                              t[2]).argmax(-1).to(torch.int32)
        assert torch.equal(tok, toks_m[i])
        cur = torch.where(t[2][:, None], tok[:, None], cur)
        ln = ln + t[2].to(torch.int32)
    toks_j, arena_j, nxt_j, ln_j = RJ.decode_paged_multi(
        p_j, {key: jnp.asarray(v) for key, v in arena.items()},
        {"tokens": jnp.asarray(nxt)}, cfg_j, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(active), k_steps)
    np.testing.assert_array_equal(toks_m.numpy()[:, active],
                                  np.asarray(toks_j)[:, active])
    np.testing.assert_array_equal(nxt_m.numpy(), np.asarray(nxt_j))
    np.testing.assert_array_equal(ln_m.numpy(), np.asarray(ln_j))
    for key in ("k", "v"):
        _close(arena_m[key], arena_j[key])


# =============================================================================
# both engines against the reference's
# =============================================================================
def _mixed_prompts(vocab: int, seed: int = 3):
    """Prompts of 4-40 tokens, the longer sharing a 16-token prefix: most
    cross gemma3 SMOKE's window of 8."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    prompts = []
    for n in (4, 10, 24, 40, 9, 24):
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if n >= 24:
            p[:16] = shared
        prompts.append(p)
    return prompts


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_engine_matches_reference_engine(setup, layout):
    """``RealEngine`` of either layout against the reference's on the same
    weights and prompts: every request's stream is the reference model's
    greedy decode (each token the argmax of the reference's forward over
    the prompt and the tokens before it), the admit order and scheduling
    counters equal the reference engine's, and per-request joules (the
    reference's power model over the measured wall time) are positive and
    sum to the session's.  (The reference engine's own stream is not the
    oracle: run after other engines in one process it now and then emits
    a token that is not its model's argmax, by a top-2 gap of ~0.1.)"""
    cfg_j, cfg_t, p_j, _ = setup
    fam_j = ENGJ.build_engine_family(cfg_j, fracs=(1.0,))
    fam_j[0].params = p_j
    fam_t = ENG.build_engine_family(cfg_t, fracs=(1.0,), device="cpu")
    bridge.load_reference(fam_t[0].params, _flatten(p_j))
    kw = dict(n_slots=2, max_len=64, kv_layout=layout)
    if layout == "paged":
        kw.update(block_size=8, max_seqs=6)
    prompts = _mixed_prompts(cfg_t.vocab_size)
    n_new = 6
    ref = ENGJ.RealEngine(fam_j, **kw)
    ref.configure(CGJ.ConfigGraph.from_dict(cfg_j.name, {("x1", 1): 1}))
    m_ref = ref._serve_prompts(prompts, n_new=n_new)
    eng = ENG.RealEngine(fam_t, device="cpu", **kw)
    eng.configure(CGT.ConfigGraph.from_dict(cfg_t.name, {("x1", 1): 1}))
    m = eng._serve_prompts(prompts, n_new=n_new)
    assert set(eng.last_outputs) == set(range(len(prompts)))
    fwd = jax.jit(lambda t: RJ.forward(p_j, {"tokens": t}, cfg_j)[0])
    for rid, prompt in enumerate(prompts):
        out = eng.last_outputs[rid]
        assert len(out) == n_new
        lg = np.asarray(fwd(jnp.asarray(np.concatenate([prompt, out])[None])))
        n = len(prompt)
        np.testing.assert_array_equal(out,
                                      lg[0, n - 1:n - 1 + n_new].argmax(-1))
    assert eng.last_admit_order == ref.last_admit_order
    for key in ("served", "tokens", "decode_steps", "h2d_transfers",
                "host_syncs", "compile_retraces"):
        assert m[key] == m_ref[key], key
    if layout == "paged":
        for key in ("prefix_hit_tokens", "prefill_chunks",
                    "decode_dispatches", "blocks_peak"):
            assert m[key] == m_ref[key], key
        assert m["prefix_hit_tokens"] > 0
    for engine, stats in ((eng, m), (ref, m_ref)):
        joules = [r.energy_j for r in engine.last_responses]
        assert all(j > 0 for j in joules)
        assert sum(joules) == pytest.approx(stats["energy_j"], rel=1e-12)


# =============================================================================
# the windowed plain decode versions
# =============================================================================
@pytest.mark.parametrize("window", [0, 1, 5, 16, 40])
@pytest.mark.parametrize("H,K,dh", [(4, 2, 16), (16, 1, 16), (7, 1, 8)])
def test_windowed_decode_refs_match_reference(window, H, K, dh):
    """``decode_attention_ref`` (per-row and shared lengths) and
    ``paged_decode_attention_ref`` with a window against the reference
    model path's ``decode_attention_ref(window=...)`` over the contiguous
    cache and over ``gather_paged_kv``; window 0 is full attention."""
    rng = np.random.default_rng(H * 100 + window)
    b, S, bs = 4, 32, 4
    q = rng.standard_normal((b, H, dh)).astype(np.float32)
    kc = rng.standard_normal((b, S, K, dh)).astype(np.float32)
    vc = rng.standard_normal((b, S, K, dh)).astype(np.float32)
    for lengths in (np.array([1, 9, 20, 32], np.int32), np.int32(17)):
        want = LJ.decode_attention_ref(jnp.asarray(q)[:, None],
                                       jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(lengths), window=window)
        got = REFT.decode_attention_ref(torch.tensor(q), torch.tensor(kc),
                                        torch.tensor(vc),
                                        torch.tensor(lengths), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                                   rtol=1e-5, atol=1e-5)
    nb = b * S // bs + 1
    ka = rng.standard_normal((nb, bs, K, dh)).astype(np.float32)
    va = rng.standard_normal((nb, bs, K, dh)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb)).reshape(b, S // bs).astype(
        np.int32)
    lengths = np.array([3, 12, 29, 32], np.int32)
    kg, vg = LJ.gather_paged_kv(jnp.asarray(ka), jnp.asarray(va),
                                jnp.asarray(tables))
    want = LJ.decode_attention_ref(jnp.asarray(q)[:, None], kg, vg,
                                   jnp.asarray(lengths), window=window)
    got = REFT.paged_decode_attention_ref(
        torch.tensor(q), torch.tensor(ka), torch.tensor(va),
        torch.tensor(tables), torch.tensor(lengths), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=1e-5, atol=1e-5)
