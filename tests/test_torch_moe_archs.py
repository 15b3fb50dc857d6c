"""The MoE family on the port — qwen3-moe-30b-a3b (128 experts top-8 at
full width; SMOKE 8 top-2, qk-norm, g = 2) and qwen2-moe-a2.7b (60 routed
experts padded to 64, top-4, 4 shared experts, QKV bias, g = 1; SMOKE 6
top-2, 2 shared) — against the reference at SMOKE size on the CPU, with the
reference's weights carried across by ``models/bridge.py`` (biases and
norm scales drawn at random first).  A third variant, qwen3-moe SMOKE with
``top_k = 1``, has a decode capacity of half the group (C = gsz / 2), so
decode rows compete for expert slots and a padded or inactive row that
comes first can displace a real one.

An MoE layer routes all tokens of a call together, with a capacity per
expert and group, so a row's output depends on the other rows, the
padding and the chunking.  The tests therefore hold every entry point to
the reference's on identical inputs, padded and inactive rows included:
``registry.forward`` (logits and aux), the ``make_cache`` / ``decode_step``
replay, the slotted and paged entry points and the fused paged decode.
The engines (paged and slotted) are held two ways: at the config's own
capacity, every model call the port's engine made (its inputs captured as
it ran) is run through the reference's entry point on the same inputs and
must give the same logits and tokens, and its counters and admit order
equal the reference engine's; at a drop-free copy of the config (both
capacity factors at E / k) a row no longer depends on the others, and the
streams equal the reference model's greedy decode.  ``--mode real --arch
qwen3-moe-30b-a3b`` runs Clover's loop on the slotted engine.  Tolerance:
logits within 2e-4 (f32, sums in another order), tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.core import config_graph as CGJ
from repro.models import registry as RJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core import config_graph as CGT
from repro_torch.launch import serve as SERVE
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.serving import engine as ENG

# (arch, SMOKE overrides)
VARIANTS = [("qwen3-moe-30b-a3b", {}), ("qwen2-moe-a2.7b", {}),
            ("qwen3-moe-30b-a3b", {"top_k": 1})]
TOL = 2e-4


def _ids(variant):
    arch, kw = variant
    return arch + ("-top1" if kw else "")


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


def _drop_free(cfg):
    f = cfg.padded_experts / cfg.top_k
    return cfg.with_(capacity_factor=f, decode_capacity_factor=f)


@pytest.fixture(scope="module", params=VARIANTS, ids=_ids)
def setup(request):
    """(reference config, port config, reference params, the same weights
    in the port's model)."""
    arch, kw = request.param
    cfg_j = get_smoke_config_j(arch).with_(**kw)
    cfg_t = get_smoke_config(arch).with_(**kw)
    p_j = _randomize(RJ.init_params(jax.random.PRNGKey(0), cfg_j), 1)
    model = RT.init_params(cfg_t, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    return cfg_j, cfg_t, p_j, model


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


# =============================================================================
# generic entry points
# =============================================================================
def test_forward_and_aux_match_reference(setup):
    """``registry.forward`` over 2 prompts of 19 tokens (one group of 38,
    C = 11 for qwen3-moe SMOKE) and over 3 x 32 (a group of 64): logits,
    hidden states and the summed aux loss; the config's drop-free copy set
    on the same model equals the reference's too."""
    cfg_j, cfg_t, p_j, model = setup
    for shape in ((2, 19), (3, 32)):
        toks = _tokens(cfg_t, 5, shape)
        want, aux_j = RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j)
        got, aux_t = RT.forward(model, {"tokens": torch.tensor(toks)}, cfg_t)
        assert got.shape == shape + (cfg_t.padded_vocab,)
        _close(got, want)
        assert aux_t.dtype == torch.float32 and float(aux_t) > 0
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    hidden, _ = RT.forward(model, {"tokens": torch.tensor(toks)}, cfg_t,
                           return_hidden=True)
    _close(hidden, RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j,
                              return_hidden=True)[0])
    model.cfg = _drop_free(cfg_t)
    try:
        free, _ = RT.forward(model, {"tokens": torch.tensor(toks)}, model.cfg)
    finally:
        model.cfg = cfg_t
    _close(free, RJ.forward(p_j, {"tokens": jnp.asarray(toks)},
                            _drop_free(cfg_j))[0])


def test_decode_step_replay_matches_reference(setup):
    """``make_cache`` / ``decode_step`` over 4 rows: a 19-token replay and
    3 greedy steps, logits held to the reference's at every step (the top-1
    variant's decode has C = 2 of 4 rows)."""
    cfg_j, cfg_t, p_j, model = setup
    toks = _tokens(cfg_t, 6, (4, 19))
    cache_j = RJ.make_cache(p_j, cfg_j, 4, 24, dtype=jnp.float32)
    cache_t = RT.make_cache(model, cfg_t, 4, 24, dtype=torch.float32,
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
        if i + 1 < 19:
            col = toks[:, i + 1:i + 2]
        else:
            col = lg_t.argmax(-1, keepdim=True).to(torch.int32).numpy()
            np.testing.assert_array_equal(col[:, 0],
                                          np.asarray(jnp.argmax(lg_j, -1)))
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key])


# =============================================================================
# slotted and paged entry points
# =============================================================================
def test_prefill_kv_and_decode_slots_match_reference(setup):
    """One-pass prefill of prompts of 13 and 10 tokens (padded to 16, as
    the slotted engine pads) into slots 0 and 2, slot 1 free, then 4
    batched slot decodes with greedy feedback: logits of every slot
    (the free one's too: it takes part in the routing), K/V and
    lengths against the reference's."""
    cfg_j, cfg_t, p_j, model = setup
    cache_j = RJ.make_slot_cache(cfg_j, 3, 32, dtype=jnp.float32)
    cache_t = RT.make_slot_cache(cfg_t, 3, 32, dtype=torch.float32,
                                 device="cpu")
    nxt = np.zeros((3, 1), np.int32)
    for slot, n in ((0, 13), (2, 10)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = _tokens(cfg_t, 7 + slot, (n,))
        lg_j, k_j, v_j = RJ.prefill_kv(p_j, {"tokens": jnp.asarray(toks)},
                                       cfg_j)
        lg_t, k_t, v_t = RT.prefill_kv(model, {"tokens": torch.tensor(toks)})
        _close(lg_t, lg_j)
        _close(k_t, k_j)
        _close(v_t, v_j)
        cache_j["k"] = cache_j["k"].at[:, slot, :n].set(k_j[:, 0, :n])
        cache_j["v"] = cache_j["v"].at[:, slot, :n].set(v_j[:, 0, :n])
        cache_j["lengths"] = cache_j["lengths"].at[slot].set(n)
        cache_t["k"][:, slot, :n] = k_t[:, 0, :n]
        cache_t["v"][:, slot, :n] = v_t[:, 0, :n]
        cache_t["lengths"][slot] = n
        nxt[slot, 0] = int(lg_t[0, n - 1].argmax())
    active = np.array([True, False, True])
    for _ in range(4):
        lg_j, cache_j = RJ.decode_slots(p_j, cache_j,
                                        {"tokens": jnp.asarray(nxt)}, cfg_j,
                                        jnp.asarray(active))
        lg_t, cache_t = RT.decode_slots(model, cache_t,
                                        {"tokens": torch.tensor(nxt)},
                                        torch.tensor(active))
        _close(lg_t, lg_j)
        nxt = np.where(active[:, None],
                       lg_t.argmax(-1, keepdim=True).to(torch.int32).numpy(),
                       nxt)
        assert (nxt[active, 0] == np.asarray(jnp.argmax(lg_j, -1))[active]
                ).all()
    np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                  np.asarray(cache_j["lengths"]))
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key])


def test_paged_prefill_and_decode_match_reference(setup):
    """Chunked paged prefill of a 19-token prompt (chunks of 8, the last
    one padded: its junk rows route after the real ones), every real
    position's logits against the reference's chunk; then 4 paged decode
    steps over 3 rows, the inactive row 0 ahead of the real row 1 (in the
    top-1 variant, C = 1 of 3: it competes for the real row's expert),
    logits of every row and the arena against the reference's."""
    cfg_j, cfg_t, p_j, model = setup
    toks = _tokens(cfg_t, 11, (1, 19))
    bs, C = 4, 8
    arena_j = RJ.make_block_arena(cfg_j, 16, bs, dtype=jnp.float32)
    arena_t = RT.make_block_arena(cfg_t, 16, bs, dtype=torch.float32,
                                  device="cpu")
    table = np.array([1, 2, 3, 4, 5, 6, 0, 0], np.int32)
    n_past = 0
    while n_past < 19:
        true_c = min(C, 19 - n_past)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :true_c] = toks[0, n_past:n_past + true_c]
        lg_j, arena_j = RJ.prefill_paged(p_j, {"tokens": jnp.asarray(chunk)},
                                         cfg_j, arena_j, jnp.asarray(table),
                                         n_past, true_c)
        lg_t = RT.prefill_paged(model, {"tokens": torch.tensor(chunk)},
                                arena_t, torch.tensor(table), n_past, true_c)
        _close(lg_t[0, :true_c], lg_j[0, :true_c])
        n_past += true_c
    tables = np.zeros((3, 8), np.int32)
    tables[1] = table
    lengths = np.array([0, 19, 0], np.int32)
    active = np.array([False, True, False])
    nxt = np.zeros((3, 1), np.int32)
    nxt[1, 0] = int(lg_t[0, true_c - 1].argmax())
    for _ in range(4):
        lg_j, arena_j = RJ.decode_paged(p_j, arena_j,
                                        {"tokens": jnp.asarray(nxt)}, cfg_j,
                                        jnp.asarray(tables),
                                        jnp.asarray(lengths),
                                        jnp.asarray(active))
        lg_t = RT.decode_paged(model, arena_t, {"tokens": torch.tensor(nxt)},
                               torch.tensor(tables), torch.tensor(lengths),
                               torch.tensor(active))
        _close(lg_t, lg_j)
        tok = int(lg_t[1].argmax())
        assert tok == int(jnp.argmax(lg_j[1]))
        lengths[1] += 1
        nxt[1, 0] = tok
    for key in ("k", "v"):
        _close(arena_t[key][:, 1:7], np.asarray(arena_j[key])[:, 1:7])


def test_decode_paged_multi_matches_reference(setup):
    """The fused greedy loop over 4 rows of 11, 17, 9 and 5 positions (the
    third inactive) against the reference's fused loop, token for token,
    and against single steps of the port exactly."""
    cfg_j, cfg_t, p_j, model = setup
    rng = np.random.default_rng(3)
    k_steps, bs, nb, b, n_pages = 5, 4, 32, 4, 7
    arena = {key: rng.standard_normal((cfg_t.n_layers, nb, bs,
                                       cfg_t.n_kv_heads, cfg_t.d_head)
                                      ).astype(np.float32) * 0.5
             for key in ("k", "v")}
    tables = rng.permutation(np.arange(1, nb))[:b * n_pages].reshape(
        b, n_pages).astype(np.int32)
    lengths = np.array([11, 17, 9, 5], np.int32)
    active = np.array([True, True, False, True])
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
        _close(arena_m[key][:, 1:], np.asarray(arena_j[key])[:, 1:])


# =============================================================================
# both engines against the reference's
# =============================================================================
def _mixed_prompts(vocab: int, seed: int = 3):
    """Prompts of 4-40 tokens, the longer sharing a 16-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    prompts = []
    for n in (4, 10, 24, 40, 9, 24):
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if n >= 24:
            p[:16] = shared
        prompts.append(p)
    return prompts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x


class _Recorder:
    """Captures every model call of the port's engine: the inputs as they
    were when the call was made (the arena or slot cache copied first,
    since the call writes it in place) and the outputs."""

    NAMES = ("prefill_kv", "decode_slots", "prefill_paged",
             "decode_paged_multi")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            monkeypatch.setattr(RT, name, self._wrap(name, getattr(RT, name)))

    def _wrap(self, name, fn):
        def call(params, *args):
            before = [_np(a) for a in args]
            out = fn(params, *args)
            self.calls.append((name, before, _np(out)))
            return out
        return call


def _serving(call) -> bool:
    """A call that serves a real row (warmup calls serve none)."""
    name, args, _ = call
    if name == "prefill_kv":
        return bool(args[0]["tokens"].any())
    if name == "prefill_paged":
        return args[4] > 0
    return bool(args[-2 if name == "decode_paged_multi" else -1].any())


def _replay(calls, ev_j) -> int:
    """Run each captured call that serves a real row through the
    reference's entry point on the same inputs — the reference engine's
    own jitted functions of variant ``ev_j``, so no shape compiles again —
    logits within ``TOL`` and greedy tokens equal.  Returns the number of
    calls replayed."""
    fns = {**ENGJ._variant_fns(ev_j), **ENGJ._paged_fns(ev_j)}
    p_j = ev_j.params
    real = 0
    for name, args, out in filter(_serving, calls):
        real += 1
        if name == "prefill_kv":
            lg, k, v = fns["prefill"](p_j, args[0]["tokens"])
            _close(out[0], lg)
            _close(out[1], k)
            _close(out[2], v)
        elif name == "decode_slots":
            cache, batch, active = args
            lg, _ = fns["decode"](p_j, cache, batch["tokens"], active)
            _close(out[0], lg)
            np.testing.assert_array_equal(out[0].argmax(-1)[active],
                                          np.asarray(lg).argmax(-1)[active])
        elif name == "prefill_paged":
            batch, arena, table, n_past, true_c = args
            lg, _ = fns[name](p_j, batch["tokens"], arena, table, n_past,
                              true_c)
            _close(out[0, :true_c], np.asarray(lg)[0, :true_c])
        else:
            arena, batch, tables, lengths, active, k = args
            toks, _, nxt, ln = fns["decode_multi"](
                p_j, arena, batch["tokens"], tables, lengths, active, k=k)
            np.testing.assert_array_equal(out[0][:, active],
                                          np.asarray(toks)[:, active])
            np.testing.assert_array_equal(out[1], np.asarray(nxt))
            np.testing.assert_array_equal(out[2], np.asarray(ln))
    return real


def _engine_kw(layout: str) -> dict:
    kw = dict(n_slots=2, max_len=64, kv_layout=layout)
    if layout == "paged":
        kw.update(block_size=8, max_seqs=6)
    return kw


def _port_engine(cfg_t, p_j, layout: str):
    """The port's engine of ``layout`` on the CPU over the reference's
    weights, configured with one instance of the full rung."""
    fam = ENG.build_engine_family(cfg_t, fracs=(1.0,), device="cpu")
    bridge.load_reference(fam[0].params, _flatten(p_j))
    eng = ENG.RealEngine(fam, device="cpu", **_engine_kw(layout))
    eng.configure(CGT.ConfigGraph.from_dict(cfg_t.name, {("x1", 1): 1}))
    return eng


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_engine_calls_match_reference_entry_points(setup, layout,
                                                   monkeypatch):
    """At the config's own capacity: every model call that serves a real
    row while the port's engine serves 6 mixed prompts gives, on the same
    inputs, the reference's entry point's logits and tokens, so the
    engine's batches, padded rows and chunks route as the reference's do;
    the admit order and scheduling counters equal the reference engine's,
    and per-request joules sum to the session's."""
    cfg_j, cfg_t, p_j, _ = setup
    fam_j = ENGJ.build_engine_family(cfg_j, fracs=(1.0,))
    fam_j[0].params = p_j
    ref = ENGJ.RealEngine(fam_j, **_engine_kw(layout))
    ref.configure(CGJ.ConfigGraph.from_dict(cfg_j.name, {("x1", 1): 1}))
    prompts = _mixed_prompts(cfg_t.vocab_size)
    m_ref = ref._serve_prompts(prompts, n_new=6)
    rec = _Recorder(monkeypatch)
    eng = _port_engine(cfg_t, p_j, layout)
    m = eng._serve_prompts(prompts, n_new=6)
    assert set(eng.last_outputs) == set(range(len(prompts)))
    assert _replay(rec.calls, ref.family["x1"]) >= len(prompts)
    assert eng.last_admit_order == ref.last_admit_order
    for key in ("served", "tokens", "decode_steps", "h2d_transfers",
                "host_syncs", "compile_retraces"):
        assert m[key] == m_ref[key], key
    if layout == "paged":
        for key in ("prefix_hit_tokens", "prefill_chunks",
                    "decode_dispatches", "blocks_peak"):
            assert m[key] == m_ref[key], key
        assert m["prefix_hit_tokens"] > 0
    joules = [r.energy_j for r in eng.last_responses]
    assert all(j > 0 for j in joules)
    assert sum(joules) == pytest.approx(m["energy_j"], rel=1e-12)


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_engine_at_drop_free_capacity_is_greedy_decode(setup, layout):
    """At a drop-free copy of the config a row's output no longer depends
    on the other rows: every request's stream is the reference model's
    greedy decode (each token the argmax of the reference's forward over
    the prompt and the tokens before it)."""
    cfg_j, cfg_t, p_j, _ = setup
    cfg_j, cfg_t = _drop_free(cfg_j), _drop_free(cfg_t)
    eng = _port_engine(cfg_t, p_j, layout)
    prompts = _mixed_prompts(cfg_t.vocab_size)
    n_new = 6
    eng._serve_prompts(prompts, n_new=n_new)
    # one forward over every request (prompt, stream, zero padding): with
    # nothing dropped, the padding changes no earlier position
    seqs = np.zeros((len(prompts), 48), np.int32)
    for rid, prompt in enumerate(prompts):
        out = eng.last_outputs[rid]
        assert len(out) == n_new
        seqs[rid, :len(prompt) + n_new] = np.concatenate([prompt, out])
    lg = np.asarray(RJ.forward(p_j, {"tokens": jnp.asarray(seqs)}, cfg_j)[0])
    for rid, prompt in enumerate(prompts):
        n = len(prompt)
        np.testing.assert_array_equal(eng.last_outputs[rid],
                                      lg[rid, n - 1:n - 1 + n_new].argmax(-1))


def test_engine_family_and_real_mode(capsys):
    """``build_engine_family`` builds a one-rung full-width-layout MoE
    family (MoE layers, f32 router), and ``--mode real --arch
    qwen3-moe-30b-a3b`` runs Clover's loop over the SMOKE ladder (8
    layers, f32) on the slotted engine."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    fam = ENG.build_engine_family(cfg.with_(dtype=torch.bfloat16),
                                  fracs=(1.0,), device="cpu")
    layer = fam[0].params.layers[0]
    assert layer.mlp is None and layer.moe.router.dtype == torch.float32
    assert layer.moe.w_gate.dtype == torch.bfloat16
    assert fam[0].cfg.n_layers == cfg.n_layers
    assert SERVE.main(["--mode", "real", "--device", "cpu", "--arch",
                       "qwen3-moe-30b-a3b", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "Clover chose" in out and "device cpu" in out
