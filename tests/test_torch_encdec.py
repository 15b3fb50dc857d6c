"""The port's enc-dec family (seamless-m4t-large-v2) against the reference
at SMOKE size (f32), with the reference's weights carried across by
``models/bridge.py`` and inputs made with numpy: the bridge's round trip of
the enc-dec tree, ``encode``, the generic entry points ``registry.forward``
(logits and hidden states), ``make_cache(src_embeds=)`` (the cross K/V)
and ``decode_step`` (logits and greedy tokens), at source lengths of 8 and
13 frames; the port's own decode against its forward; what stays refused;
and the plain flash attention in the forms enc-dec gives it — full (not
causal) with sq != skv — against the reference's Pallas kernel (interpret
mode) and its jnp oracle.

Tolerances: 2e-4 between the packages (f32; the sums run in another
order); 5e-3 for decode against forward
(``tests/test_models.py::test_decode_matches_forward``'s); exact for the
bridge; the kernels at ``tests/test_kernels.py::_tols`` (f32 3e-5, bf16
2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.kernels import flash_attention as FAJ
from repro.kernels import ref as REFJ
from repro.models import encdec as EDJ
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.config_graph import ConfigGraph
from repro_torch.kernels import ref as REFT
from repro_torch.models import bridge
from repro_torch.models import encdec as EDT
from repro_torch.models import registry as RT
from repro_torch.serving import engine as ENG

ARCH = "seamless-m4t-large-v2"
TOL = 2e-4
TOL_DECODE_VS_FORWARD = 5e-3
B, S_TGT, N_DECODE = 2, 10, 16
S_SRC = (8, 13)


def _close(got: torch.Tensor, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(reference config, reference params, their flattened arrays, the
    same weights in the port's model)."""
    cfg_j = get_smoke_config_j(ARCH)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    arrays = _flatten(p_j)
    model = RT.init_params(get_smoke_config(ARCH), seed=1, device="cpu")
    bridge.load_reference(model, arrays)
    return cfg_j, p_j, arrays, model


@pytest.fixture(scope="module", params=S_SRC)
def case(request, pair):
    """Inputs for ``s_src`` frames and the reference's outputs on them: the
    memory, forward logits and hidden states, the cache's cross K/V, and
    the logits and greedy tokens of ``N_DECODE`` decode steps from the
    targets' first token (each step fed the reference's argmax)."""
    cfg_j, p_j, _, _ = pair
    s_src = request.param
    rng = np.random.default_rng(s_src)
    src = rng.standard_normal((B, s_src, cfg_j.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg_j.vocab_size, size=(B, S_TGT)).astype(np.int32)
    batch = {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(tgt)}
    out = {"src": src, "tgt": tgt,
           "memory": np.asarray(EDJ.encode(p_j, batch["src_embeds"], cfg_j)),
           "logits": np.asarray(RJ.forward(p_j, batch, cfg_j)[0]),
           "hidden": np.asarray(RJ.forward(p_j, batch, cfg_j,
                                           return_hidden=True)[0])}
    cache = RJ.make_cache(p_j, cfg_j, B, N_DECODE + 1,
                          src_embeds=batch["src_embeds"], dtype=jnp.float32)
    out["xk"], out["xv"] = np.asarray(cache["xk"]), np.asarray(cache["xv"])
    step = jax.jit(lambda c, t: RJ.decode_step(p_j, c, {"tokens": t}, cfg_j))
    tok = jnp.asarray(tgt[:, :1])
    logits, toks = [], []
    for _ in range(N_DECODE):
        lg, cache = step(cache, tok)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        logits.append(np.asarray(lg))
        toks.append(np.asarray(tok))
    out["step_logits"], out["step_tokens"] = logits, toks
    return out


def test_bridge_round_trips_every_encdec_leaf(pair):
    """Every leaf of the enc-dec tree (both stacks, ``enc_norm``, the
    untied head) loads into the port and exports back bit-equal; a
    missing or an extra leaf is an error."""
    _, _, arrays, model = pair
    back = bridge.export_reference(model)
    assert set(back) == set(arrays)
    assert any(k.startswith("enc_layers/") for k in back)
    assert "dec_layers/xattn/wq/w" in back and "dec_layers/lnx/scale" in back
    assert "enc_norm/scale" in back and "lm_head/w" in back
    for key, ref in arrays.items():
        assert back[key].shape == ref.shape, key
        np.testing.assert_array_equal(back[key], np.asarray(ref, np.float32),
                                      err_msg=key)
    fresh = RT.init_params(model.cfg, seed=2, device="cpu")
    with pytest.raises(KeyError):
        bridge.load_reference(fresh, {k: v for k, v in arrays.items()
                                      if k != "dec_layers/lnx/scale"})
    with pytest.raises(ValueError, match="no place"):
        bridge.load_reference(fresh, {**arrays, "layers/ln1/scale":
                                      arrays["dec_layers/ln1/scale"]})


def test_encode_matches_reference(pair, case):
    model = pair[3]
    _close(EDT.encode(model, torch.tensor(case["src"])), case["memory"])


def test_forward_matches_reference(pair, case):
    """``registry.forward`` on ``{"src_embeds", "tokens"}``: the logits,
    and with ``return_hidden`` the final-normed hidden states."""
    model = pair[3]
    batch = {"src_embeds": torch.tensor(case["src"]),
             "tokens": torch.tensor(case["tgt"])}
    lg, aux = RT.forward(model, batch, model.cfg)
    assert lg.shape == (B, S_TGT, model.cfg.padded_vocab) and float(aux) == 0
    _close(lg, case["logits"], what="logits")
    hid, _ = RT.forward(model, batch, model.cfg, return_hidden=True)
    _close(hid, case["hidden"], what="hidden")


def test_make_cache_cross_kv_matches_reference(pair, case):
    """The encoder runs once in ``make_cache``; every decoder layer's cross
    K/V equal the reference's, the self caches are empty, and the batch
    comes from ``src_embeds`` (``batch_size`` is ignored)."""
    model = pair[3]
    cache = RT.make_cache(model, model.cfg, 99, N_DECODE + 1,
                          src_embeds=torch.tensor(case["src"]),
                          dtype=torch.float32, device="cpu")
    assert set(cache) == {"xk", "xv", "k", "v", "pos"}
    _close(cache["xk"], case["xk"], what="xk")
    _close(cache["xv"], case["xv"], what="xv")
    cfg = model.cfg
    assert cache["k"].shape == (cfg.n_layers, B, N_DECODE + 1,
                                cfg.n_kv_heads, cfg.d_head)
    assert not cache["k"].any() and int(cache["pos"]) == 0
    with pytest.raises(ValueError, match="src_embeds"):
        RT.make_cache(model, cfg, B, 8, device="cpu")


def test_decode_steps_match_reference(pair, case):
    """``N_DECODE`` greedy steps through ``decode_step``: every step's
    logits within TOL of the reference's and the same greedy tokens."""
    model = pair[3]
    cache = RT.make_cache(model, model.cfg, B, N_DECODE + 1,
                          src_embeds=torch.tensor(case["src"]),
                          dtype=torch.float32, device="cpu")
    tok = torch.tensor(case["tgt"][:, :1])
    for i, (want, want_tok) in enumerate(zip(case["step_logits"],
                                             case["step_tokens"])):
        lg, cache = RT.decode_step(model, cache, {"tokens": tok}, model.cfg)
        _close(lg, want, what=f"step {i}")
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert int(cache["pos"]) == N_DECODE


def test_decode_matches_own_forward(pair, case):
    """The targets replayed through ``decode_step`` give the forward's
    logits at every position, within the reference's own bound."""
    model = pair[3]
    src, tgt = torch.tensor(case["src"]), torch.tensor(case["tgt"])
    full, _ = RT.forward(model, {"src_embeds": src, "tokens": tgt},
                         model.cfg)
    cache = RT.make_cache(model, model.cfg, B, S_TGT, src_embeds=src,
                          dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S_TGT):
        lg, cache = RT.decode_step(model, cache, {"tokens": tgt[:, t:t + 1]},
                                   model.cfg)
        outs.append(lg)
    _close(torch.stack(outs, dim=1), full.numpy(), TOL_DECODE_VS_FORWARD)


def test_training_forward_and_engines_refuse_encdec(pair):
    """``forward(train=True)`` is not ported; the slot cache, the arena
    and the engines (both layouts) refuse enc-dec, as the reference's
    ``supports_slots`` does."""
    model = pair[3]
    cfg = model.cfg
    src = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="training"):
        RT.forward(model, {"src_embeds": src,
                           "tokens": torch.zeros(1, 4, dtype=torch.long)},
                   cfg, train=True)
    assert not RT.supports_slots(cfg)
    with pytest.raises((AssertionError, NotImplementedError)):
        RT.make_slot_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        RT.make_block_arena(cfg, 4, 8, device="cpu")
    family = ENG.build_engine_family(cfg, fracs=(1.0,), device="cpu")
    assert isinstance(family[0].params, EDT.EncDec)
    for layout in ("slotted", "paged"):
        eng = ENG.RealEngine(family, n_slots=2, max_len=32, device="cpu",
                             kv_layout=layout)
        with pytest.raises((AssertionError, NotImplementedError)):
            eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))


# =============================================================================
# the plain flash attention in enc-dec's forms: full, sq != skv
# =============================================================================
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", [(16, 40), (40, 8)])
def test_noncausal_cross_flash_plain_matches_reference(sq, skv, dtype):
    """Encoder self-attention and cross-attention (queries over another
    sequence's keys) run the flash kernel full, not causal: the port's
    plain version against the reference's Pallas kernel (interpret mode)
    and its jnp oracle."""
    jd, td, tol = {"float32": (jnp.float32, torch.float32, 3e-5),
                   "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    rng = np.random.default_rng(sq * skv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, sq, 4, 16), (2, skv, 2, 16),
                             (2, skv, 2, 16)))
    got = REFT.flash_attention_ref(*(torch.tensor(a).to(td)
                                     for a in (q, k, v)), causal=False)
    qj, kj, vj = (jnp.asarray(a, jd) for a in (q, k, v))
    want = FAJ.flash_attention(qj, kj, vj, causal=False, interpret=True)
    _close(got, want, tol)
    _close(got, REFJ.flash_attention_ref(qj, kj, vj, causal=False), tol)
