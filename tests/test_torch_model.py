"""The port's paged model against the reference's at SMOKE size, with the
reference's weights carried across by ``models/bridge.py``: chunked
prefill against the reference's full forward, paged decode against the
reference's paged decode, and the fused multi-step decode against single
steps.  Tolerance: logits within 2e-4 (f32, sums in another order) and
equal greedy tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.models import bridge
from repro_torch.models import encdec as EDT
from repro_torch.models import registry as RT

CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE
TOL = 2e-4


@pytest.fixture(scope="module")
def params():
    """(reference params, the same weights in the port's model)."""
    p_j = RJ.init_params(jax.random.PRNGKey(0), CFG)
    model = RT.init_params(CFG_T, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    return p_j, model


def _prompt(seed: int, n: int = 13) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(1, n)).astype(np.int32)


def _prefill_both(params, toks, bs=4, C=8):
    """Chunked prefill of ``toks`` through both packages' paged arenas
    (table [1..5]); returns (jax arena, port arena, last logits of each)."""
    p_j, model = params
    n = toks.shape[1]
    arena_j = RJ.make_block_arena(CFG, 16, bs, dtype=jnp.float32)
    arena_t = RT.make_block_arena(CFG_T, 16, bs, dtype=torch.float32,
                                  device="cpu")
    table = np.array([1, 2, 3, 4, 5, 0, 0, 0], np.int32)
    n_past = 0
    while n_past < n:
        true_c = min(C, n - n_past)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :true_c] = toks[0, n_past:n_past + true_c]
        lg_j, arena_j = RJ.prefill_paged(p_j, {"tokens": jnp.asarray(chunk)},
                                         CFG, arena_j, jnp.asarray(table),
                                         n_past, true_c)
        lg_t = RT.prefill_paged(model, {"tokens": torch.tensor(chunk)},
                                arena_t, torch.tensor(table), n_past, true_c)
        n_past += true_c
    return (arena_j, arena_t, np.asarray(lg_j[0, true_c - 1]),
            lg_t[0, true_c - 1].numpy())


def test_chunked_prefill_matches_full_forward(params):
    """Prefilling in chunks through the port's paged arena reproduces the
    reference's full forward at the last position."""
    toks = _prompt(5)
    ref, _ = RJ.forward(params[0], {"tokens": jnp.asarray(toks)}, CFG)
    arena_j, arena_t, last_j, last_t = _prefill_both(params, toks)
    np.testing.assert_allclose(last_t, np.asarray(ref[0, 12]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(last_t, last_j, rtol=TOL, atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(arena_t[key][:, 1:6].numpy(),
                                   np.asarray(arena_j[key])[:, 1:6],
                                   rtol=TOL, atol=TOL)


def test_paged_decode_matches_reference_paged_decode(params):
    """Greedy continuation through the paged arena equals the reference's
    paged decode logit for logit (and the reference's slotted cache token
    for token), junk rows riding along."""
    p_j, model = params
    toks = _prompt(6)
    arena_j, arena_t, last_j, last_t = _prefill_both(params, toks)
    first = int(np.argmax(last_t))
    assert first == int(np.argmax(last_j))
    tables = np.zeros((3, 8), np.int32)
    tables[1] = [1, 2, 3, 4, 5, 0, 0, 0]
    lengths = np.array([0, 13, 0], np.int32)
    active = np.array([False, True, False])
    nxt = np.zeros((3, 1), np.int32)
    nxt[1, 0] = first
    cache = RJ.make_slot_cache(CFG, 1, 32, dtype=jnp.float32)
    _, k_all, v_all = RJ.prefill_kv(p_j, {"tokens": jnp.asarray(toks)}, CFG)
    cache["k"] = cache["k"].at[:, 0, :13].set(k_all[:, 0])
    cache["v"] = cache["v"].at[:, 0, :13].set(v_all[:, 0])
    cache["lengths"] = jnp.array([13], jnp.int32)
    nxt_s = jnp.array([[first]], jnp.int32)
    for _ in range(4):
        lg_j, arena_j = RJ.decode_paged(p_j, arena_j,
                                        {"tokens": jnp.asarray(nxt)}, CFG,
                                        jnp.asarray(tables),
                                        jnp.asarray(lengths),
                                        jnp.asarray(active))
        lg_t = RT.decode_paged(model, arena_t, {"tokens": torch.tensor(nxt)},
                               torch.tensor(tables), torch.tensor(lengths),
                               torch.tensor(active))
        lg_s, cache = RJ.decode_slots(p_j, cache, {"tokens": nxt_s}, CFG,
                                      jnp.array([True]))
        np.testing.assert_allclose(lg_t[1].numpy(), np.asarray(lg_j[1]),
                                   rtol=TOL, atol=TOL)
        tok = int(lg_t[1].argmax())
        assert tok == int(jnp.argmax(lg_j[1])) == int(jnp.argmax(lg_s[0]))
        lengths[1] += 1
        nxt[1, 0] = tok
        nxt_s = jnp.array([[tok]], jnp.int32)


def _multi_inputs():
    rng = np.random.default_rng(3)
    k_steps, bs, nb, b, n_pages = 4, 8, 12, 3, 3
    arena = {key: rng.standard_normal((CFG.n_layers, nb, bs, CFG.n_kv_heads,
                                       CFG.d_head)).astype(np.float32) * 0.02
             for key in ("k", "v")}
    tables = rng.permutation(np.arange(1, nb))[:b * n_pages].reshape(
        b, n_pages).astype(np.int32)
    lengths = np.array([5, 9, 7], np.int32)
    active = np.array([True, True, False])
    nxt = rng.integers(1, CFG.vocab_size, size=(b, 1)).astype(np.int32)
    return k_steps, arena, tables, lengths, active, nxt


def test_decode_paged_multi_matches_single_steps(params):
    """The fused loop equals k host-fed single steps exactly (same ops in
    the same order), including an inactive row whose state must not move;
    and it matches the reference's fused loop token for token."""
    p_j, model = params
    k_steps, arena, tables, lengths, active, nxt = _multi_inputs()
    t = {name: torch.tensor(x) for name, x in
         (("tables", tables), ("lengths", lengths), ("active", active),
          ("nxt", nxt))}
    arena_m = {key: torch.tensor(v) for key, v in arena.items()}
    toks_m, nxt_m, ln_m = RT.decode_paged_multi(
        model, arena_m, {"tokens": t["nxt"]}, t["tables"], t["lengths"],
        t["active"], k_steps)
    arena_s = {key: torch.tensor(v) for key, v in arena.items()}
    cur, ln, toks_s = t["nxt"], t["lengths"], []
    for _ in range(k_steps):
        logits = RT.decode_paged(model, arena_s, {"tokens": cur},
                                 t["tables"], ln, t["active"])
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks_s.append(tok)
        cur = torch.where(t["active"][:, None], tok[:, None], cur)
        ln = ln + t["active"].to(torch.int32)
    assert torch.equal(toks_m, torch.stack(toks_s))
    assert torch.equal(nxt_m, cur) and torch.equal(ln_m, ln)
    for key in ("k", "v"):
        assert torch.equal(arena_m[key], arena_s[key])
    toks_j, _, nxt_j, ln_j = RJ.decode_paged_multi(
        p_j, {key: jnp.asarray(v) for key, v in arena.items()},
        {"tokens": jnp.asarray(nxt)}, CFG, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(active), k_steps)
    np.testing.assert_array_equal(toks_m.numpy()[:, active],
                                  np.asarray(toks_j)[:, active])
    np.testing.assert_array_equal(nxt_m.numpy(), np.asarray(nxt_j))
    np.testing.assert_array_equal(ln_m.numpy(), np.asarray(ln_j))


def test_unported_configs_raise():
    """The append-buffer decode (``decode_window``) builds and decodes
    (``tests/test_torch_split_decode.py`` holds it to the reference); the
    arena accepts such a config and ignores the field, as the reference's
    does.  Enc-dec builds an ``EncDec`` and M-RoPE an ``LM``, as the
    reference's ``init_params`` does (the generic entry points run them:
    ``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``).  The
    arena refuses those two, and the SSM family, which the reference's
    ``supports_paged`` excludes.  (Sliding windows and the local/global
    pattern are ported: ``tests/test_torch_dense_archs.py``.)  MoE is
    ported: the same widths with experts build MoE layers and an arena
    (``tests/test_torch_moe_archs.py``)."""
    moe = CFG_T.with_(family="moe", n_experts=4, top_k=2, d_expert_ff=32)
    model = RT.init_params(moe, device="cpu")
    assert all(layer.mlp is None and layer.moe.w_gate.shape == (4, 64, 32)
               for layer in model.layers)
    arena = RT.make_block_arena(moe, 4, 8, dtype=torch.float32, device="cpu")
    assert arena["k"].shape == (moe.n_layers, 4, 8, 2, 16)
    encdec = RT.init_params(CFG_T.with_(n_enc_layers=2), device="cpu")
    assert isinstance(encdec, EDT.EncDec) and len(encdec.enc_layers) == 2
    mrope = RT.init_params(CFG_T.with_(mrope_sections=(2, 3, 3)),
                           device="cpu")
    assert isinstance(mrope, RT.LM)
    split_cfg = CFG_T.with_(decode_window=8)
    split = RT.init_params(split_cfg, device="cpu")
    cache = RT.make_cache(split, split_cfg, 1, 8, dtype=torch.float32,
                          device="cpu")
    assert cache["sk"].shape == (split_cfg.n_layers, 1, 8, 2, 16)
    lg, cache = RT.decode_step(split, cache, {"tokens": torch.zeros(
        (1, 1), dtype=torch.int32)}, split_cfg)
    assert lg.shape == (1, split_cfg.padded_vocab) and bool(
        torch.isfinite(lg).all()) and int(cache["pos"]) == 1
    arena = RT.make_block_arena(split_cfg, 4, 8, device="cpu")
    assert set(arena) == {"k", "v"}
    for kw in ({"mrope_sections": (2, 3, 3)}, {"family": "ssm"},
               {"n_enc_layers": 2}):
        with pytest.raises(NotImplementedError):
            RT.make_block_arena(CFG_T.with_(**kw), 4, 8, device="cpu")
