"""The port's VL family (qwen2-vl-7b: the dense body with M-RoPE) against
the reference at SMOKE size (f32, sections (4, 2, 2)), with the reference's
weights carried across by ``models/bridge.py`` and inputs made with numpy:
``mrope_table`` on positions whose three streams differ,
``merge_patch_embeds`` and ``default_mrope_positions``, ``registry.forward``
with the positions of an image grid and ``forward_lm`` on merged patch
embeddings, and a prompt replayed through ``decode_step`` with per-step
positions then continued greedily (logits and tokens); text-only M-RoPE
against plain RoPE; and the engines' refusal.

The grid's positions follow qwen2-vl: text ``0 .. n0 - 1`` on all three
streams, an image of gh x gw patches at temporal ``n0``, height ``n0 +
i`` and width ``n0 + j``, then text from ``n0 + max(gh, gw)``.  So after
the image a token's rotary position and its cache slot differ.

Tolerance: 2e-4 between the packages (f32; the sums run in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import layers as LJ
from repro.models import registry as RJ
from repro.models import transformer as TJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.config_graph import ConfigGraph
from repro_torch.models import bridge
from repro_torch.models import layers as LT
from repro_torch.models import registry as RT
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as ENG

ARCH = "qwen2-vl-7b"
TOL = 2e-4
B = 2
N0, GH, GW, N1 = 4, 4, 4, 4          # text, a 4 x 4 image, text
S = N0 + GH * GW + N1
N_NEW = 8


def _close(got: torch.Tensor, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def grid_positions(b: int, n0: int, gh: int, gw: int, n1: int):
    """(3, b, n0 + gh*gw + n1) int32 M-RoPE positions of text, an image
    grid and text, and the (b, s) bool mask of the image's positions."""
    t = list(range(n0)) + [n0] * (gh * gw)
    h = list(range(n0)) + [n0 + i for i in range(gh) for _ in range(gw)]
    w = list(range(n0)) + [n0 + j for _ in range(gh) for j in range(gw)]
    rest = list(range(n0 + max(gh, gw), n0 + max(gh, gw) + n1))
    pos = np.array([t + rest, h + rest, w + rest], np.int32)
    mask = np.zeros(pos.shape[1], bool)
    mask[n0:n0 + gh * gw] = True
    return (np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).copy(),
            np.broadcast_to(mask, (b, mask.size)).copy())


@pytest.fixture(scope="module")
def pair():
    cfg_j = get_smoke_config_j(ARCH)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    model = RT.init_params(get_smoke_config(ARCH), seed=1, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    return cfg_j, p_j, model


@pytest.fixture(scope="module")
def inputs(pair):
    cfg_j = pair[0]
    rng = np.random.default_rng(0)
    pos, mask = grid_positions(B, N0, GH, GW, N1)
    return {"tokens": rng.integers(0, cfg_j.vocab_size,
                                   size=(B, S)).astype(np.int32),
            "pos": pos, "mask": mask,
            "patches": rng.standard_normal(
                (B, GH * GW, cfg_j.d_model)).astype(np.float32)}


def test_mrope_table_matches_reference():
    """Three streams that differ, sections (16, 24, 24) of a 128-wide head
    and the SMOKE's (4, 2, 2) of 16: (b, s, half) tables equal the
    reference's; with equal streams they are the plain tables."""
    rng = np.random.default_rng(1)
    for d_rot, sections in ((128, (16, 24, 24)), (16, (4, 2, 2))):
        pos = rng.integers(0, 5000, size=(3, 2, 9)).astype(np.int32)
        want = LJ.mrope_table(jnp.asarray(pos), d_rot, 1e6, sections)
        got = LT.mrope_table(torch.tensor(pos), d_rot, 1e6, sections)
        for g, w in zip(got, want):
            assert g.shape == (2, 9, d_rot // 2)
            _close(g, w, 1e-6)
        same = np.broadcast_to(pos[:1], pos.shape)
        got = LT.mrope_table(torch.tensor(same), d_rot, 1e6, sections)
        plain = LT.rope_table(torch.tensor(pos[0]), d_rot, 1e6)
        for g, p in zip(got, plain):
            assert torch.equal(g, p)


def test_merge_patch_embeds_and_default_positions_match_reference(inputs):
    rng = np.random.default_rng(2)
    tok = rng.standard_normal((B, S, 8)).astype(np.float32)
    patches = rng.standard_normal((B, GH * GW, 8)).astype(np.float32)
    want = TJ.merge_patch_embeds(jnp.asarray(tok), jnp.asarray(patches),
                                 jnp.asarray(inputs["mask"]))
    got = TT.merge_patch_embeds(torch.tensor(tok), torch.tensor(patches),
                                torch.tensor(inputs["mask"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        TT.default_mrope_positions(B, S, device="cpu").numpy(),
        np.asarray(TJ.default_mrope_positions(B, S)))


def test_forward_with_grid_positions_matches_reference(pair, inputs):
    """``registry.forward`` on tokens with the grid's positions, and
    ``forward_lm`` on the tokens' embeddings with the patch embeddings
    merged in (``inputs_embeds``) at the same positions."""
    cfg_j, p_j, model = pair
    toks, pos = inputs["tokens"], inputs["pos"]
    want, _ = RJ.forward(p_j, {"tokens": jnp.asarray(toks),
                               "mrope_positions": jnp.asarray(pos)}, cfg_j)
    got, aux = RT.forward(model, {"tokens": torch.tensor(toks),
                                  "mrope_positions": torch.tensor(pos)},
                          model.cfg)
    assert got.shape == (B, S, model.cfg.padded_vocab) and float(aux) == 0
    _close(got, want, what="tokens")
    emb_j = TJ.merge_patch_embeds(
        LJ.embedding_apply(p_j["embed"], jnp.asarray(toks)),
        jnp.asarray(inputs["patches"]), jnp.asarray(inputs["mask"]))
    want, _ = TJ.forward_lm(p_j, None, cfg_j,
                            mrope_positions=jnp.asarray(pos),
                            inputs_embeds=emb_j)
    emb_t = TT.merge_patch_embeds(
        LT.embedding_apply(model.embed, torch.tensor(toks)),
        torch.tensor(inputs["patches"]), torch.tensor(inputs["mask"]))
    got, _ = TT.forward_lm(model, None, mrope_positions=torch.tensor(pos),
                           inputs_embeds=emb_t)
    _close(got, want, what="inputs_embeds")


def test_replayed_decode_with_positions_matches_reference(pair, inputs):
    """The prompt replayed through ``decode_step`` with each token's
    (3, b, 1) grid positions, then ``N_NEW`` greedy tokens whose positions
    continue after the last text position — while the cache slot is the
    step count: every step's logits within TOL and the same tokens."""
    cfg_j, p_j, model = pair
    toks, pos = inputs["tokens"], inputs["pos"]
    after = pos[:, :, -1:] + 1 + np.arange(N_NEW, dtype=np.int32)
    all_pos = np.concatenate([pos, after], axis=2)
    step_j = jax.jit(lambda c, t, p: RJ.decode_step(
        p_j, c, {"tokens": t, "mrope_positions": p}, cfg_j))
    cache_j = RJ.make_cache(p_j, cfg_j, B, S + N_NEW, dtype=jnp.float32)
    cache_t = RT.make_cache(model, model.cfg, B, S + N_NEW,
                            dtype=torch.float32, device="cpu")
    tok = toks[:, :1]
    for i in range(S + N_NEW):
        p = all_pos[:, :, i:i + 1]
        lg_j, cache_j = step_j(cache_j, jnp.asarray(tok), jnp.asarray(p))
        lg_t, cache_t = RT.decode_step(
            model, cache_t, {"tokens": torch.tensor(tok),
                             "mrope_positions": torch.tensor(p)}, model.cfg)
        _close(lg_t, lg_j, what=f"step {i}")
        if i + 1 < S:
            tok = toks[:, i + 1:i + 2]
        else:
            tok = np.asarray(jnp.argmax(lg_j, -1)).astype(np.int32)[:, None]
            np.testing.assert_array_equal(lg_t.argmax(-1).numpy(), tok[:, 0])
    assert int(cache_t["pos"]) == S + N_NEW
    _close(cache_t["k"], cache_j["k"], what="k cache")


def test_text_only_mrope_equals_plain_rope(pair, inputs):
    """With all three streams at ``0 .. s - 1`` (or no positions at all)
    the forward and the decode equal the same weights' with plain RoPE."""
    model = pair[2]
    toks = torch.tensor(inputs["tokens"])
    plain = RT.init_params(model.cfg.with_(family="dense",
                                           mrope_sections=()), device="cpu")
    plain.load_state_dict(model.state_dict())
    want, _ = RT.forward(plain, {"tokens": toks}, plain.cfg)
    for extra in ({}, {"mrope_positions":
                       TT.default_mrope_positions(B, S, device="cpu")}):
        got, _ = RT.forward(model, {"tokens": toks, **extra}, model.cfg)
        assert torch.equal(got, want)
    caches = [RT.make_cache(m, m.cfg, B, 4, dtype=torch.float32,
                            device="cpu") for m in (model, plain)]
    for i in range(4):
        lg, _ = RT.decode_step(model, caches[0], {
            "tokens": toks[:, i:i + 1], "mrope_positions":
            TT.default_mrope_positions(B, 4, device="cpu")[:, :, i:i + 1]},
            model.cfg)
        lg_p, _ = RT.decode_step(plain, caches[1],
                                 {"tokens": toks[:, i:i + 1]}, plain.cfg)
        assert torch.equal(lg, lg_p)


def test_engines_refuse_the_vl_family(pair):
    """The slot cache, the arena and the engines (both layouts) refuse
    the VLM, as the reference's ``supports_slots`` does."""
    cfg = pair[2].cfg
    assert not RT.supports_slots(cfg)
    with pytest.raises((AssertionError, NotImplementedError)):
        RT.make_slot_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        RT.make_block_arena(cfg, 4, 8, device="cpu")
    family = ENG.build_engine_family(cfg, fracs=(1.0,), device="cpu")
    for layout in ("slotted", "paged"):
        eng = ENG.RealEngine(family, n_slots=2, max_len=32, device="cpu",
                             kv_layout=layout)
        with pytest.raises((AssertionError, NotImplementedError)):
            eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
