"""The port's SSM (mamba2) and hybrid (zamba2) families against the
reference's at SMOKE size (f32), with the reference's weights carried
across by ``models/bridge.py`` and inputs made with numpy: the Mamba2 block
(``mamba2_apply`` against the reference's with its Pallas kernel in
interpret mode and with its jnp ``ssd_ref``; ``mamba2_decode_step``), the
generic entry points ``registry.forward``, ``make_cache`` and
``decode_step`` (logits, caches and greedy tokens),
the port's own decode-against-forward check, and the bridge's round trip of
both trees.

Tolerances: 2e-4 between the packages (f32; the sums run in another order,
the SSD scan's chunked form among them); 5e-3 for decode against forward
(``tests/test_models.py::test_decode_matches_forward``'s: the recurrence
and the chunked dual form are different summations); exact for the
bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.models import ssm as SSMJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as FAT
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REFT
from repro_torch.kernels import ssd_scan as SSDT
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.models import ssm as SSMT

TOL = 2e-4
TOL_DECODE_VS_FORWARD = 5e-3
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
B, S = 2, 16


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference config, reference params, the same weights in the
    port's model, the reference's decode step jitted once)."""
    arch = request.param
    cfg_j = get_smoke_config_j(arch).with_(dtype=jnp.float32)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    model = RT.init_params(get_smoke_config(arch), device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    step_j = jax.jit(lambda c, t: RJ.decode_step(p_j, c, {"tokens": t},
                                                 cfg_j))
    return arch, cfg_j, p_j, model, step_j


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close(got: torch.Tensor, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _layer0(p_j):
    return jax.tree.map(lambda a: a[0], p_j["layers"]["mamba"])


# =============================================================================
# the Mamba2 block
# =============================================================================
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_apply_matches_reference(arch, use_kernel):
    """The block over a (2, 16, d) input equals the reference's, with its
    Pallas SSD kernel (interpret mode) and with its jnp scan."""
    cfg_j = get_smoke_config_j(arch)
    p_j = RJ.init_params(jax.random.PRNGKey(1), cfg_j)
    model = RT.init_params(get_smoke_config(arch), device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg_j.d_model)).astype(np.float32)
    want = jax.jit(lambda p, v: SSMJ.mamba2_apply(
        p, v, cfg_j, use_kernel=use_kernel))(_layer0(p_j), jnp.asarray(x))
    got = SSMT.mamba2_apply(model.layers[0].mamba, torch.tensor(x))
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_decode_step_matches_reference(arch):
    """Six decode steps of the block from a zero cache: outputs and the
    advanced cache (f32 conv histories, f32 state) equal the
    reference's."""
    cfg_j = get_smoke_config_j(arch)
    p_j = RJ.init_params(jax.random.PRNGKey(3), cfg_j)
    model = RT.init_params(get_smoke_config(arch), device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    cache_j = SSMJ.init_ssm_cache(cfg_j, B, jnp.float32)
    cache_t = SSMT.init_ssm_cache(model.cfg, B, torch.float32, "cpu")
    xs = np.random.default_rng(4).standard_normal(
        (6, B, 1, cfg_j.d_model)).astype(np.float32)
    for x in xs:
        y_j, cache_j = SSMJ.mamba2_decode_step(_layer0(p_j), jnp.asarray(x),
                                               cache_j, cfg_j)
        y_t = SSMT.mamba2_decode_step(model.layers[0].mamba, torch.tensor(x),
                                      cache_t)
        _close(y_t, y_j)
    for key in cache_j:
        _close(cache_t[key], cache_j[key], what=key)


def test_decode_conv_rounds_the_new_column_to_the_cache_type():
    """With the default bf16 cache of an f32 model, the new column is
    rounded to bf16 before the f32 conv, as in the reference."""
    cfg_j = get_smoke_config_j("mamba2-2.7b")
    p_j = RJ.init_params(jax.random.PRNGKey(5), cfg_j)
    model = RT.init_params(get_smoke_config("mamba2-2.7b"), device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    cache_j = SSMJ.init_ssm_cache(cfg_j, B)
    cache_t = SSMT.init_ssm_cache(model.cfg, B, device="cpu")
    assert cache_t["conv_x"].dtype == torch.bfloat16
    assert cache_t["state"].dtype == torch.float32
    xs = np.random.default_rng(6).standard_normal(
        (3, B, 1, cfg_j.d_model)).astype(np.float32)
    for x in xs:
        y_j, cache_j = SSMJ.mamba2_decode_step(_layer0(p_j), jnp.asarray(x),
                                               cache_j, cfg_j)
        y_t = SSMT.mamba2_decode_step(model.layers[0].mamba, torch.tensor(x),
                                      cache_t)
        _close(y_t, y_j)
    np.testing.assert_array_equal(
        cache_t["conv_x"].float().numpy(),
        np.asarray(cache_j["conv_x"].astype(jnp.float32)))


def test_mamba2_apply_refuses_a_ragged_sequence():
    model = RT.init_params(get_smoke_config("mamba2-2.7b"), device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SSMT.mamba2_apply(model.layers[0].mamba,
                          torch.zeros(1, 12, model.cfg.d_model))


# =============================================================================
# the generic entry points
# =============================================================================
def test_forward_matches_reference(pair):
    arch, cfg_j, p_j, model, step_j = pair
    toks = _tokens(cfg_j)
    want, aux_j = RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j)
    got, aux_t = RT.forward(model, {"tokens": torch.tensor(toks)}, model.cfg)
    assert tuple(got.shape) == (B, S, model.cfg.padded_vocab)
    _close(got, want)
    assert float(aux_t) == float(aux_j) == 0.0
    hid, _ = RT.forward(model, {"tokens": torch.tensor(toks)}, model.cfg,
                        return_hidden=True)
    hid_j, _ = RJ.forward(p_j, {"tokens": jnp.asarray(toks)}, cfg_j,
                          return_hidden=True)
    _close(hid, hid_j)


def test_decode_steps_match_reference(pair):
    """16 decode steps from ``make_cache`` (f32): every step's logits and
    the final cache — SSM conv histories and states, the shared block's
    K/V, ``pos`` — equal the reference's."""
    arch, cfg_j, p_j, model, step_j = pair
    toks = _tokens(cfg_j, seed=1)
    cache_j = RJ.make_cache(p_j, cfg_j, B, S + 4, dtype=jnp.float32)
    cache_t = RT.make_cache(model, model.cfg, B, S + 4, dtype=torch.float32,
                            device="cpu")
    assert set(cache_t) == set(cache_j)
    for t in range(S):
        lg_j, cache_j = step_j(cache_j, jnp.asarray(toks[:, t:t + 1]))
        lg_t, cache_t = RT.decode_step(
            model, cache_t, {"tokens": torch.tensor(toks[:, t:t + 1])},
            model.cfg)
        _close(lg_t, lg_j, what=f"step {t}")
    flat_j, flat_t = _flatten(cache_j), _flatten_cache(cache_t)
    assert set(flat_t) == set(flat_j)
    for key in flat_j:
        _close(flat_t[key], flat_j[key], what=key)
    assert int(cache_t["pos"]) == S


def _flatten_cache(cache):
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out.update({f"{key}/{k}": v for k, v in val.items()})
        else:
            out[key] = val
    return out


def test_greedy_tokens_match_reference(pair):
    """Greedy generation of 8 tokens after replaying an 8-token prompt
    through ``decode_step`` (the reference's forward returns no SSM state,
    so a generation replays the prompt): equal token streams."""
    arch, cfg_j, p_j, model, step_j = pair
    prompt = _tokens(cfg_j, seed=2, s=8)
    cache_j = RJ.make_cache(p_j, cfg_j, B, 16, dtype=jnp.float32)
    cache_t = RT.make_cache(model, model.cfg, B, 16, dtype=torch.float32,
                            device="cpu")
    outs = []
    for cache, step, wrap in (
            (cache_j, step_j, jnp.asarray),
            (cache_t, lambda c, t: RT.decode_step(model, c, {"tokens": t},
                                                  model.cfg), torch.tensor)):
        for t in range(prompt.shape[1]):
            lg, cache = step(cache, wrap(prompt[:, t:t + 1]))
        gen = []
        for _ in range(8):
            tok = np.asarray(lg).argmax(-1).astype(np.int32)[:, None]
            gen.append(tok)
            lg, cache = step(cache, wrap(tok))
        outs.append(np.concatenate(gen, axis=1))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_decode_matches_forward(pair):
    """The port's own check, as the reference's test_models.py: token-by-
    token decode reproduces the full forward's logits."""
    arch, cfg_j, p_j, model, step_j = pair
    toks = torch.tensor(_tokens(cfg_j, seed=3))
    full, _ = RT.forward(model, {"tokens": toks}, model.cfg)
    cache = RT.make_cache(model, model.cfg, B, S + 4, dtype=torch.float32,
                          device="cpu")
    outs = []
    for t in range(S):
        lg, cache = RT.decode_step(model, cache, {"tokens": toks[:, t:t + 1]},
                                   model.cfg)
        outs.append(lg)
    _close(torch.stack(outs, dim=1), full.numpy(), TOL_DECODE_VS_FORWARD)


def test_forward_on_cpu_launches_nothing_and_checks_its_arguments(
        pair, monkeypatch):
    """On the CPU the forward takes the plain scan and launches no kernel;
    a config mismatch raises.  The training forward runs on the CPU (the
    same logits, with a graph); on CUDA (``ops._on_cuda`` patched) it
    goes through the scan's autograd Function, once a Mamba2 layer, and
    the hybrid's shared attention through the flash one (both stood in
    for by their plain versions here; ``tests/test_torch_ssd_bwd.py``
    runs them through a plain-version extension)."""
    arch, cfg_j, p_j, model, step_j = pair
    before = SSDT.ssd_chunked.launches
    toks = {"tokens": torch.tensor(_tokens(cfg_j))}
    lg, _ = RT.forward(model, toks, model.cfg)
    assert SSDT.ssd_chunked.launches == before
    with pytest.raises(ValueError, match="not the config"):
        RT.forward(model, {"tokens": torch.zeros(1, 8, dtype=torch.long)},
                   model.cfg.with_(n_layers=model.cfg.n_layers + 2))
    model.requires_grad_(True)
    try:
        lg_t, _ = RT.forward(model, toks, model.cfg, train=True)
        assert lg_t.grad_fn is not None and torch.equal(lg_t, lg)
        assert SSDT.ssd_chunked.launches == before
        monkeypatch.setattr(ops, "_on_cuda", lambda name, q: True)
        seen = []

        def scan(x, dt, A, B, C, chunk):
            seen.append(chunk)
            return REFT.ssd_chunked_ref(x, dt, A, B, C, chunk)

        def attend(q, k, v, causal, window, sm_scale):
            return REFT.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, sm_scale=sm_scale)
        monkeypatch.setattr(SSDT.SsdChunkedFn, "apply", scan)
        monkeypatch.setattr(FAT.FlashAttentionFn, "apply", attend)
        lg_c, _ = RT.forward(model, toks, model.cfg, train=True)
        assert lg_c.grad_fn is not None and torch.equal(lg_c, lg)
        assert seen == [model.cfg.ssm_chunk] * model.cfg.n_layers
        assert SSDT.ssd_chunked.launches == before
    finally:
        model.requires_grad_(False)


def test_generic_entry_points_refuse_unported_dense_options():
    """The generic forward and decode serve the dense and MoE families
    (``tests/test_torch_dense_archs.py``, ``tests/test_torch_moe_archs.py``)
    but refuse what stays unported of their configurations: the
    append-buffer decode on dense weights.  M-RoPE (qwen2-vl) on dense
    weights runs, and without positions equals plain RoPE
    (``tests/test_torch_vlm.py`` holds it to the reference with them);
    enc-dec builds its own model (``tests/test_torch_encdec.py``); an MoE
    config builds and runs through both."""
    model = RT.init_params(get_smoke_config("qwen3-1.7b"), device="cpu")
    toks = torch.tensor(_tokens(model.cfg, b=1, s=8))
    plain, _ = RT.forward(model, {"tokens": toks}, model.cfg)
    model.cfg = model.cfg.with_(mrope_sections=(2, 3, 3))
    lg, _ = RT.forward(model, {"tokens": toks}, model.cfg)
    assert torch.equal(lg, plain)
    cache = RT.make_cache(model, model.cfg, 1, 8, dtype=torch.float32,
                          device="cpu")
    lg, _ = RT.decode_step(model, cache, {"tokens": toks[:, :1]}, model.cfg)
    torch.testing.assert_close(lg, plain[:, 0], rtol=TOL, atol=TOL)
    model.cfg = model.cfg.with_(mrope_sections=(), decode_window=8)
    with pytest.raises(NotImplementedError):
        RT.forward(model, {"tokens": toks}, model.cfg)
    with pytest.raises(NotImplementedError):
        RT.make_cache(model, model.cfg, 1, 8, device="cpu")
    encdec = RT.init_params(
        get_smoke_config("qwen3-1.7b").with_(n_enc_layers=2), device="cpu")
    assert len(encdec.enc_layers) == 2
    cfg = get_smoke_config("qwen3-1.7b").with_(
        family="moe", n_experts=4, top_k=2, d_expert_ff=32)
    model = RT.init_params(cfg, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    lg, aux = RT.forward(model, {"tokens": toks}, cfg)
    assert lg.shape == (1, 8, cfg.padded_vocab) and float(aux) > 0
    cache = RT.make_cache(model, cfg, 1, 8, dtype=torch.float32,
                          device="cpu")
    lg, _ = RT.decode_step(model, cache, {"tokens": toks[:, :1]}, cfg)
    assert lg.shape == (1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_caches_refuse_the_ssm_families(arch):
    """The slot cache and the paged arena refuse SSM and hybrid, as the
    reference's do (``supports_slots`` / ``supports_paged``)."""
    cfg = get_smoke_config(arch)
    assert not RT.supports_slots(cfg)
    with pytest.raises((AssertionError, NotImplementedError)):
        RT.make_slot_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        RT.make_block_arena(cfg, 4, 8, device="cpu")


# =============================================================================
# the bridge
# =============================================================================
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_params_round_trip_exactly(arch, dtype):
    cfg_j = get_smoke_config_j(arch).with_(dtype=getattr(jnp, dtype))
    arrays = _flatten(RJ.init_params(jax.random.PRNGKey(7), cfg_j))
    model = RT.init_params(get_smoke_config(arch).with_(
        dtype=getattr(torch, dtype)), seed=1, device="cpu")
    bridge.load_reference(model, arrays)
    back = bridge.export_reference(model)
    assert set(back) == set(arrays)
    for key, ref in arrays.items():
        assert back[key].shape == ref.shape, key
        np.testing.assert_array_equal(back[key],
                                      np.asarray(ref, np.float32),
                                      err_msg=key)
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(model.layers[0].mamba, name).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_layout(arch):
    """A model the port initialised itself exports under exactly the
    reference's keys and shapes — the SMOKE leaf list of the SSM and hybrid
    trees — and loads back to the same tensors."""
    cfg_j = get_smoke_config_j(arch)
    arrays = _flatten(RJ.init_params(jax.random.PRNGKey(8), cfg_j))
    model = RT.init_params(get_smoke_config(arch), seed=2, device="cpu")
    own = bridge.export_reference(model)
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in arrays.items()}
    mamba = {"wz", "wx", "wB", "wC", "wdt", "out_proj"}
    want = ({"embed/table", "final_norm/scale", "layers/ln/scale",
             "layers/mamba/gate_norm/scale"}
            | {f"layers/mamba/{n}/w" for n in mamba}
            | {f"layers/mamba/{n}" for n in (
                "conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB",
                "conv_bC", "A_log", "D", "dt_bias")})
    if arch == "zamba2-2.7b":
        want |= ({"shared/ln1/scale", "shared/ln2/scale", "lm_head/w"}
                 | {f"shared/attn/{n}/w" for n in ("wq", "wk", "wv", "wo")}
                 | {f"shared/mlp/{n}/w" for n in ("wi_gate", "wi_up",
                                                  "wo")})
    assert set(own) == want
    fresh = RT.init_params(get_smoke_config(arch), seed=3, device="cpu")
    bridge.load_reference(fresh, own)
    for (n1, p1), (n2, p2) in zip(model.named_parameters(),
                                  fresh.named_parameters()):
        assert n1 == n2
        assert torch.equal(p1, p2), n1
