"""One training step for every model family on the port against the
reference on the CPU, at each family's SMOKE config in f32 with the
reference's weights carried across by ``models/bridge.py``: dense
(gemma3-27b: sliding windows on 5 of every 6 layers, two rotary bases),
MoE (qwen2-moe-a2.7b: padded experts, shared experts, the load-balance
loss in the loss), VL (qwen2-vl-7b with M-RoPE positions), enc-dec
(seamless-m4t-large-v2 with source frames), SSM (mamba2-2.7b) and hybrid
(zamba2-2.7b: the shared block's unstacked leaves, which the reference
does not decay).  Each holds ``lm_loss``'s value, aux loss and gradients
to ``jax.value_and_grad`` of the reference's, then one
``make_train_step`` step's metrics and parameters to the reference's
step.

Tolerances: gradients within 1e-4 of each leaf's largest magnitude
(f32, sums in another order; the SSM scans and MoE routing add depth);
losses 1e-5 relative; parameters after the step rtol 2e-4 / atol 5e-5 —
AdamW's first step moves every element by about ``lr`` (1e-3) whatever
its gradient's size, so an element whose gradient is near rounding noise
(a few in each of these configs) may move by a few percent of ``lr``
apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train import optimizer as OJ
from repro.train import train_loop as TLJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.train import optimizer as OT
from repro_torch.train import train_loop as TLT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run this file's small tensor ops on one thread: beside the other
    test workers, a pool of a thread a core makes every op wait for
    threads that have no core (a tiny train step took 577 ms at 8 threads
    beside 7 busy processes, 26 ms at 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("gemma3-27b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "seamless-m4t-large-v2", "mamba2-2.7b", "zamba2-2.7b")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
B, S, S_SRC = 2, 16, 11


def _batch(cfg_j):
    rng = np.random.default_rng(len(cfg_j.name))
    toks = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg_j.n_enc_layers:
        batch["src_embeds"] = rng.standard_normal(
            (B, S_SRC, cfg_j.d_model)).astype(np.float32)
    if cfg_j.mrope_sections:
        # a 2 x 3 image after 4 text tokens: the streams differ there
        t = list(range(4)) + [4] * 6 + list(range(7, 13))
        h = list(range(4)) + [4, 4, 4, 5, 5, 5] + list(range(7, 13))
        w = list(range(4)) + [4, 5, 6, 4, 5, 6] + list(range(7, 13))
        batch["mrope_positions"] = np.broadcast_to(
            np.array([t, h, w], np.int32)[:, None], (3, B, S)).copy()
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    cfg_j = get_smoke_config_j(arch).with_(dtype=jnp.float32)
    cfg = get_smoke_config(arch).with_(dtype=torch.float32)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    batch = _batch(cfg_j)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: TLJ.lm_loss(p, bj, cfg_j), has_aux=True))(p_j)
    opt = OJ.AdamWConfig(**OPT)
    p1_j, _, om_j = jax.jit(lambda g, o, p: OJ.adamw_update(opt, g, o, p))(
        g_j, OJ.init_opt_state(p_j), p_j)
    return dict(cfg=cfg, init=_flatten(p_j), batch=batch, loss=float(loss_j),
                aux=float(m_j["aux_loss"]), grads=_flatten(g_j),
                params=_flatten(p1_j),
                metrics={k: float(v) for k, v in om_j.items()})


def _model(family):
    """The reference's initial weights in a port model."""
    return bridge.load_reference(
        RT.init_params(family["cfg"], seed=1, device="cpu"), family["init"])


def test_loss_and_gradients_match_reference(family):
    cfg = family["cfg"]
    model = _model(family).requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in family["batch"].items()}
    loss, m = TLT.lm_loss(model, batch, cfg)
    assert loss.item() == pytest.approx(family["loss"], rel=1e-5)
    assert m["aux_loss"].item() == pytest.approx(family["aux"], rel=1e-5,
                                                 abs=1e-9)
    if cfg.is_moe:
        assert family["aux"] > 0
    grads = bridge.to_reference(model, TLT._grads(model, loss))
    for k, want in family["grads"].items():
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(grads[k] / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=k)


def test_train_step_matches_reference(family):
    cfg = family["cfg"]
    model = _model(family)
    state = TLT.make_train_state(model, OT.AdamWConfig(**OPT))
    state, m = TLT.make_train_step(cfg, OT.AdamWConfig(**OPT))(
        state, {k: torch.as_tensor(v) for k, v in family["batch"].items()})
    assert m["loss"].item() == pytest.approx(family["loss"], rel=1e-5)
    for k in ("grad_norm", "lr"):
        assert m[k].item() == pytest.approx(family["metrics"][k], rel=1e-5)
    got = bridge.export_reference(model)
    for k, want in family["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=2e-4, atol=5e-5,
                                   err_msg=k)
