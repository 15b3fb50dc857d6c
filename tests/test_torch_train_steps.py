"""The port's training loss and train steps against the reference on the
CPU, at the reference's own tiny training config
(``tests/test_train.py::_tiny_cfg``: qwen2-0.5b SMOKE cut to 2 layers of
width 32, f32), with the reference's weights carried across by
``models/bridge.py`` and the same numpy batches
(``train.data.SyntheticLM``, a copy of the reference's):

* ``chunked_xent`` (one and several chunks) and ``lm_loss``: values and
  gradients against ``jax.grad``;
* three ``make_train_step`` steps and one ``make_grad_accum_train_step``
  (accum 2) step: losses, gradient norms and every parameter and Adam
  moment against the reference's steps;
* the port's own checks: accumulation equals the plain step, every
  activation-checkpointing policy gives the same gradients bit for bit,
  the loss falls over 50 steps, and an inference forward records no
  graph.

Tolerances: the reference's ``test_grad_accum_equivalence`` bound, rtol
2e-4 / atol 2e-5, for parameters after steps; 1e-5 relative for losses
and gradients of the loss (f32, sums in another order).  One leaf is
held to the size of its updates instead: the key projection's bias,
some of whose elements have gradients at the level of rounding noise
(without rotary positions the whole gradient would be zero: the bias
shifts a query's scores alike, which the softmax ignores; here 5.6e-8
against a largest of 0.057), and AdamW turns a gradient's noise into a
step of up to ``lr``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train import data as DJ
from repro.train import optimizer as OJ
from repro.train import train_loop as TLJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.train import data as DT
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


TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
            d_ff=64, vocab_size=64)
RTOL, ATOL = 2e-4, 2e-5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _cfgs(**kw):
    return (get_smoke_config_j("qwen2-0.5b").with_(dtype=jnp.float32,
                                                   **TINY, **kw),
            get_smoke_config("qwen2-0.5b").with_(dtype=torch.float32,
                                                 **TINY, **kw))


@pytest.fixture(scope="module")
def ref():
    """(reference config, its params, the port's config)."""
    cfg_j, cfg_t = _cfgs()
    return cfg_j, RJ.init_params(jax.random.PRNGKey(0), cfg_j), cfg_t


def _model(ref, cfg_t=None):
    cfg_j, p_j, cfg = ref
    model = RT.init_params(cfg_t or cfg, seed=1, device="cpu")
    return bridge.load_reference(model, _flatten(p_j))


def _batch(cfg_j, step=0, b=4, s=16):
    return DJ.SyntheticLM(DJ.DataConfig(cfg_j.vocab_size, s, b)).batch_at(
        step)


# leaves with elements whose gradient is rounding noise (the module's note)
NOISE = ("layers/attn/wk/b",)


def _close_tree(got: dict, want: dict, steps: int = 1, lr: float = 0.0):
    """Every leaf within RTOL / ATOL; a leaf of ``NOISE`` (under any
    prefix) within the ``steps`` updates of size ``lr`` it may take."""
    assert set(got) == set(want)
    for k in want:
        atol = 2 * lr * steps if k.endswith(NOISE) else ATOL
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k], np.float32),
                                   rtol=RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("chunk", [4, 512])
def test_chunked_xent_and_its_gradients_match_reference(chunk):
    rng = np.random.default_rng(chunk)
    b, s, d, v = 2, 8, 16, 72
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 60, (b, s)).astype(np.int32)
    f = lambda x, w: TLJ.chunked_xent(x, w, jnp.asarray(labels), v,
                                      chunk=chunk)
    want, (gx_j, gw_j) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.tensor(t, requires_grad=True) for t in (x, w))
    got = TLT.chunked_xent(xt, wt, torch.tensor(labels), v, chunk=chunk)
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    gx, gw = torch.autograd.grad(got, (xt, wt))
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="vocabulary"):
        TLT.chunked_xent(xt, wt, torch.tensor(labels), v + 1)


def test_lm_loss_and_its_gradients_match_reference(ref):
    cfg_j, p_j, cfg = ref
    batch = _batch(cfg_j)
    (loss_j, m_j), g_j = jax.value_and_grad(
        lambda p: TLJ.lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg_j), has_aux=True)(p_j)
    model = _model(ref).requires_grad_(True)
    loss, m = TLT.lm_loss(model, DT.to_device(batch, "cpu"), cfg)
    assert loss.item() == pytest.approx(float(loss_j), rel=1e-6)
    assert set(m) == set(m_j) and float(m["aux_loss"]) == 0
    grads = bridge.to_reference(model, TLT._grads(model, loss))
    want = _flatten(g_j)
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(grads[k] / scale, want[k] / scale,
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def three_steps(ref):
    """The reference's state and metrics after each of three steps."""
    cfg_j, p_j, _ = ref
    opt = OJ.AdamWConfig(**OPT)
    state = TLJ.make_train_state(p_j, opt)
    step = jax.jit(TLJ.make_train_step(cfg_j, opt))
    out = []
    for i in range(3):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                _batch(cfg_j, i).items()})
        out.append((_flatten(state), {k: float(v) for k, v in m.items()}))
    return out


def test_three_train_steps_match_reference(ref, three_steps):
    """Every parameter, both Adam moments and the step counter after each
    of three steps, and each step's metrics."""
    cfg_j, _, cfg = ref
    model = _model(ref)
    opt = OT.AdamWConfig(**OPT)
    state = TLT.make_train_state(model, opt)
    step = TLT.make_train_step(cfg, opt)
    for i, (want, m_j) in enumerate(three_steps):
        state, m = step(state, DT.to_device(_batch(cfg_j, i), "cpu"))
        assert set(m) == set(m_j)
        for k in m_j:
            assert float(m[k]) == pytest.approx(m_j[k], rel=1e-5, abs=1e-9), k
        got = {f"params/{k}": v for k, v in
               bridge.export_reference(model).items()}
        for part in ("m", "v"):
            got.update({f"opt/{part}/{k}": v for k, v in
                        bridge.to_reference(model, state["opt"][part])
                        .items()})
        got["opt/step"] = state["opt"]["step"].numpy()
        _close_tree(got, want, steps=i + 1, lr=OPT["lr"])


def test_grad_accum_step_matches_reference(ref):
    cfg_j, p_j, cfg = ref
    opt = OJ.AdamWConfig(lr=1e-3)
    batch = _batch(cfg_j, 0, b=4, s=16)
    step_j = jax.jit(TLJ.make_grad_accum_train_step(cfg_j, opt, accum=2,
                                                    batch_axes=()))
    s_j, m_j = step_j(TLJ.make_train_state(p_j, opt),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    model = _model(ref)
    state = TLT.make_train_state(model, OT.AdamWConfig(lr=1e-3))
    state, m = TLT.make_grad_accum_train_step(cfg, OT.AdamWConfig(lr=1e-3),
                                              accum=2)(
        state, DT.to_device(batch, "cpu"))
    assert set(m) == set(m_j)
    for k in m_j:
        assert float(m[k]) == pytest.approx(float(m_j[k]), rel=1e-5,
                                            abs=1e-9), k
    _close_tree(bridge.export_reference(model), _flatten(s_j["params"]),
                lr=1e-3)


def test_grad_accum_equals_the_plain_step(ref):
    """accum=2 equals accum=1 on the same global batch, as the reference's
    own ``test_grad_accum_equivalence`` holds it."""
    cfg_j, _, cfg = ref
    batch = DT.to_device(_batch(cfg_j, 0), "cpu")
    opt = OT.AdamWConfig(lr=1e-3)
    s1 = TLT.make_train_state(_model(ref), opt)
    s2 = TLT.make_train_state(_model(ref), opt)
    s1, m1 = TLT.make_train_step(cfg, opt)(s1, batch)
    s2, m2 = TLT.make_grad_accum_train_step(cfg, opt, 2)(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for (n, a), b in zip(s1["params"].named_parameters(),
                         s2["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("variant", [dict(remat_policy="dots"),
                                     dict(remat_policy="collectives"),
                                     dict(remat_policy="none"),
                                     dict(remat=False)])
def test_remat_policies_change_no_gradient(ref, variant):
    """Activation checkpointing changes what the backward keeps, never the
    numbers: each policy's gradients equal full recompute's bit for bit,
    with grouped queries, qkv bias and a sliding window in the layers."""
    cfg_j, _, _ = ref
    extra = dict(qkv_bias=True, sliding_window=5)
    batch = DT.to_device(_batch(cfg_j, 1), "cpu")
    grads = []
    for kw in (dict(remat=True, remat_policy="full"), variant):
        cfg = _cfgs(**extra, **kw)[1]
        model = RT.init_params(cfg, seed=4, device="cpu").requires_grad_(True)
        loss, _ = TLT.lm_loss(model, batch, cfg)
        grads.append(TLT._grads(model, loss))
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_train_loss_decreases(ref):
    """The reference's ``test_train_loss_decreases`` on the port: 50 steps
    of the synthetic stream bring the loss below 0.8 of its start."""
    cfg_j, _, cfg = ref
    opt = OT.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    state = TLT.make_train_state(_model(ref), opt)
    step = TLT.make_train_step(cfg, opt)
    ds = DT.SyntheticLM(DT.DataConfig(cfg.vocab_size, 32, 8))
    losses = []
    for _, batch in zip(range(50), ds.batches()):
        state, m = step(state, DT.to_device(batch, "cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_inference_forward_records_no_graph(ref):
    """``train=False`` keeps the serving paths' ``no_grad`` forward even on
    parameters that require gradients; ``train=True`` records one, with
    the same values."""
    cfg_j, _, cfg = ref
    model = _model(ref).requires_grad_(True)
    batch = DT.to_device(_batch(cfg_j), "cpu")
    lg, _ = RT.forward(model, batch, cfg)
    assert lg.grad_fn is None and not lg.requires_grad
    with torch.no_grad():
        lg_t, _ = RT.forward(model, batch, cfg, train=True)
    assert lg_t.grad_fn is not None
    assert torch.equal(lg, lg_t)
    head = RT.head_weights(model, cfg)
    assert head.shape == (cfg.d_model, cfg.padded_vocab)
    assert head.data_ptr() == model.embed.data_ptr()        # tied: a view
