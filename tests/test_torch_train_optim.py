"""The port's training substrate against the reference on the CPU: the
synthetic data stream, AdamW's schedule and update (with the reference's
weight-decay mask, read from its stacked layout), the compressed
all-reduce on a one-rank ``gloo`` group against the reference's
collectives on one device, ``ErrorFeedback``, and the data-parallel step
with each compressor against the reference's ``make_ddp_train_step`` on a
one-device mesh.

Tolerances: the schedule 1e-6 relative; AdamW's update rtol 1e-6 / atol
1e-7 for parameters, 1e-9 for the moments (f32, the same arithmetic in
another order: the clip factor's global norm sums in another order, and
a moment that cancels to ~1e-8 keeps that error); compressed all-reduce
exact (one rank: a cast, a scale and a rounding, done alike); the DDP
step's parameters rtol 2e-4 / atol 2e-5, as the plain step's
(``tests/test_torch_train_steps.py``), the key bias, some of whose
gradients are rounding noise, held to its update size.  With int8 the gradients the two packages quantise
differ in their last bits, so an element near a rounding boundary lands
one quantum (1/127 of its tensor's largest gradient) apart, which AdamW's
first step turns into up to ``lr``: the int8 step's gradient norm is held
to 1e-3, its parameters to 2 ``lr``, and fewer than 1% of them may leave
the plain bound."""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train import compression as CJ
from repro.train import data as DJ
from repro.train import optimizer as OJ
from repro.train import train_loop as TLJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.train import compression as CT
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


def test_data_stream_equals_reference():
    """Same (seed, step), same batch; restart-exact; labels the next
    token; ``to_device`` keeps values and dtype."""
    cj = DJ.DataConfig(100, 16, 4, seed=42)
    ct = DT.DataConfig(100, 16, 4, seed=42)
    ref, port = DJ.SyntheticLM(cj), DT.SyntheticLM(ct)
    for step in (0, 3, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    it = port.batches(start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  port.batch_at(3)["tokens"])
    b = port.batch_at(3)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    t = DT.to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(t["tokens"].numpy(), b["tokens"])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(OJ.schedule(OJ.AdamWConfig(**cfg), jnp.int32(step)))
    got = OT.schedule(OT.AdamWConfig(**cfg),
                      torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert got.item() == pytest.approx(want, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-0.5b", TINY),                   # qkv biases: 1-D per layer
    ("mamba2-2.7b", {}),                    # A_log, D, dt_bias: (L, H)
    ("zamba2-2.7b", {}),                    # the unstacked shared block
    ("seamless-m4t-large-v2", {}),          # enc_norm, two stacks
])
def test_adamw_update_and_decay_mask_match_reference(arch, kw):
    """Two AdamW updates from seeded gradients (one clipped) equal the
    reference's on every leaf, moment and counter: the reference decays
    every stacked leaf (a per-layer norm scale is (L, d) there) and of the
    unstacked ones only the matrices, which ``bridge.decay_mask`` reads
    from its layout."""
    cfg_j = get_smoke_config_j(arch).with_(dtype=jnp.float32, **kw)
    cfg = get_smoke_config(arch).with_(dtype=torch.float32, **kw)
    p_j = RJ.init_params(jax.random.PRNGKey(1), cfg_j)
    arrays = _flatten(p_j)
    model = bridge.load_reference(RT.init_params(cfg, seed=0, device="cpu"),
                                  arrays)
    mask = bridge.decay_mask(model)
    stacked = {n for _, names, _, st in bridge.leaf_map(model) if st
               for n in names}
    assert all(mask[n] for n in stacked)
    assert not mask["final_norm.scale"] and mask["embed"]
    for name, p in model.named_parameters():
        if name not in stacked:
            assert mask[name] == (p.dim() >= 2), name
    if arch == "zamba2-2.7b":
        assert not mask["shared.ln1.scale"]
        assert mask["layers.0.mamba.A_log"] and mask["layers.0.ln.scale"]
    if arch == "seamless-m4t-large-v2":
        assert not mask["enc_norm.scale"]
    opt_j = OJ.AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=1)
    opt = OT.AdamWConfig(lr=1e-2, clip_norm=1.0, warmup_steps=1)
    s_j, state = OJ.init_opt_state(p_j), OT.init_opt_state(model)
    update_j = jax.jit(lambda g, s, p: OJ.adamw_update(opt_j, g, s, p))
    rng = np.random.default_rng(2)
    for scale in (1e-3, 10.0):          # below and above the clip norm
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
             for k, v in arrays.items()}
        gj = jax.tree_util.tree_map(jnp.asarray, _unflatten(p_j, g))
        p_j, s_j, m_j = update_j(gj, s_j, p_j)
        _, state, m = OT.adamw_update(opt, bridge.from_reference(model, g),
                                      state, model)
        assert m["grad_norm"].item() == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-6)
        assert m["lr"].item() == pytest.approx(float(m_j["lr"]), rel=1e-6)
        got = bridge.export_reference(model)
        for k, want in _flatten(p_j).items():
            np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        for part in ("m", "v"):
            got = bridge.to_reference(model, state[part])
            for k, want in _flatten(s_j[part]).items():
                np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                           atol=1e-9, err_msg=k)
        assert int(state["step"]) == int(s_j["step"])


def _unflatten(tree, flat):
    """``flat`` (keyed as ``_flatten`` keys ``tree``) in ``tree``'s
    structure."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])


# ---------------------------------------------------------------------------
# collectives on one rank
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group():
    """A one-rank gloo process group on localhost."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    yield None
    dist.destroy_process_group()


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
            "b": (rng.standard_normal((11,)) * 1e-3).astype(np.float32),
            "c": np.zeros((3,), np.float32)}


def _ref_collective(fn, grads):
    """The reference's collective ``fn(tree, "data")`` on one device."""
    out = jax.vmap(lambda t: fn(t, "data"), axis_name="data")(
        {k: jnp.asarray(v)[None] for k, v in grads.items()})
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[0], out)


@pytest.mark.parametrize("method", [None, "f32", "bf16", "int8"])
def test_all_reduce_mean_matches_reference(group, method):
    g = _grads(3)
    want = _ref_collective(
        lambda t, ax: CJ.all_reduce_mean(t, ax, method=method), g)
    got = CT.all_reduce_mean({k: torch.tensor(v) for k, v in g.items()},
                             group, method=method)
    for k in g:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown compressor"):
        CT.all_reduce_mean({"a": torch.zeros(2)}, group, method="fp4")


def test_error_feedback_matches_reference(group):
    """Three steps of int8 with error feedback: each step's mean and the
    carried residual equal the reference's."""
    res_j = _ref_collective(lambda t, ax: t, {k: np.zeros_like(v) for k, v
                                              in _grads(0).items()})
    res = CT.ErrorFeedback.init({k: torch.zeros(v.shape) for k, v in
                                 _grads(0).items()})
    for step in range(3):
        g = _grads(10 + step)
        out_j, res_j = jax.vmap(
            lambda t, r: CJ.ErrorFeedback.compress_with_feedback(t, r, "data"),
            axis_name="data")({k: jnp.asarray(v)[None] for k, v in g.items()},
                              {k: jnp.asarray(v)[None]
                               for k, v in res_j.items()})
        out_j = {k: np.asarray(v)[0] for k, v in out_j.items()}
        res_j = {k: np.asarray(v)[0] for k, v in res_j.items()}
        out, res = CT.ErrorFeedback.compress_with_feedback(
            {k: torch.tensor(v) for k, v in g.items()}, res, group)
        for k in g:
            np.testing.assert_array_equal(out[k].numpy(), out_j[k])
            np.testing.assert_array_equal(res[k].numpy(), res_j[k])
    assert any(np.abs(v).max() > 0 for v in res_j.values())


@pytest.fixture(scope="module")
def ddp_ref():
    """The reference's DDP step on a one-device mesh, each compressor:
    (its config, initial params, batch, {compressor: (params, metrics)})."""
    from jax.sharding import Mesh
    cfg_j = get_smoke_config_j("qwen2-0.5b").with_(dtype=jnp.float32, **TINY)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    batch = DJ.SyntheticLM(DJ.DataConfig(cfg_j.vocab_size, 16, 4)).batch_at(2)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    opt = OJ.AdamWConfig(lr=1e-3)
    out = {}
    for comp in (None, "bf16", "int8"):
        step = TLJ.make_ddp_train_step(cfg_j, opt, mesh, compressor=comp)
        s, m = step(TLJ.make_train_state(p_j, opt),
                    {k: jnp.asarray(v) for k, v in batch.items()})
        out[comp] = (_flatten(s["params"]), {k: float(v) for k, v in
                                             m.items()})
    return _flatten(p_j), batch, out


@pytest.mark.parametrize("comp", [None, "bf16", "int8"])
def test_ddp_step_matches_reference_on_one_rank(group, ddp_ref, comp):
    init, batch, out = ddp_ref
    cfg = get_smoke_config("qwen2-0.5b").with_(dtype=torch.float32, **TINY)
    model = bridge.load_reference(RT.init_params(cfg, seed=3, device="cpu"),
                                  init)
    opt = OT.AdamWConfig(lr=1e-3)
    state = TLT.make_train_state(model, opt)
    state, m = TLT.make_ddp_train_step(cfg, opt, group, compressor=comp)(
        state, DT.to_device(batch, "cpu"))
    want_p, want_m = out[comp]
    assert set(m) == set(want_m)
    int8 = comp == "int8"
    for k, v in want_m.items():
        rel = 1e-3 if int8 and k == "grad_norm" else 1e-5
        assert m[k].item() == pytest.approx(v, rel=rel), k
    got = bridge.export_reference(model)
    lr, n, off = 1e-3, 0, 0
    for k, want in want_p.items():
        loose = int8 or k == "layers/attn/wk/b"
        np.testing.assert_allclose(got[k], want, rtol=2e-4,
                                   atol=2 * lr if loose else 2e-5, err_msg=k)
        n += want.size
        off += int((np.abs(got[k] - want) > 2e-5 + 2e-4 * np.abs(want)).sum())
    assert off < 0.01 * n, (off, n)
