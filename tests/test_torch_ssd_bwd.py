"""The gradient of the SSD chunked scan on the port, against the
reference's on the CPU: ``kernels/ref.py::ssd_chunked_bwd_ref`` (the
backward kernels' formulas chunk by chunk, ``csrc/ssd_backward.cu``) and
autograd through ``ssd_chunked_ref`` (the CPU training path and the
card's oracle), both against ``jax.vjp`` of the reference model path's
``ssd_ref`` (the reference trains through it; it has no Pallas backward),
on the same numpy inputs, with and without a cotangent on the final
state, for groups of one head, of two and of all heads.  The plain
forward's chunk states against ``ssd_ref``'s final state on each prefix
of whole chunks.  Then the wrappers and ``SsdChunkedFn`` on CPU tensors
with the device check and the build patched out (an extension that
computes with the plain versions): the states the forward is asked for,
the tensors the backward gets, the forward alone under ``no_grad``, the
backward wrapper's refusals, and one training forward and backward of the
mamba2 and zamba2 SMOKE configs through the stand-in against CPU autograd
(the recompute under per-layer checkpointing reaches ``SsdChunkedFn``).

Tolerances, each a fraction of the compared tensor's largest magnitude:
gradients 2e-5 (f32 sums in another order, cumsum rounding turned into
relative error by exp; the readings are below 3.2e-6); the chunk states
1e-5 (the same f32 chunk products as ``ssd_ref``'s; readings below
1.9e-6); a model's parameter gradients 1e-4 (chip_smoke's ``GRAD_TOL``:
the backward's sums run in another order than autograd's, through the
layers; readings below 1.4e-5)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as SSMJ
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FAT
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REFT
from repro_torch.kernels import ssd_scan as SSDT
from repro_torch.models import registry as R


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run this file's small tensor ops on one thread (see
    ``test_torch_train_flash.py``: beside the other test workers, a pool
    of a thread a core makes every op wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_GRAD = 2e-5
TOL_STATES = 1e-5
TOL_MODEL = 1e-4

# (b, s, H, P, G, N, chunk)
CASES = {
    "g1-4chunks": (2, 32, 4, 8, 1, 8, 8),
    "g2-3chunks": (1, 48, 4, 4, 2, 12, 16),
    "gH-c4": (2, 16, 3, 12, 3, 4, 4),
    "one-chunk": (1, 8, 2, 8, 1, 16, 8),
}
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(b, s, H, P, G, N, seed):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(N(0, 1)); the
    cotangents dy and dstate ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)))).astype(np.float32)
    B = rng.standard_normal((b, s, G, N)).astype(np.float32)
    C = rng.standard_normal((b, s, G, N)).astype(np.float32)
    dy = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dstate = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return (x, dt, A, B, C), dy, dstate


@functools.partial(jax.jit, static_argnames="chunk")
def _vjp(args, cots, chunk):
    _, vjp = jax.vjp(lambda *a: SSMJ.ssd_ref(*a, chunk=chunk), *args)
    return vjp(cots)


def _reference(args, dy, dstate, chunk):
    """The five gradients of the reference's ssd_ref by jax.vjp (jitted:
    one compilation a shape, where the op-by-op run compiles every op),
    the final state's cotangent ``dstate`` (zeros when None)."""
    x, B = args[0], args[3]
    if dstate is None:
        dstate = np.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[3]),
                          np.float32)
    return [np.asarray(g) for g in _vjp(tuple(jnp.asarray(a) for a in args),
                                        (jnp.asarray(dy), jnp.asarray(dstate)),
                                        chunk)]


def _close(got, want, what, tol=TOL_GRAD):
    got = got.detach().float().numpy()
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, (f"{what}: max |err| {err:.3g} beyond {tol} "
                                f"x {scale:.3g}")


@pytest.fixture(scope="module", params=[(name, final) for name in sorted(CASES)
                                        for final in (False, True)],
                ids=lambda p: f"{p[0]}-{'dstate' if p[1] else 'nodstate'}")
def case(request):
    name, final = request.param
    b, s, H, P, G, N, chunk = CASES[name]
    args, dy, dstate = _inputs(b, s, H, P, G, N, seed=len(name))
    dstate = dstate if final else None
    return args, dy, dstate, chunk, _reference(args, dy, dstate, chunk)


def test_backward_formulas_match_reference_vjp(case):
    """``ssd_chunked_bwd_ref`` on the plain forward's chunk states gives
    the reference's five gradients."""
    args, dy, dstate, chunk, want = case
    t = [torch.tensor(a) for a in args]
    _, _, states = REFT.ssd_chunked_ref(*t, chunk, return_states=True)
    got = REFT.ssd_chunked_bwd_ref(
        *t, states, torch.tensor(dy),
        None if dstate is None else torch.tensor(dstate), chunk)
    for g, leaf, w, name in zip(got, t, want, GRADS):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        _close(g, w, name)


def test_cpu_autograd_matches_reference_vjp(case):
    """``ops.ssd_chunked`` on CPU tensors differentiates through the plain
    version: the CPU training path and the card's oracle."""
    args, dy, dstate, chunk, want = case
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y, st = ops.ssd_chunked(*leaves, chunk=chunk)
    outs, cots = [y], [torch.tensor(dy)]
    if dstate is not None:
        outs.append(st)
        cots.append(torch.tensor(dstate))
    grads = torch.autograd.grad(outs, leaves, cots)
    for g, w, name in zip(grads, want, GRADS):
        _close(g, w, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_states_are_the_prefix_states(name):
    """The state entering chunk k is the reference's final state after
    the first k chunks (zero for k = 0); the y and final state are the
    ones without ``return_states``."""
    b, s, H, P, G, N, chunk = CASES[name]
    args, _, _ = _inputs(b, s, H, P, G, N, seed=3)
    t = [torch.tensor(a) for a in args]
    y, st, states = REFT.ssd_chunked_ref(*t, chunk, return_states=True)
    y0, st0 = REFT.ssd_chunked_ref(*t, chunk)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert states.shape == (b, s // chunk, H, P, N)
    assert states.dtype == torch.float32
    assert not states[:, 0].any()
    x, dt, A, B, C = args
    final = jax.jit(SSMJ.ssd_ref, static_argnames="chunk")
    for k in range(1, s // chunk):
        e = k * chunk
        _, want = final(x[:, :e], dt[:, :e], A, B[:, :e], C[:, :e],
                        chunk=chunk)
        _close(states[:, k], np.asarray(want), f"state entering chunk {k}",
               TOL_STATES)


# ---------------------------------------------------------------------------
# the wrappers and the autograd Function, on CPU tensors
# ---------------------------------------------------------------------------
class _PlainExt:
    """Stands in for the built extension: the SSD scan's forward and
    backward and the flash forward and backward computed by the plain
    versions, each call recorded."""

    def __init__(self):
        self.calls = []

    def ssd(self, x, dt, A, B, C, y, state, states, chunk, ps):
        self.calls.append(("ssd", tuple(states.shape), chunk, ps))
        if states.numel():
            y_r, st_r, states_r = REFT.ssd_chunked_ref(
                x, dt, A, B, C, chunk, return_states=True)
            states.copy_(states_r)
        else:
            y_r, st_r = REFT.ssd_chunked_ref(x, dt, A, B, C, chunk)
        y.copy_(y_r)
        state.copy_(st_r)

    def ssd_bwd(self, x, dt, A, B, C, states, dy, dstate, dh1, dx, ddt,
                dA_part, dB_part, dC_part, dA, dB, dC, chunk, ps):
        self.calls.append(("ssd_bwd", tuple(states.shape), tuple(dh1.shape),
                           tuple(dB_part.shape), dstate.numel() > 0, chunk,
                           ps))
        grads = REFT.ssd_chunked_bwd_ref(x, dt, A, B, C, states, dy,
                                         dstate if dstate.numel() else None,
                                         chunk)
        for dst, src in zip((dx, ddt, dA, dB, dC), grads):
            dst.copy_(src)

    def flash(self, q, k, v, out, lse, tq, causal, window, scale):
        self.calls.append(("flash", tuple(lse.shape)))
        out.copy_(REFT.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, sm_scale=scale))
        if lse.numel():
            lse.copy_(REFT.flash_attention_lse_ref(
                q, k, causal=causal, window=window, sm_scale=scale))

    def flash_bwd(self, q, k, v, out, dout, lse, delta, dq, dk, dv, part,
                  tq, n_split, causal, window, scale):
        self.calls.append(("flash_bwd", tuple(delta.shape)))
        for dst, src in zip((dq, dk, dv), REFT.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, causal=causal, window=window,
                sm_scale=scale)):
            dst.copy_(src)


N_SM = 132


@pytest.fixture
def no_card(monkeypatch):
    ext = _PlainExt()
    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(_build, "extension", lambda verbose=False: ext)
    monkeypatch.setattr(_build, "sm_count", lambda device: N_SM)
    monkeypatch.setattr(ops, "_on_cuda", lambda name, q: True)
    return ext


@pytest.mark.parametrize("final", [False, True], ids=["nodstate", "dstate"])
@pytest.mark.parametrize("name", ["g1-4chunks", "g2-3chunks"])
def test_autograd_function_runs_the_backward_kernel(no_card, name, final):
    """With grad enabled, ``ops.ssd_chunked`` on a "CUDA" tensor goes
    through ``SsdChunkedFn``: the forward asks for the chunk states, the
    backward gets them with the gradient of y (and of the final state
    when the loss reads it), and the gradients are the reference's; the
    launch counters move once each."""
    b, s, H, P, G, N, chunk = CASES[name]
    args, dy, dstate = _inputs(b, s, H, P, G, N, seed=11)
    want = _reference(args, dy, dstate if final else None, chunk)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    n_fwd, n_bwd = SSDT.ssd_chunked.launches, SSDT.ssd_chunked_bwd.launches
    y, st = ops.ssd_chunked(*leaves, chunk=chunk)
    y_r, st_r = REFT.ssd_chunked_ref(*(t.detach() for t in leaves), chunk)
    assert torch.equal(y.detach(), y_r) and torch.equal(st.detach(), st_r)
    outs, cots = [y], [torch.tensor(dy)]
    if final:
        outs.append(st)
        cots.append(torch.tensor(dstate))
    grads = torch.autograd.grad(outs, leaves, cots)
    for g, leaf, w, gname in zip(grads, leaves, want, GRADS):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, gname
        _close(g, w, gname)
    nc, ps = s // chunk, SSDT.p_slice(P, b * H, N_SM)
    assert no_card.calls == [
        ("ssd", (b, nc, H, P, N), chunk, ps),
        ("ssd_bwd", (b, nc, H, P, N), (b, nc, H, P, N), (b, s, H, N), final,
         chunk, ps)]
    assert SSDT.ssd_chunked.launches == n_fwd + 1
    assert SSDT.ssd_chunked_bwd.launches == n_bwd + 1


def test_inference_keeps_the_forward_without_states(no_card):
    """Under ``no_grad`` (and for inputs that need no gradient) the
    dispatch calls the forward alone, with no chunk states: the serving
    paths' launch is unchanged."""
    args, _, _ = _inputs(1, 16, 2, 4, 1, 8, seed=5)
    x, dt, A, B, C = (torch.tensor(a) for a in args)
    n_bwd = SSDT.ssd_chunked_bwd.launches
    with torch.no_grad():
        ops.ssd_chunked(x.requires_grad_(), dt, A, B, C, chunk=8)
    ops.ssd_chunked(x.detach(), dt, A, B, C, chunk=8)
    assert [c[:2] for c in no_card.calls] == [("ssd", (0,)), ("ssd", (0,))]
    assert SSDT.ssd_chunked_bwd.launches == n_bwd


@pytest.mark.parametrize("case,match", [
    ("wide_p", "P up to 64"),
    ("states_shape", "states must be"),
    ("states_bf16", "states must be"),
    ("dy_shape", "dy must be"),
    ("dy_bf16", "dy must be"),
    ("dy_strided", "dy must be"),
    ("dy_none", "dy must be"),
    ("dstate_shape", "dstate must be"),
    ("ragged", "multiple of the chunk"),
    ("wide_state", "chunk and N"),
    ("x_f16", "float32 or bfloat16"),
])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(
        case, match, monkeypatch):
    """``ssd_chunked_bwd`` checks what the kernels take before it builds
    or launches: the forward's limits, P up to 64, and the chunk states,
    dy and dstate as f32 tensors of their shapes."""
    def boom(*a, **k):
        raise AssertionError("the wrapper built the extension")
    monkeypatch.setattr(_build, "extension", boom)
    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: N_SM)
    shape = dict(b=1, s=16, H=2, P=8, G=1, N=8)
    chunk = 8
    if case == "wide_p":
        shape["P"] = 128
    if case == "ragged":
        shape["s"] = 20
    if case == "wide_state":
        shape["N"] = 256
    args, dy, dstate = _inputs(**shape, seed=7)
    x, dt, A, B, C = (torch.tensor(a) for a in args)
    b, s, H, P = x.shape
    states = torch.zeros((b, s // chunk, H, P, B.shape[3]))
    dy, dstate = torch.tensor(dy), torch.tensor(dstate)
    if case == "x_f16":
        x, B, C = (t.half() for t in (x, B, C))
    if case == "states_shape":
        states = states[:, :1].contiguous()
    if case == "states_bf16":
        states = states.bfloat16()
    if case == "dy_shape":
        dy = dy[:, :8].contiguous()
    if case == "dy_bf16":
        dy = dy.bfloat16()
    if case == "dy_strided":
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    if case == "dy_none":
        dy = None
    if case == "dstate_shape":
        dstate = dstate[..., :4].contiguous()
    n_bwd = SSDT.ssd_chunked_bwd.launches
    with pytest.raises(ValueError, match=match):
        SSDT.ssd_chunked_bwd(x, dt, A, B, C, states, dy, dstate, chunk=chunk)
    assert SSDT.ssd_chunked_bwd.launches == n_bwd


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_smoke_training_step_through_the_kernels(no_card, arch,
                                                 monkeypatch):
    """One training forward and backward of the SMOKE config: through
    ``SsdChunkedFn`` (and ``FlashAttentionFn`` for the hybrid's shared
    attention) with the plain-version extension, against CPU autograd
    through the plain versions, every parameter's gradient within
    ``TOL_MODEL``.  Full per-layer checkpointing runs each layer's
    forward twice (the forward and the backward's recompute), so each
    Mamba2 layer launches the scan's forward twice and its backward once,
    and each shared-attention application the flash forward twice and
    its backward once."""
    cfg = get_smoke_config(arch)
    assert cfg.remat and cfg.remat_policy == "full"
    b, s = 2, 2 * cfg.ssm_chunk
    rng = np.random.default_rng(1)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                          dtype=torch.int32)
    w = None

    def grads(model):
        nonlocal w
        logits, _ = R.forward(model, {"tokens": tokens}, cfg, train=True)
        if w is None:
            w = torch.tensor(rng.standard_normal(logits.shape)
                             .astype(np.float32))
        loss = (logits.float() * w).sum()
        named = dict(model.named_parameters())
        return dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), materialize_grads=True)))

    counts = (SSDT.ssd_chunked, SSDT.ssd_chunked_bwd, FAT.flash_attention,
              FAT.flash_attention_bwd)
    before = [f.launches for f in counts]
    got = grads(R.init_params(cfg, seed=3, device="cpu").requires_grad_(True))
    moved = [f.launches - n for f, n in zip(counts, before)]
    monkeypatch.undo()
    want = grads(R.init_params(cfg, seed=3, device="cpu")
                 .requires_grad_(True))
    for name, g in want.items():
        _close(got[name], g.numpy(), name, TOL_MODEL)
    shared = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert moved == [2 * cfg.n_layers, cfg.n_layers, 2 * shared, shared]
