"""The gradient of the contiguous flash attention on the port, against the
reference's on the CPU: ``kernels/ref.py::flash_attention_bwd_ref`` (the
backward kernel's formulas step by step, ``csrc/flash_backward.cu``) and
autograd through ``flash_attention_ref`` (the CPU path and the card's
oracle), both against ``jax.vjp`` of the reference model path's
``blocked_attention`` (the reference trains through it; it has no Pallas
backward), on the same numpy inputs: causal, windowed, full and cross
(sq != skv), groups of 1, 2, 7 and 16 heads, ragged lengths.  Then the
wrapper and its autograd Function on CPU tensors with the device check
and the build patched out (an extension that computes with the plain
versions): the lse it asks the forward for, the arguments it hands the
backward, its refusals and the dispatch in ``kernels/ops.py``.  The SSD
scan's gradient has its own file, ``test_torch_ssd_bwd.py``.

Tolerance: f32 2e-5 absolute and relative (the sums run in another
order; the gradients are O(1))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as LJ
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FAT
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REFT


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


TOL = 2e-5

# (b, sq, skv, H, K, dh, causal, window): skv 0 = self-attention
CASES = {
    "causal-g2": (2, 24, 0, 4, 2, 8, True, 0),
    "window-g2": (1, 40, 0, 4, 2, 16, True, 7),
    "full-g1": (2, 19, 0, 3, 3, 8, False, 0),
    "cross-g1": (2, 12, 29, 2, 2, 8, False, 0),
    "causal-g7-ragged": (1, 37, 0, 7, 1, 16, True, 0),
    "causal-g16": (1, 20, 0, 32, 2, 4, True, 0),
    "window-g16-ragged": (1, 33, 0, 16, 1, 8, True, 5),
}


def _inputs(b, sq, skv, H, K, dh, seed):
    rng = np.random.default_rng(seed)
    skv = skv or sq
    return (rng.standard_normal((b, sq, H, dh)).astype(np.float32),
            rng.standard_normal((b, skv, K, dh)).astype(np.float32),
            rng.standard_normal((b, skv, K, dh)).astype(np.float32),
            rng.standard_normal((b, sq, H, dh)).astype(np.float32))


def _reference(q, k, v, do, causal, window):
    """(o, dq, dk, dv) of the reference's blocked_attention by jax.vjp."""
    f = lambda q, k, v: LJ.blocked_attention(
        q, k, v, causal=causal, window=window if window > 0 else None)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(o),) + tuple(np.asarray(g)
                                    for g in vjp(jnp.asarray(do)))


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    b, sq, skv, H, K, dh, causal, window = CASES[request.param]
    x = _inputs(b, sq, skv, H, K, dh, seed=len(request.param))
    return x, causal, window, _reference(*x, causal, window)


def test_backward_formulas_match_reference_vjp(case):
    """``flash_attention_bwd_ref`` on the forward's output and lse gives
    the reference's dq, dk and dv."""
    (q, k, v, do), causal, window, (o_j, dq_j, dk_j, dv_j) = case
    q, k, v, do = (torch.tensor(t) for t in (q, k, v, do))
    args = dict(causal=causal, window=window)
    o = REFT.flash_attention_ref(q, k, v, **args)
    _close(o, o_j, "o")
    lse = REFT.flash_attention_lse_ref(q, k, **args)
    dq, dk, dv = REFT.flash_attention_bwd_ref(q, k, v, o, lse, do, **args)
    _close(dq, dq_j, "dq")
    _close(dk, dk_j, "dk")
    _close(dv, dv_j, "dv")


def test_cpu_autograd_matches_reference_vjp(case):
    """``ops.flash_attention`` on CPU tensors differentiates through the
    plain version: the card's oracle, and the CPU training path."""
    (q, k, v, do), causal, window, (o_j, dq_j, dk_j, dv_j) = case
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    _close(o, o_j, "o")
    grads = torch.autograd.grad(o, leaves, torch.tensor(do))
    for g, want, name in zip(grads, (dq_j, dk_j, dv_j), ("dq", "dk", "dv")):
        _close(g, want, name)


def test_lse_is_the_rows_log_sum_exp():
    """The lse the forward writes: softmax(S) = exp(S - lse) on the visible
    keys, so the probabilities rebuilt from it sum to 1 a row."""
    q, k, _, _ = _inputs(2, 21, 0, 4, 2, 8, seed=3)
    q, k = torch.tensor(q), torch.tensor(k)
    lse = REFT.flash_attention_lse_ref(q, k, causal=True, window=6)
    s = torch.einsum("bqkgd,bnkd->bkgqn", q.reshape(2, 21, 2, 2, 8),
                     k) * 8 ** -0.5
    mask = REFT._flash_mask(21, 21, True, 6, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(2, 2, 2, 21)[..., None]),
                    0.0)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the wrapper and the autograd Function, on CPU tensors
# ---------------------------------------------------------------------------
class _PlainExt:
    """Stands in for the built extension: the flash forward and backward
    computed by the plain versions, each call recorded."""

    def __init__(self):
        self.calls = []

    def flash(self, q, k, v, out, lse, tq, causal, window, scale):
        self.calls.append(("flash", lse.shape, tq, causal, window, scale))
        out.copy_(REFT.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, sm_scale=scale))
        if lse.numel():
            lse.copy_(REFT.flash_attention_lse_ref(
                q, k, causal=causal, window=window, sm_scale=scale))

    def flash_bwd(self, q, k, v, out, dout, lse, delta, dq, dk, dv, tq,
                  causal, window, scale):
        self.calls.append(("flash_bwd", delta.shape, tq, causal, window,
                           scale))
        for dst, src in zip((dq, dk, dv), REFT.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, causal=causal, window=window,
                sm_scale=scale)):
            dst.copy_(src)


@pytest.fixture
def no_card(monkeypatch):
    ext = _PlainExt()
    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(_build, "extension", lambda verbose=False: ext)
    monkeypatch.setattr(ops, "_on_cuda", lambda name, q: True)
    return ext


@pytest.mark.parametrize("name", ["window-g2", "cross-g1", "causal-g7-ragged"])
def test_autograd_function_runs_the_backward_kernel(no_card, name):
    """With grad enabled, ``ops.flash_attention`` on a "CUDA" tensor goes
    through ``FlashAttentionFn``: the forward asks for the lse, the
    backward gets the forward's output and lse with the flags, and the
    gradients are the reference's; the launch counters move once each."""
    b, sq, skv, H, K, dh, causal, window = CASES[name]
    q, k, v, do = _inputs(b, sq, skv, H, K, dh, seed=11)
    o_j, dq_j, dk_j, dv_j = _reference(q, k, v, do, causal, window)
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    n_fwd, n_bwd = FAT.flash_attention.launches, \
        FAT.flash_attention_bwd.launches
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    grads = torch.autograd.grad(o, leaves, torch.tensor(do))
    _close(o, o_j, "o")
    for g, leaf, want, gname in zip(grads, leaves, (dq_j, dk_j, dv_j),
                                    ("dq", "dk", "dv")):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, gname
        _close(g, want, gname)
    tq = FAT.flash_queries_per_cta(H // K)
    assert no_card.calls == [
        ("flash", (b, H, sq), tq, causal, window, dh ** -0.5),
        ("flash_bwd", (b, H, sq), tq, causal, window, dh ** -0.5)]
    assert FAT.flash_attention.launches == n_fwd + 1
    assert FAT.flash_attention_bwd.launches == n_bwd + 1


def test_inference_keeps_the_forward_without_lse(no_card):
    """Under ``no_grad`` (and for inputs that need no gradient) the
    dispatch calls the forward alone, with no lse: the serving paths'
    launch is unchanged."""
    q, k, v, _ = (torch.tensor(t) for t in _inputs(1, 16, 0, 4, 2, 8, 5))
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    ops.flash_attention(q.detach(), k, v)
    assert [c[:2] for c in no_card.calls] == [("flash", (0,)),
                                              ("flash", (0,))]


def test_backward_wrapper_refuses_what_the_kernel_does_not_take(no_card):
    q, k, v, do = (torch.tensor(t) for t in _inputs(1, 16, 0, 4, 2, 8, 6))
    out = torch.zeros_like(q)
    lse = torch.zeros((1, 4, 16))
    FAT.flash_attention_bwd(q, k, v, out, lse, do)          # accepted
    with pytest.raises(ValueError, match="lse must be"):
        FAT.flash_attention_bwd(q, k, v, out, lse[:, :, :8], do)
    with pytest.raises(ValueError, match="lse must be"):
        FAT.flash_attention_bwd(q, k, v, out, lse.double(), do)
    with pytest.raises(ValueError, match="out and dout"):
        FAT.flash_attention_bwd(q, k, v, out, lse, do[:, :8])
    with pytest.raises(ValueError, match="out and dout"):
        FAT.flash_attention_bwd(q, k, v, out, lse, do.bfloat16())
    with pytest.raises(ValueError, match="out and dout"):
        FAT.flash_attention_bwd(q, k, v, out, lse,
                                do.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FAT.flash_attention_bwd(q.half(), k.half(), v.half(), out.half(),
                                lse, do.half())
    with pytest.raises(ValueError, match="dh divisible by 4"):
        FAT.flash_attention_bwd(q[..., :6].contiguous(),
                                k[..., :6].contiguous(),
                                v[..., :6].contiguous(),
                                out[..., :6].contiguous(), lse,
                                do[..., :6].contiguous())
    big = torch.zeros((1, 4, 65, 8))                        # g = 65 > 64
    with pytest.raises(ValueError, match="g <= 64"):
        FAT.flash_attention_bwd(big, k[:, :, :1].contiguous(),
                                v[:, :, :1].contiguous(), big,
                                torch.zeros((1, 65, 4)), big)

