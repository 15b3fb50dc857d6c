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
backward (its split count and the partials' scratch), its refusals and
the dispatch in ``kernels/ops.py``.  Then the backward kernel's walk and
numerics emulated in plain PyTorch (``_emulate_bwd``: its items, splits,
edge masks, the tensor cores' bf16 rounding of P and dS and the split-bf16
products of f32 inputs) against ``jax.vjp``, and the split planner.  The
SSD scan's gradient has its own file, ``test_torch_ssd_bwd.py``.

Tolerance: f32 2e-5 absolute and relative (the sums run in another
order; the gradients are O(1)); the emulated kernel is held to
``chip_smoke.BWD_TOL``, the limit the card's phase 17a holds it to."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as LJ
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FAT
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PAT
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
N_SM = 132                     # the H100's SMs, for the split planner

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

    def flash_bwd(self, q, k, v, out, dout, lse, delta, dq, dk, dv, part,
                  tq, n_split, causal, window, scale):
        self.calls.append(("flash_bwd", delta.shape, part.shape, tq,
                           n_split, causal, window, scale))
        for dst, src in zip((dq, dk, dv), REFT.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, causal=causal, window=window,
                sm_scale=scale)):
            dst.copy_(src)


@pytest.fixture
def no_card(monkeypatch):
    ext = _PlainExt()
    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(_build, "extension", lambda verbose=False: ext)
    monkeypatch.setattr(_build, "sm_count", lambda device: N_SM)
    monkeypatch.setattr(ops, "_on_cuda", lambda name, q: True)
    return ext


@pytest.mark.parametrize("name", ["window-g2", "cross-g1", "causal-g7-ragged",
                                  "causal-g16"])
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
    # a few CTAs: the walk is split where it has 4 items a split
    n_split = PAT.bwd_split_plan(b, sq, skv or sq, H, K, N_SM,
                                 PAT.BWD_CTAS_PER_SM[torch.float32])
    assert n_split == max(1, H // K * -(-sq // 64) // 4)
    # the splits' partials, then q, k, v and dO as bf16 hi / lo (f32)
    nq, nk = b * sq * H * dh, b * (skv or sq) * K * dh
    part = ((2 * n_split * nk if n_split > 1 else 0) + 2 * (nq + nk),)
    assert part == (FAT.bwd_scratch_floats(torch.zeros(nq), torch.zeros(nk),
                                           n_split),)
    assert no_card.calls == [
        ("flash", (b, H, sq), tq, causal, window, dh ** -0.5),
        ("flash_bwd", (b, H, sq), part, tq, n_split, causal, window,
         dh ** -0.5)]
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



# ---------------------------------------------------------------------------
# the backward kernel (csrc/flash_backward.cu), emulated in plain PyTorch
# ---------------------------------------------------------------------------
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # chip_smoke.BWD_TOL
LOG2E = 1.4426950408889634
BLOCK = PAT.BWD_KEYS           # own rows of a CTA; rows of a walk block

# shapes whose walks cross several 64-row blocks (non-edge blocks, several
# items a key block, splits of more than one item), as CASES's do not
WALK_CASES = {
    "causal-g2-3blocks": (1, 150, 0, 4, 2, 16, True, 0),
    "window-g1-ragged": (2, 200, 0, 2, 2, 8, True, 70),
    "full-window-g4": (1, 130, 0, 4, 1, 8, False, 40),
    "cross-g2": (1, 70, 140, 4, 2, 8, False, 0),
    "causal-g16-ragged": (1, 130, 0, 32, 2, 8, True, 0),
}


def _mm(a, b, f32):
    """a @ b as mma.sync computes it: bf16 operands multiplied exactly and
    summed in f32; an f32 operand split into bf16 hi and lo and the
    product taken as hi.hi + hi.lo + lo.hi."""
    if not f32:
        return a.bfloat16().float() @ b.bfloat16().float()
    ah = a.bfloat16().float()
    bh = b.bfloat16().float()
    al = (a - ah).bfloat16().float()
    bl = (b - bh).bfloat16().float()
    return ah @ bl + al @ bh + ah @ bh


def _visible(qi, kp, skv, causal, window):
    ok = kp < skv
    if causal:
        ok = ok & (kp <= qi)
    if window > 0:
        ok = ok & (qi - kp < window)
    return ok


def _rows(x, first, n, limit):
    """(BLOCK, ...) rows first.. of x (rows on dim 0), zero at or past
    ``limit`` — a staged tile."""
    out = x.new_zeros((BLOCK,) + x.shape[1:])
    m = max(0, min(BLOCK, limit - first, n))
    out[:m] = x[first:first + m]
    return out


def _emulate_bwd(q, k, v, o, lse, do, causal, window, n_split=1,
                 partials=False):
    """(dq, dk, dv) as the backward kernel computes them, block by block:
    dK/dV a CTA per (64 keys, KV head, batch row, split) walking its share
    of the group's (head, 64-query block) items, head-major; dQ a CTA per
    forward tile (64 // g queries x g heads) walking the visible key
    blocks; P = exp2(S scale log2e - lse log2e), the mask only on edge
    blocks, dS = P (dP - delta); bf16 inputs round P and dS to bf16 before
    their products, f32 inputs take split-bf16 products (``_mm``).  Rows
    past a walk's range are zero, with lse and delta zero (dK/dV) — they
    add nothing — or lse +inf (dQ).  dK / dV of the splits are summed in
    split order; with ``partials`` their (n_split, ...) f32 sums are
    returned instead."""
    f32 = q.dtype == torch.float32
    b, sq, H, dh = q.shape
    skv, K = k.shape[1], k.shape[2]
    g = H // K
    scale = dh ** -0.5
    sl2 = scale * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)                    # (b, sq, H)
    lse2 = lse.float() * LOG2E                           # (b, H, sq)
    rnd = (lambda t: t) if f32 else (lambda t: t.bfloat16().float())
    ar = torch.arange(BLOCK)
    dk = torch.zeros((n_split, b, skv, K, dh))
    dv = torch.zeros((n_split, b, skv, K, dh))
    for bi in range(b):
        for kvh in range(K):
            for kb in range(0, skv, BLOCK):
                kt = _rows(kf[bi, :, kvh], kb, BLOCK, skv)
                vt = _rows(vf[bi, :, kvh], kb, BLOCK, skv)
                kmax = min(kb + BLOCK, skv) - 1
                qlo = kb if causal else 0
                qhi = min(sq, kmax + window) if window > 0 else sq
                nqb = -(-(qhi - qlo) // BLOCK) if qhi > qlo else 0
                total = g * nqb
                n = min(BLOCK, skv - kb)
                for s in range(n_split):
                    acc_k = torch.zeros((BLOCK, dh))
                    acc_v = torch.zeros((BLOCK, dh))
                    for i in range(total * s // n_split,
                                   total * (s + 1) // n_split):
                        h = kvh * g + i // nqb
                        wb = qlo + (i % nqb) * BLOCK
                        qt = _rows(qf[bi, :, h], wb, BLOCK, qhi)
                        dot = _rows(dof[bi, :, h], wb, BLOCK, qhi)
                        l2 = _rows(lse2[bi, h], wb, BLOCK, qhi)
                        dl = _rows(delta[bi, :, h], wb, BLOCK, qhi)
                        st = _mm(kt, qt.T, f32)                  # keys x q
                        dpt = _mm(vt, dot.T, f32)
                        p = torch.exp2(st * sl2 - l2[None])
                        if (kb + BLOCK > skv
                                or (causal and kb + BLOCK - 1 > wb)
                                or (window > 0
                                    and wb + BLOCK - 1 - kb >= window)):
                            p = torch.where(_visible(
                                wb + ar[None], kb + ar[:, None], skv,
                                causal, window), p, torch.zeros(()))
                        ds = p * (dpt - dl[None])
                        acc_v += _mm(rnd(p), dot, f32)
                        acc_k += _mm(rnd(ds), qt, f32)
                    dk[s, bi, kb:kb + n, kvh] = acc_k[:n] * scale
                    dv[s, bi, kb:kb + n, kvh] = acc_v[:n]
    if partials:
        return dk, dv
    dk_sum, dv_sum = dk[0], dv[0]
    for s in range(1, n_split):
        dk_sum, dv_sum = dk_sum + dk[s], dv_sum + dv[s]
    tq = FAT.flash_queries_per_cta(g)
    dq = torch.zeros((b, sq, H, dh))
    rows_r = torch.arange(BLOCK)
    for bi in range(b):
        for kvh in range(K):
            for q0 in range(0, sq, tq):
                nq = min(tq, sq - q0)
                ok = (rows_r < tq * g) & (rows_r // g < nq)
                qp = torch.where(ok, q0 + rows_r // g, -1)
                heads = kvh * g + rows_r % g
                qi = qp.clamp(min=0)
                qt = torch.where(ok[:, None], qf[bi, qi, heads], 0.0)
                dot = torch.where(ok[:, None], dof[bi, qi, heads], 0.0)
                l2 = torch.where(ok, lse2[bi, heads, qi], torch.inf)
                dl = torch.where(ok, delta[bi, qi, heads], 0.0)
                kv_hi = min(skv, q0 + nq) if causal else skv
                kv_lo = max(q0 - window + 1, 0) if window > 0 else 0
                acc = torch.zeros((BLOCK, dh))
                for kb in range(kv_lo // BLOCK * BLOCK, kv_hi, BLOCK):
                    kt = _rows(kf[bi, :, kvh], kb, BLOCK, skv)
                    vt = _rows(vf[bi, :, kvh], kb, BLOCK, skv)
                    s_ = _mm(qt, kt.T, f32)
                    dp = _mm(dot, vt.T, f32)
                    p = torch.exp2(s_ * sl2 - l2[:, None])
                    if (kb + BLOCK > skv or (causal and kb + BLOCK - 1 > q0)
                            or (window > 0 and q0 + nq - 1 - kb >= window)):
                        vis = (qp[:, None] >= 0) & _visible(
                            qp[:, None], kb + ar[None], skv, causal, window)
                        p = torch.where(vis, p, torch.zeros(()))
                    acc += _mm(rnd(p * (dp - dl[:, None])), kt, f32)
                for r in range(BLOCK):
                    if qp[r] >= 0:
                        dq[bi, qp[r], heads[r]] = acc[r] * scale
    return (dq.to(q.dtype), dk_sum.to(k.dtype), dv_sum.to(v.dtype))


def _emulation_case(shape, dtype, seed):
    """Inputs rounded to ``dtype``, the forward's output and lse as the
    kernel gets them, and the reference's gradients on the same (rounded)
    values by ``jax.vjp``."""
    b, sq, skv, H, K, dh, causal, window = shape
    q, k, v, do = (torch.tensor(t).to(dtype)
                   for t in _inputs(b, sq, skv, H, K, dh, seed))
    args = dict(causal=causal, window=window)
    o = REFT.flash_attention_ref(q, k, v, **args)
    lse = REFT.flash_attention_lse_ref(q, k, **args)
    ref = _reference(*(t.float().numpy() for t in (q, k, v, do)), causal,
                     window)[1:]
    return (q, k, v, o, lse, do), args, ref


def _rel_err(got, want):
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES) + sorted(WALK_CASES))
def test_emulated_kernel_matches_reference_vjp(name, dtype):
    """The kernel's walk and numerics, emulated, give the reference's dq,
    dk and dv within ``BWD_TOL`` of each one's largest magnitude: bf16
    with P and dS rounded to bf16 before their products, f32 as split
    bf16 products (hi.hi + hi.lo + lo.hi, no lo.lo) — the f32 limit holds
    through the cancellation in dP - delta."""
    shape = {**CASES, **WALK_CASES}[name]
    x, args, ref = _emulation_case(shape, dtype, seed=len(name))
    got = _emulate_bwd(*x, **args)
    for g, want, gname in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == dtype
        err = _rel_err(g, want)
        assert err <= BWD_TOL[dtype], (name, gname, err)


@pytest.mark.parametrize("name", ["causal-g2-3blocks", "causal-g16-ragged",
                                  "window-g1-ragged", "window-g16-ragged"])
def test_split_partials_sum_to_the_unsplit_walk(name):
    """The splits' f32 partials of dK and dV, summed split by split (the
    sum kernel's fixed order), equal the unsplit walk's dK / dV at f32
    rounding — at 2 and 3 splits and at the count the planner gives these
    shapes on the H100 — and every split's share is disjoint: their sum
    holds each (head, query block) item once."""
    shape = {**CASES, **WALK_CASES}[name]
    b, sq, skv, H, K, _, _, _ = shape
    x, args, _ = _emulation_case(shape, torch.float32, seed=3)
    one_k, one_v = _emulate_bwd(*x, **args, partials=True)
    n_plan = PAT.bwd_split_plan(b, sq, skv or sq, H, K, N_SM,
                                PAT.BWD_CTAS_PER_SM[torch.float32])
    for n_split in sorted({2, 3, n_plan} - {1}):
        pk, pv = _emulate_bwd(*x, **args, n_split=n_split, partials=True)
        sk, sv = pk[0], pv[0]
        for s in range(1, n_split):
            sk, sv = sk + pk[s], sv + pv[s]
        for got, want in ((sk, one_k[0]), (sv, one_v[0])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                       atol=TOL * want.abs().max().item())


@pytest.mark.parametrize("shape,f32,bf16", [
    # qwen3-1.7b's training step 4 x 1024, 16 heads over 8: 512 CTAs
    ((4, 1024, 1024, 16, 8), 1, 1),
    # gemma3 1400, 32 heads over 16: 352 CTAs
    ((1, 1400, 1400, 32, 16), 1, 1),
    # glm4 1400, g = 16 over 2 KV heads: 44 CTAs -> 264 / 528
    ((1, 1400, 1400, 32, 2), 6, 12),
    # qwen2 1400, g = 7 over 2: 44 -> 264 / 528
    ((1, 1400, 1400, 14, 2), 6, 12),
    # a rank of phase 20a's (2, 2) mesh: 2 x 512, 8 heads over 4: 64 ->
    # 256, the walk's 16 items in 4 splits of 4
    ((2, 512, 512, 8, 4), 4, 4),
    # a walk shorter than the split the grid wants: 8 items, 2 splits
    ((1, 256, 256, 2, 1), 2, 2),
    # a walk of 3 items is not split
    ((1, 64, 64, 3, 1), 1, 1),
])
def test_bwd_split_plan(shape, f32, bf16):
    """The dK/dV grid's split count from shapes alone: 1 where b x K x
    cdiv(skv, 64) CTAs fill the card's 132 SMs at its CTAs an SM (one f32,
    two bf16), else enough splits for two waves (glm4's 44 and the rank
    shape's 64 CTAs come out above 132), with at least 4 of the longest
    walk's items a split."""
    b, sq, skv, H, K = shape
    ctas = b * K * -(-skv // 64)
    for dtype, n_split in ((torch.float32, f32), (torch.bfloat16, bf16)):
        per_sm = PAT.BWD_CTAS_PER_SM[dtype]
        got = PAT.bwd_split_plan(b, sq, skv, H, K, N_SM, per_sm)
        assert got == n_split, dtype
        assert (ctas >= per_sm * N_SM or ctas * got > N_SM
                or got == max(1, H // K * -(-sq // 64) // 4))
