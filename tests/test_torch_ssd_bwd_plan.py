"""The SSD scan's backward kernel (``csrc/ssd_backward.cu``) on the CPU:
its head-block planner (``kernels/ssd_scan.py::ssd_bwd_plan``) at the
card's shapes, and its arithmetic emulated in plain PyTorch
(``_emulate_bwd``: C·Bᵀ once per group, three bf16 parts a side for f32;
the reverse state pass as one split-bf16 product a chunk; the chunk pass
walking blocks of ``hb`` heads, M summed over a block before its products
with B and C, o from the change of Σ_n dC·C, r from B·dh1ᵀ; every f32
operand split into bf16 hi + lo, hi·hi + hi·lo + lo·hi, against a bf16
operand hi·b + lo·b) against ``jax.vjp`` of the reference's ``ssd_ref`` at
a mamba2-like width.

Tolerance: ``chip_smoke.SSD_BWD_TOL`` (f32 1e-4, bf16 2e-2 of each
gradient's largest magnitude), the limit the card's phase 17a holds the
kernel to; the emulation reads up to 1.9e-5 in f32 (ddt) and 3.6e-3 in
bf16 (dC, rounded to bf16), with blocks of 1, 2 or 4 heads alike (the
block moves only f32 dB and dC, within 8e-6 to 1.4e-5)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as SSMJ
from repro_torch.kernels import ref as REFT
from repro_torch.kernels import ssd_scan as SSDT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run this file's small tensor ops on one thread (see
    ``test_torch_train_flash.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # chip_smoke's
N_SM = 132                     # the H100's SMs


# (b, s, H, G, chunk): chip_smoke's SSD_BWD_CASES and the grouped shape,
# with the hb the planner gives on 132 SMs
PLAN_CASES = {
    "mamba2-4x1024": ((4, 1024, 80, 1, 128), 10),
    "zamba2-4x1024": ((4, 1024, 80, 1, 128), 10),
    "mamba2-1x4096": ((1, 4096, 80, 1, 128), 10),
    "g2-2x1024": ((2, 1024, 80, 2, 128), 5),
    "grouped-2x2048": ((2, 2048, 80, 8, 128), 10),
    "smoke-2x64": ((2, 64, 16, 1, 8), 1),
    "one-row-chunk": ((1, 128, 80, 1, 128), 1),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_ssd_bwd_plan(name):
    """hb divides the group's heads, stays within the kernel's limit, and
    its CTAs fill the card's SMs (where there are that many (row, chunk,
    head) items) in the fewest waves x (hb + 1) of any such divisor."""
    (b, s, H, G, chunk), want = PLAN_CASES[name]
    hb = SSDT.ssd_bwd_plan(b, s, H, G, chunk, N_SM)
    assert hb == want
    hpg = H // G
    assert hpg % hb == 0 and 1 <= hb <= SSDT.SSD_BWD_MAX_HEADS
    units = b * (s // chunk) * H
    assert units // hb >= min(units, N_SM)

    def cost(h):
        return -(-(units // h) // N_SM) * (h + 1)
    for h in range(1, SSDT.SSD_BWD_MAX_HEADS + 1):
        if hpg % h == 0 and units // h >= min(units, N_SM):
            assert cost(hb) <= cost(h)


def _split(a):
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _mm(a, b, split_a=True, split_b=True):
    """a @ b as mma.sync takes it: bf16 parts multiplied exactly and
    summed in f32; an f32 operand split into hi + lo, hi.hi + hi.lo +
    lo.hi; a bf16 operand (``split_*`` False) as it is."""
    ah, al = _split(a) if split_a else (a, None)
    bh, bl = _split(b) if split_b else (b, None)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def _split3(a):
    h = a.bfloat16().float()
    m = (a - h).bfloat16().float()
    return h, m, (a - h - m).bfloat16().float()


def _emulate_bwd(x, dt, A, B, C, states, dy, dstate, chunk, hb):
    """(dx, ddt, dA, dB, dC) as the kernels compute them (see the module
    docstring), in x's, dt's, A's, B's and C's types."""
    f32 = x.dtype == torch.float32
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, hpg = s // chunk, H // G
    xf, Bf, Cf = x.float(), B.float(), C.float()
    cum = torch.cumsum((dt.double() * A.double()).reshape(b, nc, chunk, H), 2)
    ecum = torch.exp(cum).float()
    w = torch.exp(cum[:, :, -1:] - cum).float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    dx = torch.zeros(b, s, H, P)
    ddt = torch.zeros(b, s, H)
    dA_part = torch.zeros(b, nc, H)
    dB = torch.zeros(b, s, G, N)
    dC = torch.zeros(b, s, G, N)
    # (K2) the reverse state pass
    dh1 = torch.zeros(b, nc, H, P, N)
    for bi in range(b):
        for h in range(H):
            d = torch.zeros(P, N) if dstate is None else dstate[bi, h].clone()
            for k in reversed(range(nc)):
                dh1[bi, k, h] = d
                if k == 0:
                    break
                rows = slice(k * chunk, (k + 1) * chunk)
                ed = ecum[bi, k, :, h, None] * dy[bi, rows, h]
                d = ecum[bi, k, -1, h] * d + _mm(ed.T, Cf[bi, rows, h // hpg],
                                                 True, f32)
    for bi in range(b):
        for k in range(nc):
            rows = slice(k * chunk, (k + 1) * chunk)
            for g in range(G):
                Bk, Ck = Bf[bi, rows, g], Cf[bi, rows, g]
                # (K1) S once per group
                if f32:
                    c3, b3 = _split3(Ck), _split3(Bk.T)
                    S = sum(c3[i] @ b3[j] for i in range(3) for j in range(3)
                            if i + j <= 2)
                else:
                    S = Ck @ Bk.T
                # (K3) blocks of hb heads
                for first in range(g * hpg, (g + 1) * hpg, hb):
                    Msum = torch.zeros(chunk, chunk)
                    accC = torch.zeros(chunk, N)
                    accB = torch.zeros(chunk, N)
                    q = torch.zeros(chunk)
                    for h in range(first, first + hb):
                        ck = cum[bi, k, :, h]
                        L = torch.where(tri, torch.exp(
                            (ck[:, None] - ck[None, :]).float()), 0.0)
                        dtk, xk, dyk = dt[bi, rows, h], xf[bi, rows, h], \
                            dy[bi, rows, h]
                        e, wk = ecum[bi, k, :, h], w[bi, k, :, h]
                        h0, d1 = states[bi, k, h], dh1[bi, k, h]
                        # phase A
                        M = torch.where(tri, _mm(dyk, xk.T, True, f32)
                                        * dtk[None, :] * L, 0.0)
                        R = S * M
                        Msum = Msum + M
                        accC = accC + _mm(e[:, None] * dyk, h0)
                        qn = (accC * Ck).sum(1)
                        pre = R.sum(1) + (qn - q) - R.sum(0)
                        q = qn
                        # phase B
                        bdh = _mm(Bk, d1.T, f32, True)
                        r = wk * dtk * (xk * bdh).sum(1)
                        dX = wk[:, None] * bdh + _mm((S * L).T, dyk)
                        accB = accB + _mm((wk * dtk)[:, None] * xk, d1)
                        dcum = pre - r
                        dcum[-1] += e[-1] * (d1 * h0).sum() + r.sum()
                        da = torch.flip(torch.cumsum(torch.flip(dcum, (0,)),
                                                     0), (0,))
                        ddt[bi, rows, h] = (xk * dX).sum(1) + A[h] * da
                        dA_part[bi, k, h] = (dtk * da).sum()
                        dx[bi, rows, h] = dtk[:, None] * dX
                    dC[bi, rows, g] += accC + _mm(Msum, Bk, True, f32)
                    dB[bi, rows, g] += accB + _mm(Msum.T, Ck, True, f32)
    return (dx.to(x.dtype), ddt, dA_part.sum((0, 1)), dB.to(B.dtype),
            dC.to(C.dtype))


@functools.partial(jax.jit, static_argnames="chunk")
def _vjp(args, cots, chunk):
    _, vjp = jax.vjp(lambda *a: SSMJ.ssd_ref(*a, chunk=chunk), *args)
    return vjp(cots)


@functools.lru_cache(maxsize=None)
def _vjp_case(dtype):
    """The inputs at a mamba2-like width (b 1, s 256, H 4 in one group, P
    64, N 128, chunk 128) with cotangents of y and of the final state, the
    chunk states, and ``jax.vjp``'s five gradients (bf16: x, B and C
    rounded, the reference given the rounded values)."""
    b, s, H, P, G, N, chunk = 1, 256, 4, 64, 1, 128, 128
    rng = np.random.default_rng(29)
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)))).astype(np.float32)
    A = (-np.linspace(1.0, 16.0, H)).astype(np.float32)
    B = rng.standard_normal((b, s, G, N)).astype(np.float32)
    C = rng.standard_normal((b, s, G, N)).astype(np.float32)
    dy = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dstate = rng.standard_normal((b, H, P, N)).astype(np.float32)
    t = [torch.tensor(a) for a in (x, dt, A, B, C)]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    args = [a.float().numpy() for a in t]
    want = [np.asarray(g) for g in _vjp(tuple(jnp.asarray(a) for a in args),
                                        (jnp.asarray(dy), jnp.asarray(dstate)),
                                        chunk)]
    _, _, states = REFT.ssd_chunked_ref(*t, chunk, return_states=True)
    return t, states, torch.tensor(dy), torch.tensor(dstate), want, chunk


@pytest.mark.parametrize("hb", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_matches_reference_vjp(dtype, hb):
    """At a mamba2-like width (``_vjp_case``), in blocks of 1, 2 or 4 heads
    (the block changes the order of the sums over its heads, and o is the
    difference of two running sums over them), the emulated kernels' five
    gradients are within ``SSD_BWD_TOL`` of ``jax.vjp`` on the same
    inputs."""
    t, states, dy, dstate, want, chunk = _vjp_case(dtype)
    got = _emulate_bwd(*t, states, dy, dstate, chunk, hb=hb)
    for g, leaf, w_, name in zip(got, t, want, ("dx", "ddt", "dA", "dB",
                                                  "dC")):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        err = np.abs(g.float().numpy() - w_).max() / np.abs(w_).max()
        assert err <= SSD_BWD_TOL[dtype], (name, err)
