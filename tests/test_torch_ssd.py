"""The port's plain SSD scan (``kernels/ref.py`` ``ssd_chunked_ref``) against
the reference's Pallas kernel (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its ``ssd_ref`` oracle on the same
numpy inputs; against the token-by-token recurrence; the CPU dispatch of
``kernels/ops.py``; and the CUDA wrapper's refusals, which come before any
build.

Tolerances: 2e-3 against the Pallas kernel and ``ssd_ref`` (the JAX
suite's own kernel tolerance: the chunked form sums in another order and
exp() turns the rounding of cumsum(dt·A) into relative error); 3e-4
against the sequential recurrence (the JAX suite's tolerance for the same
check).  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against this plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as OPSJ
from repro.models import ssm as SSMJ
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REFT
from repro_torch.kernels import ssd_scan as SSDT

TOL_CHUNKED = 2e-3
TOL_SEQUENTIAL = 3e-4


def _inputs(b, s, H, P, G, N, seed=0):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(N(0, 1)) — the
    distributions of ``tests/test_kernels.py``'s sweep, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)))).astype(np.float32)
    B = rng.standard_normal((b, s, G, N)).astype(np.float32)
    C = rng.standard_normal((b, s, G, N)).astype(np.float32)
    return x, dt, A, B, C


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# the shapes of tests/test_kernels.py::test_ssd_kernel_sweep
SWEEP = [(2, 64, 4, 8, 2, 16, 16), (1, 128, 2, 64, 1, 64, 32),
         (2, 96, 3, 16, 3, 8, 24), (1, 256, 2, 32, 1, 128, 128)]


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SWEEP)
def test_plain_matches_pallas_kernel(b, s, H, P, G, N, chunk):
    arrs = _inputs(b, s, H, P, G, N)
    y_j, st_j = OPSJ.ssd_chunked(*(jnp.asarray(a) for a in arrs),
                                 chunk=chunk)
    y_t, st_t = REFT.ssd_chunked_ref(*(torch.tensor(a) for a in arrs),
                                     chunk)
    _close(y_t, y_j, TOL_CHUNKED)
    _close(st_t, st_j, TOL_CHUNKED)


@pytest.mark.parametrize("b,s,H,P,G,N,chunk", SWEEP)
def test_plain_matches_reference_ssd_ref(b, s, H, P, G, N, chunk):
    arrs = _inputs(b, s, H, P, G, N, seed=1)
    y_j, st_j = SSMJ.ssd_ref(*(jnp.asarray(a) for a in arrs), chunk)
    y_t, st_t = REFT.ssd_chunked_ref(*(torch.tensor(a) for a in arrs),
                                     chunk)
    _close(y_t, y_j, TOL_CHUNKED)
    _close(st_t, st_j, TOL_CHUNKED)


def test_plain_with_initial_state_matches_reference():
    """``init_state`` carries a state in, as the reference's ``ssd_ref``."""
    arrs = _inputs(2, 48, 4, 8, 2, 16, seed=2)
    h0 = np.random.default_rng(3).standard_normal(
        (2, 4, 8, 16)).astype(np.float32)
    y_j, st_j = SSMJ.ssd_ref(*(jnp.asarray(a) for a in arrs), 16,
                             init_state=jnp.asarray(h0))
    y_t, st_t = REFT.ssd_chunked_ref(*(torch.tensor(a) for a in arrs), 16,
                                     init_state=torch.tensor(h0))
    _close(y_t, y_j, TOL_CHUNKED)
    _close(st_t, st_j, TOL_CHUNKED)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunked_equals_sequential_recurrence(chunk):
    """The chunked dual form equals the exact token-by-token recurrence, and
    the port's recurrence equals the reference's."""
    arrs = _inputs(2, 48, 4, 8, 2, 16, seed=4)
    t = [torch.tensor(a) for a in arrs]
    y1, s1 = REFT.ssd_chunked_ref(*t, chunk)
    y2, s2 = REFT.ssd_sequential_ref(*t)
    _close(y1, y2.numpy(), TOL_SEQUENTIAL)
    _close(s1, s2.numpy(), TOL_SEQUENTIAL)
    y_j, s_j = SSMJ.ssd_sequential_ref(*(jnp.asarray(a) for a in arrs))
    _close(y2, y_j, TOL_SEQUENTIAL)
    _close(s2, s_j, TOL_SEQUENTIAL)


def test_plain_takes_bf16_inputs_in_f32():
    """bf16 x, B, C are widened to f32: the result equals the f32 scan of
    the same (rounded) values exactly."""
    x, dt, A, B, C = (torch.tensor(a) for a in _inputs(1, 32, 2, 8, 1, 8))
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    y1, s1 = REFT.ssd_chunked_ref(xb, dt, A, Bb, Cb, 8)
    y2, s2 = REFT.ssd_chunked_ref(xb.float(), dt, A, Bb.float(), Cb.float(),
                                  8)
    assert y1.dtype == s1.dtype == torch.float32
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ops_on_cpu_take_the_plain_version_and_launch_nothing():
    before = SSDT.ssd_chunked.launches
    t = [torch.tensor(a) for a in _inputs(2, 32, 4, 8, 2, 8)]
    y, st = ops.ssd_chunked(*t, chunk=8)
    y_r, st_r = REFT.ssd_chunked_ref(*t, 8)
    assert torch.equal(y, y_r) and torch.equal(st, st_r)
    assert SSDT.ssd_chunked.launches == before
    # meta tensors (the dry run's abstract steps): the plain version's
    # shapes, no launch
    y_m, st_m = ops.ssd_chunked(*[a.to("meta") for a in t], chunk=8)
    assert y_m.is_meta and y_m.shape == y.shape and st_m.shape == st.shape
    assert SSDT.ssd_chunked.launches == before


def test_plain_refuses_a_ragged_sequence():
    t = [torch.tensor(a) for a in _inputs(1, 20, 2, 8, 1, 8)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_chunked(*t, chunk=8)


def _no_build(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the wrapper built the extension")
    monkeypatch.setattr(_build, "extension", boom)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("ragged", "multiple of the chunk"),
    ("x_f16", "float32 or bfloat16"),
    ("mixed", "x's dtype"),
    ("dt_bf16", "dt and A must be float32"),
    ("shape", "dt must be"),
    ("groups", "G dividing"),
    ("wide_state", "chunk and N"),
    ("odd_p", "chunk and N"),
])
def test_wrapper_refuses_before_any_build(case, match, monkeypatch):
    """The CUDA wrapper checks what the kernel takes before it builds or
    launches: CPU tensors, a sequence that is not a multiple of the chunk,
    types, shapes and the kernel's limits."""
    _no_build(monkeypatch)
    before = SSDT.ssd_chunked.launches
    shape = dict(b=1, s=32, H=4, P=8, G=2, N=8)
    chunk = 8
    if case == "ragged":
        shape["s"] = 36
    if case == "groups":
        shape["G"] = 3
    if case == "wide_state":
        shape["N"] = 256
    if case == "odd_p":
        shape["P"] = 6
    x, dt, A, B, C = (torch.tensor(a) for a in _inputs(**shape))
    if case == "x_f16":
        x, B, C = (t.half() for t in (x, B, C))
    if case == "mixed":
        B = B.to(torch.bfloat16)
    if case == "dt_bf16":
        dt = dt.to(torch.bfloat16)
    if case == "shape":
        dt = dt[:, :-1]
    with pytest.raises(ValueError, match=match):
        SSDT.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    assert SSDT.ssd_chunked.launches == before


@pytest.mark.parametrize("P,want", [(8, 8), (64, 64), (128, 64)])
def test_p_slice_of_a_cta(P, want):
    """A CTA takes all of P up to 64 columns, else 64 of them."""
    assert SSDT.p_slice(P) == want


# =============================================================================
# the CUDA kernel's tensor-core arithmetic (csrc/ssd_scan.cu), emulated in
# torch: bf16 MMA operands, f32 sums, in the kernel's chunk order
# =============================================================================
# chip_smoke.SSD_TOL: the kernel's y and state against the f32 scan, as a
# fraction of max |reference|
SSD_TOL = 2e-4


def _split(a: torch.Tensor):
    """An f32 operand as the kernel feeds it: hi = bf16(a), lo = bf16(a -
    hi), each widened back to f32."""
    hi = a.to(torch.bfloat16).float()
    return [hi, (a - hi).to(torch.bfloat16).float()]


def _once(a: torch.Tensor):
    return [a.to(torch.bfloat16).float()]


def _mma(a_parts, b_parts):
    """The products the kernel runs for split operands: hi.hi, plus hi.lo
    where b is split, plus lo.hi where a is (no lo.lo).  bf16 values in
    f32 tensors, so each product is exact and the sums are f32."""
    out = a_parts[0] @ b_parts[0]
    if len(b_parts) > 1:
        out = out + a_parts[0] @ b_parts[1]
    if len(a_parts) > 1:
        out = out + a_parts[1] @ b_parts[0]
    return out


def _t(parts):
    return [p.transpose(-1, -2) for p in parts]


def ssd_tensor_core_emulation(x, dt, A, B, C, chunk, *, round_x=False,
                              round_state=False):
    """The kernel's four products per chunk: S = C.B^T (one exact MMA for
    bf16 B and C, three for f32), Y = split(S * L) . split(X) + exp(cum)
    (C . split(state)^T), and state = exp(cum_last) (hi + lo) + split(X
    decay)^T . B, the state re-split every chunk.  ``round_x`` and
    ``round_state`` round X = x dt or the state to bf16 once instead."""
    b, s, H, P = x.shape
    hpg = H // B.shape[2]
    exact = x.dtype == torch.bfloat16
    xh = x.float().permute(0, 2, 1, 3)                       # (b, H, s, P)
    dth = dt.float().permute(0, 2, 1)                        # (b, H, s)
    Bh = B.float().repeat_interleave(hpg, 2).permute(0, 2, 1, 3)
    Ch = C.float().repeat_interleave(hpg, 2).permute(0, 2, 1, 3)
    state = torch.zeros(b, H, P, B.shape[3])
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        X = xh[:, :, sl] * dth[:, :, sl, None]
        Xp = _once(X) if round_x else _split(X)
        cum = torch.cumsum(dth[:, :, sl] * A[None, :, None], -1)
        Cp = [Ch[:, :, sl]] if exact else _split(Ch[:, :, sl])
        Bp = [Bh[:, :, sl]] if exact else _split(Bh[:, :, sl])
        L = torch.exp(cum[..., :, None] - cum[..., None, :]).tril()
        Y = _mma(_split(_mma(Cp, _t(Bp)) * L), Xp)
        sp = _once(state) if round_state else _split(state)
        Y = Y + torch.exp(cum)[..., None] * _mma(Cp, _t(sp))
        Xd = _split(sum(Xp) * torch.exp(cum[..., -1:] - cum)[..., None])
        state = (torch.exp(cum[..., -1])[..., None, None] * sum(sp)
                 + _mma(_t(Xd), Bp))
        ys.append(Y)
    return torch.cat(ys, 2).permute(0, 2, 1, 3), state


def _emulation_case(G, dtype, seed=11):
    """mamba2-like widths (4 heads of 64, N 128, chunk 128, 512 positions);
    dt = softplus(N(0, 1)) and A = -linspace(1, 16), the models' init, so
    the state carries across chunks in the slowest heads.  Returns the
    Pallas kernel's (y, state) and the torch inputs in ``dtype``."""
    rng = np.random.default_rng(seed)
    b, s, H, P, N = 2, 512, 4, 64, 128
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    B = rng.standard_normal((b, s, G, N)).astype(np.float32)
    C = rng.standard_normal((b, s, G, N)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    y_j, st_j = OPSJ.ssd_chunked(jnp.asarray(x, jd), jnp.asarray(dt),
                                 jnp.asarray(A), jnp.asarray(B, jd),
                                 jnp.asarray(C, jd), chunk=128)
    td = getattr(torch, dtype)
    args = (torch.tensor(x).to(td), torch.tensor(dt), torch.tensor(A),
            torch.tensor(B).to(td), torch.tensor(C).to(td))
    return (torch.tensor(np.asarray(y_j)), torch.tensor(np.asarray(st_j))), \
        args


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_tensor_core_emulation_matches_pallas_kernel(G, dtype):
    """The kernel's split-operand products hold y and the state to the
    Pallas kernel within chip_smoke's SSD_TOL (readings ~1e-5)."""
    (y_j, st_j), args = _emulation_case(G, dtype)
    y, st = ssd_tensor_core_emulation(*args, 128)
    assert _rel_err(y, y_j) <= SSD_TOL
    assert _rel_err(st, st_j) <= SSD_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", ["round_x", "round_state"])
def test_rounding_an_f32_operand_once_fails_the_limit(fault, dtype):
    """X = x dt or the state rounded to bf16 once (no lo part) misses the
    limit the split keeps (readings 3.6e-4 to 2.8e-3): the reason every
    f32 operand is split."""
    (y_j, st_j), args = _emulation_case(1, dtype)
    y, st = ssd_tensor_core_emulation(*args, 128, **{fault: True})
    assert max(_rel_err(y, y_j), _rel_err(st, st_j)) > SSD_TOL


@pytest.mark.parametrize("P,bh,n_sm,want", [
    (64, 80, 132, 32), (64, 320, 132, 64), (64, 160, 132, 64),
    (128, 80, 132, 64), (128, 40, 132, 32), (8, 1, 132, 8),
    (32, 1, 132, 32)])
def test_p_slice_halves_when_the_ctas_leave_sms_idle(P, bh, n_sm, want):
    """At mamba2's batch 1 (80 heads) 64-column slices leave 52 of 132 SMs
    idle, so a CTA takes 32 columns; larger grids and narrow P keep
    theirs."""
    assert SSDT.p_slice(P, bh, n_sm) == want
