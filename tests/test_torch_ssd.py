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
    with pytest.raises(ValueError, match="meta"):
        ops.ssd_chunked(*[a.to("meta") for a in t], chunk=8)


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
