"""Mamba2 SSD chunked scan — the hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``) that replaces the reference's Pallas TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_chunked``.

Per chunk of ``chunk`` positions it computes the within-chunk quadratic
dual form ``(C·Bᵀ ⊙ exp(segsum(dt·A))) · (dt·x)``, the off-diagonal term
``(C·stateᵀ) ⊙ exp(cumsum(dt·A))`` and the state update, carrying the
P × N state across chunks.  One CTA per (slice of P, head, batch row)
loops over the chunks itself (CTAs run in no order, so the loop replaces
the Pallas kernel's sequential grid axis) and keeps B, x·dt and the state
in shared memory, the state never leaving the CTA.  x, dt, B and C are
read in place in their (b, s, ...) layouts and types — head h reads group
``h // (H / G)`` of B and C — so the wrapper copies nothing (the Pallas
wrapper's transpose and repeat are TPU layout moves).  The slice is 64
columns, or 32 when the b × H CTAs of 64 would leave SMs idle
(:func:`p_slice`).

The four products of a chunk run on the tensor cores (``mma.sync``
m16n8k16, bf16 operands, f32 accumulators; the within-chunk ones only on
the 16 × 16 tiles on or below the diagonal).  An f32 operand (x·dt, the
scores after the decay, the state; B and C when they arrive in f32) is
split into two bf16 parts, hi + lo, and multiplied as hi·b + lo·b or
hi·hi + hi·lo + lo·hi, so no f32 operand is rounded to bf16 once: y and
the state stay within 2e-4 of max |f32 scan| (``chip_smoke.SSD_TOL``).
What bounds it on the H100: bytes for bf16 inputs (x, B, C read once, the
f32 y written: 0.157 ms at mamba2's 4 × 4096 tokens, against ~146 GFLOP
of split bf16 MMAs, 0.148 ms at the tensor cores' peak).  One C·Bᵀ per
group rather than per head is later work.

Training: the forward also writes the state entering each chunk when
asked (``return_states``), and :func:`ssd_chunked_bwd` runs the scan's
gradient (``csrc/ssd_backward.cu``: a reverse pass over the chunks for
the states' gradients, a chunk-parallel pass for dx, ddt and per-head
partials of dB, dC and dA, and a fixed-order sum of the partials, all on
the CUDA cores in f32 and without atomics).  :class:`SsdChunkedFn` joins
the two for autograd.

The plain PyTorch versions are :func:`~repro_torch.kernels.ref.
ssd_chunked_ref` and :func:`~repro_torch.kernels.ref.ssd_chunked_bwd_ref`;
``kernels/ops.py`` sends CPU tensors there and CUDA tensors here.
``ssd_chunked.launches`` and ``ssd_chunked_bwd.launches`` count launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked_bwd_ref, ssd_chunked_ref

__all__ = ["ssd_chunked", "ssd_chunked_ref", "ssd_chunked_bwd",
           "ssd_chunked_bwd_ref", "SsdChunkedFn", "check_ssd_inputs",
           "p_slice"]


def p_slice(P: int, bh: int = 0, n_sm: int = 0) -> int:
    """Columns of P one CTA takes: all of them up to 64, else 64; 32 where
    the ``bh`` (batch rows x heads) CTAs of each 64-column slice would
    leave some of the card's ``n_sm`` SMs without a CTA — at mamba2's
    batch 1, 80 CTAs of 64 columns become 160 of 32."""
    ps = min(P, _build.SSD_SLICE)
    if ps == _build.SSD_SLICE and bh * (P // ps) < n_sm:
        return ps // 2
    return ps


def check_ssd_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, chunk: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs: x (b, s,
    H, P) and B, C (b, s, G, N) of one type, f32 or bf16; dt (b, s, H) and
    A (H,) f32; G dividing H; ``s`` a multiple of ``chunk``; chunk and N
    multiples of 4 up to 128; P a multiple of 4 up to 64, or of 64; every
    tensor contiguous on one CUDA device, x, B and C aligned for 4-element
    loads.  The types and shapes are checked first, so they raise the same
    on any device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_chunked: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_chunked: B and C must have x's dtype "
                         f"{x.dtype}, got {B.dtype} and {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_chunked: dt and A must be float32, got "
                         f"{dt.dtype} and {A.dtype}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"ssd_chunked: x must be (b, s, H, P) and B, C "
                         f"(b, s, G, N), got {tuple(x.shape)}, "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(B.shape[:2]) != (b, s) or tuple(dt.shape) != (b, s, H) \
            or tuple(A.shape) != (H,) or H % G:
        raise ValueError(f"ssd_chunked: dt must be {(b, s, H)}, A ({H},) and "
                         f"B, C ({b}, {s}, G, N) with G dividing {H}; got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)} and "
                         f"{tuple(B.shape)}")
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")
    if chunk % 4 or not 0 < chunk <= _build.SSD_MAX_CHUNK or N % 4 \
            or not 0 < N <= _build.SSD_MAX_STATE or P % 4 \
            or P % p_slice(P):
        raise ValueError(f"ssd_chunked: the kernel takes chunk and N "
                         f"multiples of 4 up to 128, and P a multiple of 4 "
                         f"up to 64 or of 64; got chunk={chunk}, N={N}, "
                         f"P={P}")
    tensors = (x, dt, A, B, C)
    _build.on_one_cuda_device("ssd_chunked", tensors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunked: every tensor must be contiguous")
    align = 4 * x.element_size()
    if any(t.data_ptr() % align for t in (x, B, C)):
        raise ValueError(f"ssd_chunked: x, B and C must be {align}-byte "
                         f"aligned")


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                return_states: bool = False):
    """x: (b, s, H, P); dt: (b, s, H) f32; A: (H,) f32; B, C: (b, s, G, N)
    in x's type (f32 or bf16); ``s`` a multiple of ``chunk``.  CUDA tensors
    only.  Returns (y (b, s, H, P) f32, final_state (b, H, P, N) f32), the
    state starting from zero, and with ``return_states`` also the state
    entering each chunk, (b, s / chunk, H, P, N) f32 (what
    :func:`ssd_chunked_bwd` needs)."""
    check_ssd_inputs(x, dt, A, B, C, chunk)
    b, s, H, P = x.shape
    N = B.shape[3]
    y = torch.empty((b, s, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((b, s // chunk, H, P, N) if return_states else (0,),
                         dtype=torch.float32, device=x.device)
    _build.extension().ssd(x, dt, A, B, C, y, state, states, int(chunk),
                           p_slice(P, b * H, _build.sm_count(x.device)))
    ssd_chunked.launches += 1
    return (y, state, states) if return_states else (y, state)


ssd_chunked.launches = 0


def ssd_chunked_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, states: torch.Tensor,
                    dy: torch.Tensor, dstate: Optional[torch.Tensor] = None,
                    *, chunk: int = 128) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_chunked` (``csrc/ssd_backward.cu``): x,
    dt, A, B, C as there; ``states`` the chunk states from its forward
    with ``return_states``; ``dy`` (b, s, H, P) f32 the gradient of y;
    ``dstate`` (b, H, P, N) f32 that of the final state, or None for zero.
    Takes what the forward takes, with P at most 64 (the chunk-parallel
    pass holds all of P in one CTA).  CUDA tensors only; returns (dx, ddt,
    dA, dB, dC) in x's, dt's, A's, B's and C's types, every sum in a
    fixed order (deterministic)."""
    check_ssd_inputs(x, dt, A, B, C, chunk)
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = s // chunk
    if P > _build.SSD_SLICE:
        raise ValueError(f"ssd_chunked_bwd: the kernel takes P up to "
                         f"{_build.SSD_SLICE}, got P={P}")
    f32 = dict(dtype=torch.float32, device=x.device)
    for name, t, shape in (("dy", dy, (b, s, H, P)),
                           ("states", states, (b, nc, H, P, N)),
                           ("dstate", dstate, (b, H, P, N))):
        if t is None and name == "dstate":
            continue
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape \
                or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            got = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
                   if isinstance(t, torch.Tensor) else repr(t))
            raise ValueError(f"ssd_chunked_bwd: {name} must be a contiguous "
                             f"{shape} float32 tensor on x's device, got "
                             f"{got}")
    dh1 = torch.empty((b, nc, H, P, N), **f32)
    dA_part = torch.empty((b, nc, H), **f32)
    dB_part = torch.empty((b, s, H, N), **f32)
    dC_part = torch.empty((b, s, H, N), **f32)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    _build.extension().ssd_bwd(
        x, dt, A, B, C, states, dy,
        torch.empty((0,), **f32) if dstate is None else dstate, dh1, dx, ddt,
        dA_part, dB_part, dC_part, dA, dB, dC, int(chunk),
        p_slice(P, b * H, _build.sm_count(x.device)))
    ssd_chunked_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_chunked_bwd.launches = 0


class SsdChunkedFn(torch.autograd.Function):
    """:func:`ssd_chunked` with its gradient: the forward keeps the state
    entering each chunk beside its inputs, and the backward runs
    :func:`ssd_chunked_bwd` on them, a missing gradient of y or of the
    final state taken as zero.  ``kernels/ops.py`` takes it for CUDA
    tensors when grad is enabled and an input requires it."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state, states = ssd_chunked(x, dt, A, B, C, chunk=chunk,
                                       return_states=True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, states = ctx.saved_tensors
        dy = (torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              if dy is None else dy.float().contiguous())
        if dstate is not None:
            dstate = dstate.float().contiguous()
        grads = ssd_chunked_bwd(x, dt, A, B, C, states, dy, dstate,
                                chunk=ctx.chunk)
        return grads + (None,)
