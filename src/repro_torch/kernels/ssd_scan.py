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

The plain PyTorch version is :func:`~repro_torch.kernels.ref.
ssd_chunked_ref`; ``kernels/ops.py`` sends CPU tensors there and CUDA
tensors here.  ``ssd_chunked.launches`` counts launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked_ref

__all__ = ["ssd_chunked", "ssd_chunked_ref", "check_ssd_inputs",
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
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"ssd_chunked: every tensor must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunked: every tensor must be contiguous")
    align = 4 * x.element_size()
    if any(t.data_ptr() % align for t in (x, B, C)):
        raise ValueError(f"ssd_chunked: x, B and C must be {align}-byte "
                         f"aligned")


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, H, P); dt: (b, s, H) f32; A: (H,) f32; B, C: (b, s, G, N)
    in x's type (f32 or bf16); ``s`` a multiple of ``chunk``.  CUDA tensors
    only.  Returns (y (b, s, H, P) f32, final_state (b, H, P, N) f32), the
    state starting from zero."""
    check_ssd_inputs(x, dt, A, B, C, chunk)
    b, s, H, P = x.shape
    y = torch.empty((b, s, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((b, H, P, B.shape[3]), dtype=torch.float32,
                        device=x.device)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.extension().ssd(x, dt, A, B, C, y, state, int(chunk),
                           p_slice(P, b * H, n_sm))
    ssd_chunked.launches += 1
    return y, state


ssd_chunked.launches = 0
