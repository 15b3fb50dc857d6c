"""Flash attention — the hand-written CUDA kernels for Hopper
(``csrc/flash_attention.cu``, ``csrc/paged_prefill.cu``) that replace the reference's Pallas TPU
kernel ``src/repro/kernels/flash_attention.py::flash_attention``, in the two
forms the serving engines compute.

**Contiguous** (:func:`flash_attention`: the slotted prefill in f32, the
hybrid forward in bf16): q (b, sq, H, dh) against k, v (b, skv, K, dh),
causal on positions from 0, or full, with the Pallas kernel's sliding
window when ``window > 0``.  One CTA per (tile of ``64 // g`` queries, KV
head, batch row) holds the tile's 64 query rows (queries × group heads),
walks K/V blocks of 64 positions and keeps an f32 online softmax per row.
Blocks past the tile's last query (causal) or before its window are
skipped — the Pallas kernel runs fully masked blocks — and only blocks on
the diagonal or the window's edge are masked.  One body for both types, on
the tensor cores (``mma.sync`` m16n8k16, f32 accumulators, the head dim
padded to a multiple of 16 in shared memory): bf16 inputs stage K/V by
``cp.async`` in a two-stage ring and round P to bf16 for P·V, as the
reference model path rounds it; f32 inputs split every operand — q, K, V
and P — into a bf16 pair and take hi·hi + hi·lo + lo·hi, which keeps the
f32 tolerance, through one f32 stage split once per block (the paged
prefill's layout).  What bounds it on the H100: its operations (``4 dh``
flops per visible (query head, key) pair; 344 GFLOP at the hybrid
forward's 4 × 4096 tokens, 32 heads of 80), at the bf16 peak, or a third
of it for f32 inputs.

**Its gradient** (:class:`FlashAttentionFn`, :func:`flash_attention_bwd`,
``csrc/flash_backward.cu``): the reference has no Pallas backward — it
trains through the jnp ``blocked_attention`` — so this is the gradient of
the function the contiguous form computes.  With ``return_lse`` the
forward also writes each row's log-sum-exp (b, H, sq) f32; the backward
takes q, k, v, the output, the lse and dO: ``delta = rowsum(dO ∘ O)``;
dK/dV, a CTA per 64 keys of a KV head walking its group's (head, 64-query
block) items, P recomputed as ``exp(S·scale − lse)``; and dQ on the
forward's tiling, S and dP recomputed — no atomics.  Every product runs
on the tensor cores (``mma.sync`` m16n8k16, f32 accumulators), as the
forward's: bf16 inputs take one product each, P and dS rounded to bf16;
f32 inputs split every operand into a bf16 pair (hi·hi + hi·lo + lo·hi).
When the dK/dV CTAs fall short of the card, :func:`~repro_torch.kernels.
paged_attention.bwd_split_plan` cuts each key block's walk over several
CTAs, whose f32 partials a second kernel of the call sums in a fixed
order: the gradient is the same bits from run to run.  Its bound is its
operations, ``10 dh`` flops per visible (query head, key) pair, at the
bf16 peak, or a third of it for f32 inputs.

**Paged chunked prefill** (:func:`paged_prefill_attention`,
``csrc/paged_prefill.cu``): the C queries of one prompt chunk, at absolute
positions ``n_past..``, attend causally over the sequence's K/V read
through its block table, with the sliding window when ``window > 0``.  A
CTA owns one tile of 64 query rows (``64 // g`` queries × the g heads of a
KV head, folded as the contiguous kernel folds them) and one split of the
table's pages — split-KV, as the paged decode kernel: the grid is (q-tiles,
K, n_split), sized on the host from the table's ``span`` by
:func:`~repro_torch.kernels.paged_attention.split_plan`, never from the
positions; the tile cuts its visible pages (up to its largest position,
from its window's edge) into ``n_split`` runs.  Splits past them return at
once; the mask is evaluated only on the 64-key blocks that cross
the diagonal, the window's edge or the visible range's end.  K/V pages are
staged by ``cp.async`` through the block table, and S = q·Kᵀ and P·V run on
the tensor cores (``mma.sync`` m16n8k16, f32 accumulators, f32 online
softmax in registers).  bf16 inputs take one product each, P rounded to
bf16 as the reference's model path rounds it; f32 inputs (the paged
engine's arena) split every operand — q, K, V and P — into a bf16 pair and
take hi·hi + hi·lo + lo·hi, which keeps the f32 tolerance.  The splits'
partials (f32 scratch) merge in a second, small kernel of the same call,
eight rows a CTA (``csrc/split_kv.cuh``).
Queries of a padded chunk tail are computed and never read.  A 32-token
f32 chunk does about 32 flops per K/V byte; on the tensor cores the bytes
bound it.

The plain PyTorch versions are :func:`~repro_torch.kernels.ref.
flash_attention_ref`, :func:`~repro_torch.kernels.ref.
flash_attention_bwd_ref` and :func:`~repro_torch.kernels.ref.
paged_prefill_attention_ref`; ``kernels/ops.py`` sends CPU tensors there
(autograd through the plain forward for a gradient) and CUDA tensors here.
``flash_attention.launches``, ``flash_attention_bwd.launches`` and
``paged_prefill_attention.launches`` count launches, and the forwards'
``windowed_launches`` those with a window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import BWD_CTAS_PER_SM, \
    PREFILL_CTAS_PER_SM, bwd_split_plan, partial_floats, split_plan
from repro_torch.kernels.ref import flash_attention_bwd_ref, \
    flash_attention_ref, paged_prefill_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "FlashAttentionFn",
           "paged_prefill_attention", "paged_prefill_attention_ref",
           "flash_queries_per_cta", "bwd_scratch_floats"]


def flash_queries_per_cta(g: int) -> int:
    """Queries a CTA of the contiguous kernel and of the paged prefill
    kernel takes: as many as fit its 64 query rows (``tq × g``)."""
    return _build.FA_ROWS // g


def _check_flash(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the contiguous kernels (forward and
    backward) take q, k and v."""
    _build.check_inputs(name, q, k, v, (), max_group=_build.FA_ROWS)
    if q.dim() != 4 or k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: q must be (b, sq, H, dh) and k, v (b, "
                         f"skv, K, dh), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    align = 4 * q.element_size()         # the kernel reads 4 elements at once
    if q.shape[3] % 4 or any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel takes dh divisible by 4 and "
                         f"{align}-byte aligned tensors; got "
                         f"dh={q.shape[3]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """q: (b, sq, H, dh); k, v: (b, skv, K, dh), q's type (f32 or bf16),
    dh a multiple of 4 (at most 128).  Causal on positions from 0 (``q_pos
    >= kv_pos``) when ``causal``; sliding window ``q_pos - kv_pos <
    window`` when ``window > 0``.  Scores are q·k * sm_scale (default
    dh**-0.5).  CUDA tensors only; returns (b, sq, H, dh) in q's type, and
    with ``return_lse`` also each row's log-sum-exp of its scaled scores,
    (b, H, sq) f32 (what :func:`flash_attention_bwd` needs)."""
    _check_flash("flash_attention", q, k, v)
    b, sq, H, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, H, sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    tq = flash_queries_per_cta(H // k.shape[2])
    _build.extension().flash(q, k, v, out, lse, tq, bool(causal),
                             int(window), scale)
    flash_attention.launches += 1
    flash_attention.windowed_launches += int(window > 0)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.windowed_launches = 0    # of them, with a window


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention` (``csrc/flash_backward.cu``):
    q, k, v as there; ``out`` and ``lse`` (b, H, sq) f32 from its forward
    with ``return_lse``; ``dout`` the gradient of ``out``.  Takes what the
    forward takes (f32 or bf16, g <= 64, dh a multiple of 4 up to 128,
    causal, full or windowed, sq != skv).  CUDA tensors only; returns (dq,
    dk, dv) in the inputs' type, dk and dv summed over each KV head's group
    in f32 — across the splits of :func:`~repro_torch.kernels.
    paged_attention.bwd_split_plan` in a fixed order — and rounded once
    (deterministic)."""
    _check_flash("flash_attention_bwd", q, k, v)
    b, sq, H, dh = q.shape
    if any(t.shape != q.shape or t.dtype != q.dtype
           or not t.is_contiguous() or t.device != q.device
           for t in (out, dout)):
        raise ValueError(f"flash_attention_bwd: out and dout must be "
                         f"contiguous {tuple(q.shape)} {q.dtype} tensors on "
                         f"q's device")
    if tuple(lse.shape) != (b, H, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"{(b, H, sq)} float32 tensor on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    K = k.shape[2]
    n_split = bwd_split_plan(b, sq, k.shape[1], H, K,
                             _build.sm_count(q.device),
                             BWD_CTAS_PER_SM[q.dtype])
    delta = torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
    part = torch.empty((bwd_scratch_floats(q, k, n_split),),
                       dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.extension().flash_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 part, flash_queries_per_cta(H // K),
                                 n_split, bool(causal), int(window), scale)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def bwd_scratch_floats(q: torch.Tensor, k: torch.Tensor,
                       n_split: int) -> int:
    """f32 words of the backward's scratch (``csrc/flash_backward.cu``):
    the splits' dK and dV partials when ``n_split > 1``, then, for f32
    inputs, q, k, v and dO as bf16 hi / lo pairs (one word an element)."""
    part = 2 * n_split * k.numel() if n_split > 1 else 0
    hilo = 2 * (q.numel() + k.numel()) if q.dtype == torch.float32 else 0
    return part + hilo


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with its gradient: the forward keeps the
    rows' log-sum-exp beside q, k, v and the output, and the backward runs
    :func:`flash_attention_bwd` on them.  ``kernels/ops.py`` takes it for
    CUDA tensors when grad is enabled and an input requires it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                sm_scale: Optional[float]):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.flags = (causal, window, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, sm_scale = ctx.flags
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=causal,
                                         window=window, sm_scale=sm_scale)
        return dq, dk, dv, None, None, None


def paged_prefill_attention(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, table: torch.Tensor,
                            positions: torch.Tensor, *,
                            sm_scale: Optional[float] = None,
                            window: int = 0) -> torch.Tensor:
    """q: (C, H, dh); arenas: (n_blocks, block_size, K, dh), q's type (f32
    or bf16); table: (span,) i32 block ids of the sequence; positions: (C,)
    i32 absolute positions of the chunk's queries; dh a multiple of 8.
    Scores are q·k * sm_scale (default dh**-0.5).  CUDA tensors only; returns (C, H, dh) in
    q's type."""
    _build.check_inputs("paged_prefill_attention", q, k_arena, v_arena,
                        (table, positions), max_group=_build.FA_ROWS,
                        vec16=True)
    C, H, dh = q.shape
    K = k_arena.shape[2]
    if table.dim() != 1 or tuple(positions.shape) != (C,):
        raise ValueError(f"paged_prefill_attention: table must be (span,) "
                         f"and positions ({C},), got {tuple(table.shape)} "
                         f"and {tuple(positions.shape)}")
    tq = flash_queries_per_cta(H // K)
    groups = -(-C // tq) * K
    n_split, min_pages, _ = split_plan(table.shape[0], k_arena.shape[1],
                                       groups, _build.sm_count(q.device),
                                       PREFILL_CTAS_PER_SM)
    out = torch.empty_like(q)
    part = torch.empty((groups * n_split
                        * partial_floats(_build.FA_ROWS, dh)
                        if n_split > 1 else 0,), dtype=torch.float32,
                       device=q.device)
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    _build.extension().paged_prefill(q, k_arena, v_arena, table, positions,
                                     out, part, tq, min_pages, n_split, scale,
                                     int(window))
    paged_prefill_attention.launches += 1
    paged_prefill_attention.windowed_launches += int(window > 0)
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.windowed_launches = 0    # of them, with a window
