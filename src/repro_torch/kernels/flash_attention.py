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
flash_attention_ref` and :func:`~repro_torch.kernels.ref.
paged_prefill_attention_ref`; ``kernels/ops.py`` sends CPU tensors there
and CUDA tensors here.  ``flash_attention.launches`` and
``paged_prefill_attention.launches`` count launches, and their
``windowed_launches`` those with a window.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import PREFILL_CTAS_PER_SM, \
    partial_floats, split_plan
from repro_torch.kernels.ref import flash_attention_ref, \
    paged_prefill_attention_ref

__all__ = ["flash_attention", "flash_attention_ref",
           "paged_prefill_attention", "paged_prefill_attention_ref",
           "flash_queries_per_cta"]


def flash_queries_per_cta(g: int) -> int:
    """Queries a CTA of the contiguous kernel and of the paged prefill
    kernel takes: as many as fit its 64 query rows (``tq × g``)."""
    return _build.FA_ROWS // g


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, H, dh); k, v: (b, skv, K, dh), q's type (f32 or bf16),
    dh a multiple of 4 (at most 128).  Causal on positions from 0 (``q_pos
    >= kv_pos``) when ``causal``; sliding window ``q_pos - kv_pos <
    window`` when ``window > 0``.  Scores are q·k * sm_scale (default
    dh**-0.5).  CUDA tensors only; returns (b, sq, H, dh) in q's type."""
    _build.check_inputs("flash_attention", q, k, v, (),
                        max_group=_build.FA_ROWS)
    if q.dim() != 4 or k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_attention: q must be (b, sq, H, dh) and "
                         f"k, v (b, skv, K, dh), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, sq, H, dh = q.shape
    align = 4 * q.element_size()         # the kernel reads 4 elements at once
    if dh % 4 or any(t.data_ptr() % align for t in (q, k, v)):
        raise ValueError(f"flash_attention: the kernel takes dh divisible by "
                         f"4 and {align}-byte aligned tensors; got dh={dh}")
    out = torch.empty_like(q)
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    tq = flash_queries_per_cta(H // k.shape[2])
    _build.extension().flash(q, k, v, out, tq, bool(causal), int(window),
                             scale)
    flash_attention.launches += 1
    flash_attention.windowed_launches += int(window > 0)
    return out


flash_attention.launches = 0
flash_attention.windowed_launches = 0    # of them, with a window


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
