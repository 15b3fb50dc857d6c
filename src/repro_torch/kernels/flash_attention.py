"""Paged chunked-prefill flash attention — the hand-written CUDA kernel for
Hopper (``csrc/flash_attention.cu``) that replaces the reference's Pallas
TPU kernel ``src/repro/kernels/flash_attention.py::flash_attention`` in the
paged form the serving engine's chunked prefill computes.

The C queries of one prompt chunk, at absolute positions ``n_past..``,
attend causally over the sequence's K/V read through its block table.  The
kernel runs one CTA per (q-tile of the chunk, KV head), the tile's ``tq ×
g`` query rows (at most 8) in f32 online softmax; the CTA's 8 warps split
the table's pages and merge their states at the end.  It walks the table
only up to the page that holds the tile's largest position — the Pallas
kernel runs fully masked blocks; these are skipped — with the causal mask
``kv_pos <= positions[q]`` and, when ``window > 0``, the sliding window of
the Pallas kernel.  Queries of a padded chunk tail are computed and never
read.

What bounds it on the H100: a 32-token f32 chunk does about 32 flops per
K/V byte, above the CUDA cores' 20 (67 TFLOP/s over 3.35 TB/s), so its f32
operations bound it.  The dot products run on CUDA cores in f32 with warp
shuffles; tensor-core tiles over the whole chunk, and the contiguous form
(slotted prefill, training), are later work.

The plain PyTorch version is :func:`~repro_torch.kernels.ref.
paged_prefill_attention_ref`; ``kernels/ops.py`` sends CPU tensors there
and CUDA tensors here.  ``paged_prefill_attention.launches`` counts
launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_prefill_attention_ref

__all__ = ["paged_prefill_attention", "paged_prefill_attention_ref",
           "queries_per_cta"]


def queries_per_cta(g: int) -> int:
    """Queries a CTA takes: as many as fit its 8 query rows (``tq × g``)."""
    return _build.MAX_ROWS // g


def paged_prefill_attention(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, table: torch.Tensor,
                            positions: torch.Tensor, *,
                            sm_scale: Optional[float] = None,
                            window: int = 0) -> torch.Tensor:
    """q: (C, H, dh); arenas: (n_blocks, block_size, K, dh), q's type (f32
    or bf16); table: (span,) i32 block ids of the sequence; positions: (C,)
    i32 absolute positions of the chunk's queries.  Scores are q·k *
    sm_scale (default dh**-0.5).  CUDA tensors only; returns (C, H, dh) in
    q's type."""
    _build.check_inputs("paged_prefill_attention", q, k_arena, v_arena,
                        (table, positions))
    C, H, dh = q.shape
    K = k_arena.shape[2]
    if table.dim() != 1 or tuple(positions.shape) != (C,):
        raise ValueError(f"paged_prefill_attention: table must be (span,) "
                         f"and positions ({C},), got {tuple(table.shape)} "
                         f"and {tuple(positions.shape)}")
    tq = queries_per_cta(H // K)
    out = torch.empty_like(q)
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    _build.extension().paged_prefill(q, k_arena, v_arena, table, positions,
                                     out, tq, scale, int(window))
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
