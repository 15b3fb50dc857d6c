"""Paged flash-decode attention — the hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``) that replaces the reference's Pallas TPU
kernel ``src/repro/kernels/paged_attention.py::paged_decode_attention``.

One new token per batch row attends over K/V scattered across fixed-size
arena blocks.  The kernel runs one CTA per (row, KV head): the CTA reads its
row's block ids itself, and its 8 warps split the pages ``p < cdiv(length,
bs)`` between them, so the loop bound is the page-skip and the junk-padded
table tail is never loaded; positions at or past ``length`` inside the last
page are masked.  Each warp keeps the f32 online softmax (m, l, acc) of the
``g`` query heads of the group over its pages, and the warps' states are
merged at the end; query head ``h`` reads KV head ``h // g``.

What bounds it on the H100: the HBM bytes of each row's valid K/V prefix
(``4 g dh`` flops per position against ``2 dh`` elements of K/V read), so
the design reads every valid position exactly once with coalesced warp
loads, several positions in flight per warp and no barrier in the page
loop.  It does not split a row over several CTAs yet, so a small batch
leaves SMs idle.

The plain PyTorch version is :func:`~repro_torch.kernels.ref.
paged_decode_attention_ref`; ``kernels/ops.py`` sends CPU tensors there and
CUDA tensors here.  ``paged_decode_attention.launches`` counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "paged_decode_attention_ref"]


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, H, dh); arenas: (n_blocks, block_size, K, dh), q's type (f32
    or bf16); block_tables: (b, n_pages) i32 arena block ids; lengths: (b,)
    i32 valid token counts, **each >= 1** (a row of length 0 comes back
    zero).  Scores are q·k * sm_scale (default dh**-0.5).  CUDA tensors
    only; returns (b, H, dh) in q's type."""
    _build.check_inputs("paged_decode_attention", q, k_arena, v_arena,
                        (block_tables, lengths))
    b = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_decode_attention: tables must be (b, "
                         f"n_pages) and lengths (b,) with b={b}, got "
                         f"{tuple(block_tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    _build.extension().paged_decode(q, k_arena, v_arena, block_tables,
                                    lengths, out, scale)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
