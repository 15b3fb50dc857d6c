"""Flash-decode over a contiguous per-row KV cache — the hand-written CUDA
kernel for Hopper (``csrc/decode_attention.cu``) that replaces the
reference's Pallas TPU kernel
``src/repro/kernels/decode_attention.py::decode_attention``.

One new token per batch row attends over the first ``lengths[i]``
positions of its own row of the slotted cache (one layer's (b, S, K, dh)
slice of the (L, n_slots, max_len, K, dh) cache).  The kernel runs one CTA
per (row, KV head) and the routine of ``csrc/attention_tile.cuh``, with
the row read as pages of 16 positions at
``row_base + pos·K·dh``: its 8 warps split the pages below
``min(length, S)``, so the cache tail is never read and S need not be a
multiple of any block (the Pallas kernel walks every 256-position block and
asserts ``S % 256 == 0``).

What bounds it on the H100: the HBM bytes of each row's visible K/V prefix
(``4 g dh`` flops per position against ``2 dh`` elements read); the design
reads every visible position once with coalesced warp loads and several
positions in flight per warp.  It does not split a row over several CTAs
yet, so a small batch leaves SMs idle.

The plain PyTorch version is :func:`~repro_torch.kernels.ref.
decode_attention_ref`; ``kernels/ops.py`` sends CPU tensors there and CUDA
tensors here.  ``decode_attention.launches`` counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, H, dh); caches: (b, S, K, dh), q's type (f32 or bf16), any S;
    lengths: () i32 shared by every row or (b,) i32 per row, **each >= 1**
    (a row of length 0 comes back zero; a length above S sees the whole
    row).  Scores are q·k * sm_scale (default dh**-0.5).  CUDA tensors
    only; returns (b, H, dh) in q's type."""
    _build.check_inputs("decode_attention", q, k_cache, v_cache, (lengths,))
    b = q.shape[0]
    if q.dim() != 3 or k_cache.shape[0] != b \
            or tuple(lengths.shape) not in ((), (b,)):
        raise ValueError(f"decode_attention: q must be (b, H, dh), caches "
                         f"(b, S, K, dh) and lengths () or (b,) with b={b}, "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)} and "
                         f"{tuple(lengths.shape)}")
    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    _build.extension().decode(q, k_cache, v_cache, lengths, out, scale)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
