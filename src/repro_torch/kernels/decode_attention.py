"""Flash-decode over a contiguous per-row KV cache — the hand-written CUDA
kernel for Hopper (``csrc/decode_attention.cu``) that replaces the
reference's Pallas TPU kernel
``src/repro/kernels/decode_attention.py::decode_attention``.

One new token per batch row attends over the first ``lengths[i]``
positions of its own row of the slotted cache (one layer's (b, S, K, dh)
slice of the (L, n_slots, max_len, K, dh) cache), or of the generic decode
step's cache at one shared position — over the last ``window`` of them
when ``window > 0`` (gemma3's local layers).  The kernel is the split-KV
body of the paged decode (``csrc/decode_split.cuh``) with a contiguous
address: the row is read as pages of :data:`CONTIG_PAGE` positions at
``(row·S + pos)·K·dh``, the arena's position stride with the identity for
a block table.  The grid is (n_split, K · chunks, b) (a group of g > 8
heads runs as row-chunks,
:func:`~repro_torch.kernels.paged_attention.decode_chunks`), planned on
the host from S alone by
:func:`~repro_torch.kernels.paged_attention.split_plan` over
``cdiv(S, 16)`` pages — never from the lengths, so the slotted step stays
free of host syncs; on the device each row cuts the pages of its visible
range (below ``min(length, S)``, from ``length - window`` with a window)
into runs, splits past them return at once, K/V are staged by
``cp.async`` 16 bytes a thread, and the CTA that arrives last at a (row,
KV head, chunk) merges the splits' partials (``csrc/split_kv.cuh``).  So
the cache tail and the positions before a window are never read and S
need not be a multiple of any block
(the Pallas kernel walks every 256-position block and asserts ``S % 256 ==
0``).

Two optional arguments serve the append-buffer decode's two segments
(``models/layers.py`` ``attention_decode_split_apply``): ``window_end``, a
device int32 () or (b,) from which the window's left edge is taken
(``window_end - window``) in place of the length — the prefix segment's
edge is the query's position, not the prefix's end — and
``return_lse``, which also returns each row's natural log-sum-exp of its
scaled scores, (b, H) f32, from the same (m, l) that normalise the
output: -inf for a row that sees nothing (its output 0), so its weight in
the segments' merge is 0.  With ``return_lse`` the output is f32 whatever
q's type, so that the merge rounds once.  The split plan does not
change: it still depends on S alone.

What bounds it on the H100: the HBM bytes of each row's visible K/V prefix
(``4 g dh`` flops per position against ``2 dh`` elements read); the split
keeps every SM streaming even at a batch of a few rows.

The plain PyTorch version is :func:`~repro_torch.kernels.ref.
decode_attention_ref`; ``kernels/ops.py`` sends CPU tensors there and CUDA
tensors here.  ``decode_attention.launches`` counts launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import DECODE_CTAS_PER_SM, \
    decode_chunks, partial_floats, split_plan
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "CONTIG_PAGE"]

# positions per page of a contiguous row (kContigPage of
# csrc/decode_split.cuh): the unit of the split plan
CONTIG_PAGE = 16


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     sm_scale: Optional[float] = None, window: int = 0,
                     window_end: Optional[torch.Tensor] = None,
                     return_lse: bool = False):
    """q: (b, H, dh); caches: (b, S, K, dh), q's type (f32 or bf16), any S;
    lengths: () i32 shared by every row or (b,) i32 per row, **each >= 1**
    (a row of length 0 comes back zero; a length above S sees the whole
    row); ``window`` > 0 keeps the positions ``>= length - window``, or
    ``>= window_end - window`` when ``window_end`` (() or (b,) i32) is
    given.  dh a multiple of 8, g = H / K at most 16, tensors 16-byte
    aligned.  Scores are q·k * sm_scale (default dh**-0.5).  CUDA tensors
    only; returns (b, H, dh) in q's type, or with ``return_lse`` (out (b,
    H, dh) f32, lse (b, H) f32)."""
    ints = (lengths,) if window_end is None else (lengths, window_end)
    _build.check_inputs("decode_attention", q, k_cache, v_cache, ints,
                        vec16=True)
    if (window_end is not None or return_lse) and lengths.dim():
        raise ValueError("decode_attention: the window end and the lse "
                         "take one shared () length")
    b = q.shape[0]
    if q.dim() != 3 or k_cache.shape[0] != b \
            or any(tuple(t.shape) not in ((), (b,)) for t in ints):
        raise ValueError(f"decode_attention: q must be (b, H, dh), caches "
                         f"(b, S, K, dh) and lengths and window_end () or "
                         f"(b,) with b={b}, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)} and "
                         f"{[tuple(t.shape) for t in ints]}")
    _, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    chunks, rows = decode_chunks(H // K)
    groups = b * K * chunks
    n_split, min_pages, ctas = split_plan(
        -(-S // CONTIG_PAGE), CONTIG_PAGE, groups, _build.sm_count(q.device),
        DECODE_CTAS_PER_SM[q.dtype])
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty(q.shape, **f32) if return_lse else torch.empty_like(q)
    lse = torch.empty((b, H) if return_lse else (0,), **f32)
    part = torch.empty((groups * n_split * partial_floats(rows + rows % 2, dh)
                        if n_split > 1 else 0,), **f32)
    none = torch.empty((0,), dtype=torch.int32, device=q.device)
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    _build.extension().decode(
        q, k_cache, v_cache, lengths,
        none if window_end is None else window_end, out, lse, part,
        _build.counters(q.device, groups), min_pages, n_split, ctas, scale,
        int(window))
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
