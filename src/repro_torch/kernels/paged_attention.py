"""Paged flash-decode attention — the hand-written CUDA kernel for Hopper
(``csrc/paged_attention.cu``, over the split-KV decode body of
``csrc/decode_split.cuh`` that the contiguous decode shares) that replaces
the reference's Pallas TPU kernel
``src/repro/kernels/paged_attention.py::paged_decode_attention``.

One new token per batch row attends over K/V scattered across fixed-size
arena blocks — over its last ``window`` positions when ``window > 0`` (a
sliding-window layer, gemma3's local layers).  The kernel splits each
row's keys over several CTAs (flash-decoding): the grid is (n_split, K ·
chunks, b); a row cuts the pages its visible range touches (from page
``max(length - window, 0) // bs`` with a window) into ``n_split`` runs of
``pps`` pages (at least 64 positions), and split ``s`` takes the ``s``-th
run, reads its block ids itself and stages its K/V positions in shared
memory with ``cp.async``, masking positions below the window; a split past
the visible pages returns at once, so neither the junk-padded table tail
nor the pages before a window are loaded.  Each CTA keeps the f32 online
softmax (m, l, acc) of up to 8 query heads of the group: a group of g > 8
heads (glm4's 16) runs as ``decode_chunks(g)`` row-chunks, one CTA each;
a row with one live split writes its output, otherwise the split's
partial goes to an f32 scratch buffer and the CTA that arrives last at its
(row, KV head, chunk) merges them in the same launch
(``csrc/split_kv.cuh``).  Query head ``h`` reads KV head ``h // g``.

What bounds it on the H100: the HBM bytes of each row's visible K/V
positions (``4 g dh`` flops per position against ``2 dh`` elements of K/V
read; a local layer reads at most its window).  The
split keeps every SM busy with tens of KB of loads in flight even at a
small batch; :func:`split_plan` sizes it on the host from shapes alone —
the table's width, the batch, the KV heads and the SM count, never the
lengths — so the engine's fused decode loop needs no host sync.

The plain PyTorch version is :func:`~repro_torch.kernels.ref.
paged_decode_attention_ref`; ``kernels/ops.py`` sends CPU tensors there and
CUDA tensors here.  ``paged_decode_attention.launches`` counts launches,
and ``windowed_launches`` those with a window.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "split_plan", "partial_floats", "decode_chunks", "bwd_split_plan",
           "BWD_CTAS_PER_SM"]

# a split holds at least this many positions (one staged block of the
# prefill kernel; four tiles of the decode kernel's ring)
MIN_SPLIT_POSITIONS = 64
# at most this many splits per group (kMaxSplits of csrc/split_kv.cuh: the
# merge's weights fit the kernels' shared memory)
MAX_SPLITS = 32
# CTAs an SM should be given: of the decode kernel's, two in f32 and four
# in bf16, whose ring takes half the shared memory (on the H100, a batch
# of 8 rows of up to 2048 positions: f32 0.0484 ms at two against 0.0542
# at four, bf16 0.0457 against 0.0311; the serve's 300 positions alike);
# one of the prefill kernel's (a 64-row tile on the tensor cores, up to
# 168 KB of shared memory)
DECODE_CTAS_PER_SM = {torch.float32: 2, torch.bfloat16: 4}
PREFILL_CTAS_PER_SM = 1


def partial_floats(rows: int, dh: int) -> int:
    """f32 words of one split's partial (acc, m, l) of ``rows`` query rows
    (``partial_floats`` of csrc/split_kv.cuh); a decode group of g rows is
    laid out as ``g + g % 2`` rows, so that with dh % 4 == 0 every partial
    starts 16-byte aligned, as the merge's float4 reads need."""
    return rows * (dh + 2)


def decode_chunks(g: int) -> Tuple[int, int]:
    """(chunks, rows) of a decode group of ``g`` query heads
    (``decode_chunks`` / ``decode_rows`` of csrc/decode_split.cuh): it runs
    as ``chunks = cdiv(g, MAX_ROWS)`` CTAs of ``rows = cdiv(g, chunks)``
    heads, the last holding the rest, so that no CTA holds more rows in
    registers than the kernel's 8.  Every chunk's partial is laid out as
    ``rows + rows % 2`` rows."""
    chunks = -(-g // _build.MAX_ROWS)
    return chunks, -(-g // chunks)


@functools.lru_cache(maxsize=None)
def split_plan(n_pages: int, block_size: int, n_groups: int, n_sm: int,
               ctas_per_sm: int) -> Tuple[int, int, int]:
    """(n_split, min_pages, ctas) of a split-KV launch over a table of
    ``n_pages`` pages of ``block_size`` positions, for ``n_groups`` groups
    of query rows (decode: b x K; prefill: q-tiles x K) on ``n_sm`` SMs.
    Shapes only: the lengths and positions lie on the device and are never
    read here.  ``ctas`` = ``ctas_per_sm x n_sm`` is the number of CTAs the
    work should fill; each group gets ``n_split`` CTAs in the grid — twice
    its even share of ``ctas``, so that one long row can take more than
    its share, at most ``MAX_SPLITS``, and no more than a full table fills
    with splits of ``min_pages`` pages (``MIN_SPLIT_POSITIONS``
    positions).  On the device a group cuts its own visible pages into at
    most ``n_split`` runs of at least ``min_pages`` pages
    (``csrc/split_kv.cuh``)."""
    min_pages = -(-MIN_SPLIT_POSITIONS // block_size)
    ctas = ctas_per_sm * n_sm
    want = max(1, min(MAX_SPLITS, 2 * ctas // max(n_groups, 1)))
    return min(want, -(-n_pages // min_pages)), min_pages, ctas


# the flash backward's dK/dV CTAs (csrc/flash_backward.cu): a CTA owns
# BWD_KEYS keys of one KV head; a key block's walk is cut over at most
# BWD_MAX_SPLITS CTAs, which sizes the partials' scratch; an SM holds one
# f32 CTA (8 warps, 205 KiB of shared memory at dh 128) or two bf16 ones
# (4 warps, 103 KiB): BWD_CTAS_PER_SM copies what BwdWarps and BwdSmem set
# there, and chip_smoke.py holds it to the occupancy calculator's count
# (flash_bwd_ctas_per_sm) on the card
BWD_KEYS = 64
BWD_MAX_SPLITS = 16
# a split takes at least this many (head, 64-query block) items: with
# fewer, writing and summing the partials costs more than the split gains
BWD_MIN_SPLIT_ITEMS = 4
BWD_CTAS_PER_SM = {torch.float32: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def bwd_split_plan(b: int, sq: int, skv: int, H: int, K: int, n_sm: int,
                   ctas_per_sm: int) -> int:
    """n_split of the flash backward's dK/dV launch (q (b, sq, H, dh)
    against k, v (b, skv, K, dh)) on ``n_sm`` SMs that hold
    ``ctas_per_sm`` of its CTAs each (``BWD_CTAS_PER_SM``), from shapes
    only.  A CTA owns 64 keys of one KV head and walks its group's (query
    head, 64-query block) items; when the ``b x K x cdiv(skv, 64)`` CTAs
    fall short of what the card holds, each key block's walk is cut over
    ``n_split`` CTAs — by heads first, then by query range: contiguous
    shares of the head-major items — enough for two waves, so that a
    causal grid's heavy first blocks do not set its time alone; at most
    ``BWD_MAX_SPLITS``, and at least ``BWD_MIN_SPLIT_ITEMS`` of the
    longest walk's items (g x cdiv(sq, 64)) a split.  The splits' f32
    partials are summed in a fixed order in the same call."""
    ctas = b * K * -(-skv // BWD_KEYS)
    slots = ctas_per_sm * n_sm
    if ctas >= slots:
        return 1
    items = H // K * -(-sq // BWD_KEYS)
    return max(1, min(BWD_MAX_SPLITS, items // BWD_MIN_SPLIT_ITEMS,
                      -(-2 * slots // ctas)))


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           window: int = 0) -> torch.Tensor:
    """q: (b, H, dh); arenas: (n_blocks, block_size, K, dh), q's type (f32
    or bf16); block_tables: (b, n_pages) i32 arena block ids; lengths: (b,)
    i32 valid token counts, **each >= 1** (a row of length 0 comes back
    zero); ``window`` > 0 keeps the positions ``>= length - window``.  dh a
    multiple of 8, g = H / K at most 16.  Scores are q·k * sm_scale
    (default dh**-0.5).  CUDA tensors only; returns (b, H, dh) in q's
    type."""
    _build.check_inputs("paged_decode_attention", q, k_arena, v_arena,
                        (block_tables, lengths), vec16=True)
    b, H, dh = q.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_decode_attention: tables must be (b, "
                         f"n_pages) and lengths (b,) with b={b}, got "
                         f"{tuple(block_tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    K = k_arena.shape[2]
    chunks, rows = decode_chunks(H // K)
    groups = b * K * chunks
    n_split, min_pages, ctas = split_plan(
        block_tables.shape[1], k_arena.shape[1], groups,
        _build.sm_count(q.device), DECODE_CTAS_PER_SM[q.dtype])
    out = torch.empty_like(q)
    part = torch.empty((groups * n_split * partial_floats(rows + rows % 2, dh)
                        if n_split > 1 else 0,), dtype=torch.float32,
                       device=q.device)
    scale = dh ** -0.5 if sm_scale is None else float(sm_scale)
    _build.extension().paged_decode(q, k_arena, v_arena, block_tables,
                                    lengths, out, part,
                                    _build.counters(q.device, groups),
                                    min_pages, n_split, ctas, scale,
                                    int(window))
    paged_decode_attention.launches += 1
    paged_decode_attention.windowed_launches += int(window > 0)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.windowed_launches = 0    # of them, with a window
