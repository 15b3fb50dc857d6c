"""Plain PyTorch versions of the attention kernels — the port's
counterpart of the reference package's ``kernels/ref.py``.

They are what the kernel wrappers' dispatch (``kernels/ops.py``) runs for
tensors on the CPU, and the oracle every CUDA kernel is held against on the
card.  The softmax is taken in f32 whatever the input type; masked scores
are -1e30 before it, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def gather_paged_kv(arena_k: torch.Tensor, arena_v: torch.Tensor,
                    tables: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize per-row contiguous KV views from a paged arena.

    arenas: (n_blocks, block_size, K, dh); tables: (b, n_pages) i32 arena
    block ids (0-padded — block 0 is the junk sink, masked by the caller).
    Returns (k, v) shaped (b, n_pages·block_size, K, dh)."""
    b, n_pages = tables.shape
    _, bs, K, dh = arena_k.shape
    idx = tables.long()
    return (arena_k[idx].reshape(b, n_pages * bs, K, dh),
            arena_v[idx].reshape(b, n_pages * bs, K, dh))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """q (b, sq, K, g, dh); k, v (b, skv, K, dh); mask broadcastable to
    (b, K, g, sq, skv).  Returns f32 (b, sq, K, g, dh)."""
    s = torch.einsum("bqkgd,bnkd->bkgqn", q.float(), k.float()) * sm_scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqn,bnkd->bqkgd", p, v.float())


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Exact softmax attention.  q: (b, sq, H, dh); k, v: (b, skv, K, dh);
    GQA by head grouping (query head h reads KV head h // g); causal on
    positions from 0 (``q_pos >= kv_pos``); window > 0 = sliding window
    (``q_pos - kv_pos < window``).  Scores are q·k * sm_scale (default
    dh**-0.5) in f32.  Returns (b, sq, H, dh) in q's type."""
    b, sq, H, dh = q.shape
    skv, K = k.shape[1], k.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    o = _attend(q.reshape(b, sq, K, H // K, dh), k, v, mask, scale)
    return o.reshape(b, sq, H, dh).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths, *,
                         sm_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """One-position attention over a contiguous KV cache.  q: (b, H, dh);
    caches: (b, S, K, dh); lengths: () shared valid prefix, or (b,) per-row
    valid prefixes (the slotted continuous-batching decode) — positions
    ``pos < lengths[i]`` are visible, so a length above S sees the whole
    cache.  Scores are q·k * sm_scale (default dh**-0.5) in f32.  Returns
    (b, H, dh) in q's type."""
    b, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    ln = torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
    mask = (torch.arange(S, device=q.device)[None, :] < ln)
    o = _attend(q.reshape(b, 1, K, H // K, dh), k_cache, v_cache,
                mask[:, None, None, None, :], scale)
    return o.reshape(b, H, dh).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                               v_arena: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """One-position attention over a PAGED KV cache.  q: (b, H, dh);
    arenas: (n_blocks, block_size, K, dh); block_tables: (b, n_pages) i32;
    lengths: (b,) valid token counts.  Scores are q·k * sm_scale (default
    dh**-0.5), scaled after the dot in f32.  Returns (b, H, dh) in q's
    type."""
    b, H, dh = q.shape
    K = k_arena.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    kc, vc = gather_paged_kv(k_arena, v_arena, block_tables)
    pos = torch.arange(kc.shape[1], device=q.device)
    mask = (pos[None, :] < lengths.reshape(-1, 1))[:, None, None, None, :]
    o = _attend(q.reshape(b, 1, K, H // K, dh), kc, vc, mask, scale)
    return o.reshape(b, H, dh).to(q.dtype)


def paged_prefill_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                                v_arena: torch.Tensor, table: torch.Tensor,
                                positions: torch.Tensor, *,
                                sm_scale: Optional[float] = None,
                                window: int = 0) -> torch.Tensor:
    """One chunk of paged chunked prefill: the C queries at absolute
    ``positions`` attend causally over the K/V gathered through ``table``.
    q: (C, H, dh); arenas (n_blocks, bs, K, dh); table (span,) i32;
    positions (C,) i32.  The mask is ``kv_pos <= positions[q]`` (and
    ``positions[q] - kv_pos < window`` when window > 0) — the attention of
    the reference's ``models/layers.py`` ``attention_prefill_paged_apply``.
    Returns (C, H, dh) in q's type."""
    C, H, dh = q.shape
    K = k_arena.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    kc, vc = gather_paged_kv(k_arena, v_arena, table[None])
    kv_pos = torch.arange(kc.shape[1], device=q.device)
    pos = positions.long()[:, None]
    mask = kv_pos[None, :] <= pos
    if window > 0:
        mask &= (pos - kv_pos[None, :]) < window
    o = _attend(q.reshape(1, C, K, H // K, dh), kc, vc, mask, scale)
    return o.reshape(C, H, dh).to(q.dtype)
