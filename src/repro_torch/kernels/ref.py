"""Plain PyTorch versions of the kernels — the port's counterpart of the
reference package's ``kernels/ref.py`` (attention) and of the SSD oracles
of its ``models/ssm.py`` (``ssd_ref``, ``ssd_sequential_ref``).

They are what the kernel wrappers' dispatch (``kernels/ops.py``) runs for
tensors on the CPU, and the oracle every CUDA kernel is held against on the
card.  The softmax is taken in f32 whatever the input type; masked scores
are -1e30 before it, as in the reference.  The SSD scan computes in f32
whatever the input type.
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


def _decode_mask(n_pos: int, lengths, window: int,
                 device: torch.device) -> torch.Tensor:
    """(rows, n_pos) visible positions of a decode: ``pos < length``, and
    ``pos >= length - window`` when window > 0 (the reference model path's
    ``decode_attention_ref`` mask ``pos > length - 1 - window``)."""
    ln = torch.as_tensor(lengths, device=device).reshape(-1, 1)
    pos = torch.arange(n_pos, device=device)[None, :]
    mask = pos < ln
    if window > 0:
        mask &= pos >= ln - window
    return mask


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths, *,
                         sm_scale: Optional[float] = None,
                         window: int = 0) -> torch.Tensor:
    """One-position attention over a contiguous KV cache.  q: (b, H, dh);
    caches: (b, S, K, dh); lengths: () shared valid prefix, or (b,) per-row
    valid prefixes (the slotted continuous-batching decode) — positions
    ``pos < lengths[i]`` are visible, so a length above S sees the whole
    cache; with ``window`` > 0 only those ``>= lengths[i] - window``.
    Scores are q·k * sm_scale (default dh**-0.5) in f32.  Returns (b, H,
    dh) in q's type."""
    b, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    mask = _decode_mask(S, lengths, window, q.device)
    o = _attend(q.reshape(b, 1, K, H // K, dh), k_cache, v_cache,
                mask[:, None, None, None, :], scale)
    return o.reshape(b, H, dh).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                               v_arena: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *,
                               sm_scale: Optional[float] = None,
                               window: int = 0) -> torch.Tensor:
    """One-position attention over a PAGED KV cache.  q: (b, H, dh);
    arenas: (n_blocks, block_size, K, dh); block_tables: (b, n_pages) i32;
    lengths: (b,) valid token counts; with ``window`` > 0 only the
    positions ``>= lengths[i] - window`` are seen.  Scores are q·k *
    sm_scale (default dh**-0.5), scaled after the dot in f32.  Returns (b,
    H, dh) in q's type."""
    b, H, dh = q.shape
    K = k_arena.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    kc, vc = gather_paged_kv(k_arena, v_arena, block_tables)
    mask = _decode_mask(kc.shape[1], lengths, window, q.device)
    o = _attend(q.reshape(b, 1, K, H // K, dh), kc, vc,
                mask[:, None, None, None, :], scale)
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


# =============================================================================
# Mamba2 SSD scan
# =============================================================================
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i, j] = sum(x[j+1..i]); -inf for
    j > i."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-duality scan (arXiv:2405.21060 §6).

    x: (b, s, H, P) head inputs; dt: (b, s, H) positive step sizes (already
    softplus'd and biased); A: (H,) negative decay rates; B, C: (b, s, G, N),
    group ``h // (H / G)`` serving head h.  ``s`` must be a multiple of
    ``chunk``.  Within a chunk the quadratic dual form, across chunks the
    linear recurrence over chunk states.  Returns (y (b, s, H, P) f32,
    final_state (b, H, P, N) f32)."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd: sequence length {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc, hpg = s // chunk, H // G

    dtf = dt.float()
    xf = x.float() * dtf[..., None]
    dA = dtf * A.float()[None, None, :]                              # (b, s, H)
    xc = xf.reshape(b, nc, chunk, H, P)
    Bc = B.float().reshape(b, nc, chunk, G, N)
    Cc = C.float().reshape(b, nc, chunk, G, N)
    dAc = dA.reshape(b, nc, chunk, H).permute(0, 3, 1, 2)            # (b, H, nc, l)
    dA_cs = torch.cumsum(dAc, dim=-1)

    # 1. within-chunk (quadratic dual form)
    Lmat = torch.exp(_segsum(dAc))                                   # (b, H, nc, l, l)
    scores = torch.einsum("bclgn,bcsgn->bgcls", Cc, Bc)
    scores = scores.repeat_interleave(hpg, dim=1)                    # (b, H, nc, l, l)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", scores * Lmat, xc)

    # 2. per-chunk states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)                # (b, H, nc, l)
    Bh = Bc.repeat_interleave(hpg, dim=3)                            # (b, nc, l, H, N)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xc)

    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[..., -1])                          # (b, H, nc)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                           # (b, nc, H, P, N)

    # 4. off-diagonal (state -> output)
    state_decay_out = torch.exp(dA_cs)                               # (b, H, nc, l)
    Ch = Cc.repeat_interleave(hpg, dim=3)                            # (b, nc, l, H, N)
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev_states,
                         state_decay_out)
    return (Y_diag + Y_off).reshape(b, s, H, P), h


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token oracle of :func:`ssd_chunked_ref` (slow, exact): the
    recurrence h <- h * exp(dt A) + dt x Bᵀ, y = h C, in f32.  Shapes as
    there; no chunk."""
    b, s, H, P = x.shape
    hpg = H // B.shape[2]
    state = (torch.zeros((b, H, P, B.shape[3]), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = B.float().repeat_interleave(hpg, dim=2)                     # (b, s, H, N)
    Cf = C.float().repeat_interleave(hpg, dim=2)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * Af[None, :])                      # (b, H)
        xt = xf[:, t] * dtf[:, t][..., None]                         # (b, H, P)
        state = state * dA[..., None, None] + xt[..., None] * \
            Bf[:, t][:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1), state
