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
    mask = _flash_mask(sq, skv, causal, window, q.device)
    o = _attend(q.reshape(b, sq, K, H // K, dh), k, v, mask, scale)
    return o.reshape(b, sq, H, dh).to(q.dtype)


def _flash_mask(sq: int, skv: int, causal: bool, window: int,
                device: torch.device) -> torch.Tensor:
    """(sq, skv) visible keys of the contiguous flash attention."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores (b, H, sq) f32:
    what the flash kernel writes beside its output for the backward."""
    b, sq, H, dh = q.shape
    skv, K = k.shape[1], k.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    s = torch.einsum("bqkgd,bnkd->bkgqn",
                     q.float().reshape(b, sq, K, H // K, dh), k.float())
    s = torch.where(_flash_mask(sq, skv, causal, window, q.device),
                    s * scale, torch.full_like(s, NEG_INF))
    return torch.logsumexp(s, dim=-1).reshape(b, H, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward kernel's formulas, step by step, in full f32 (the
    kernel multiplies on the tensor cores: bf16 inputs with P and dS
    rounded to bf16, f32 inputs as split bf16 pairs): P = exp(S · scale −
    lse) on the visible keys (0 elsewhere), delta = rowsum(dO ∘ O), dV =
    Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − delta), dK = dSᵀ q · scale and dQ =
    dS K · scale, dK and dV summed over each KV head's group.  q, o,
    do (b, sq, H, dh); k, v (b, skv, K, dh); lse (b, H, sq) f32.  Returns
    (dq, dk, dv) in the inputs' types."""
    b, sq, H, dh = q.shape
    skv, K = k.shape[1], k.shape[2]
    g = H // K
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    qf = q.float().reshape(b, sq, K, g, dh)
    of = o.float().reshape(b, sq, K, g, dh)
    dof = do.float().reshape(b, sq, K, g, dh)
    kf, vf = k.float(), v.float()
    mask = _flash_mask(sq, skv, causal, window, q.device)
    s = torch.einsum("bqkgd,bnkd->bkgqn", qf, kf) * scale
    lse_g = lse.float().reshape(b, K, g, sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), torch.zeros_like(s))
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]   # (b,K,g,sq,1)
    dp = torch.einsum("bqkgd,bnkd->bkgqn", dof, vf)
    ds = p * (dp - delta)
    dv = torch.einsum("bkgqn,bqkgd->bnkd", p, dof)
    dk = torch.einsum("bkgqn,bqkgd->bnkd", ds, qf) * scale
    dq = torch.einsum("bkgqn,bnkd->bqkgd", ds, kf) * scale
    return (dq.reshape(b, sq, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _decode_mask(n_pos: int, lengths, window: int,
                 device: torch.device, window_end=None) -> torch.Tensor:
    """(rows, n_pos) visible positions of a decode: ``pos < length``, and
    ``pos >= end - window`` when window > 0, ``end`` the window's end
    (``window_end``, or the length) — the reference model path's
    ``decode_attention_ref`` mask ``pos > length - 1 - window``."""
    ln = torch.as_tensor(lengths, device=device).reshape(-1, 1)
    pos = torch.arange(n_pos, device=device)[None, :]
    mask = pos < ln
    if window > 0:
        end = ln if window_end is None else \
            torch.as_tensor(window_end, device=device).reshape(-1, 1)
        mask = mask & (pos >= end - window)
    return mask


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths, *,
                         sm_scale: Optional[float] = None,
                         window: int = 0, window_end=None,
                         return_lse: bool = False):
    """One-position attention over a contiguous KV cache.  q: (b, H, dh);
    caches: (b, S, K, dh); lengths: () shared valid prefix, or (b,) per-row
    valid prefixes (the slotted continuous-batching decode) — positions
    ``pos < lengths[i]`` are visible, so a length above S sees the whole
    cache; with ``window`` > 0 only those ``>= lengths[i] - window``, or
    ``>= window_end[i] - window`` when ``window_end`` (() or (b,)) is given
    (the append-buffer decode's prefix segment, whose window ends at the
    query's position).  Scores are q·k * sm_scale (default dh**-0.5) in
    f32.  Returns (b, H, dh) in q's type; with ``return_lse`` (out (b, H,
    dh) f32, lse (b, H) f32), each row's log-sum-exp of its scaled scores,
    and a row that sees nothing gives out 0 and lse -inf, as the kernel
    does (without it, such a row averages V, as the reference does)."""
    b, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = dh ** -0.5 if sm_scale is None else sm_scale
    mask = _decode_mask(S, lengths, window, q.device, window_end)
    if not return_lse:
        o = _attend(q.reshape(b, 1, K, H // K, dh), k_cache, v_cache,
                    mask[:, None, None, None, :], scale)
        return o.reshape(b, H, dh).to(q.dtype)
    mask = mask.expand(b, S)[:, None, None, :]                 # (b,1,1,S)
    s = torch.einsum("bkgd,bnkd->bkgn",
                     q.float().reshape(b, K, H // K, dh),
                     k_cache.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    lse = torch.logsumexp(s, dim=-1)                          # (b,K,g)
    p = torch.where(mask, torch.exp(s - lse.clamp(min=NEG_INF)[..., None]),
                    torch.zeros_like(s))
    o = torch.einsum("bkgn,bnkd->bkgd", p, v_cache.float())
    return o.reshape(b, H, dh), lse.reshape(b, H)


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
                    init_state: Optional[torch.Tensor] = None,
                    return_states: bool = False):
    """Chunked state-space-duality scan (arXiv:2405.21060 §6).

    x: (b, s, H, P) head inputs; dt: (b, s, H) positive step sizes (already
    softplus'd and biased); A: (H,) negative decay rates; B, C: (b, s, G, N),
    group ``h // (H / G)`` serving head h.  ``s`` must be a multiple of
    ``chunk``.  Within a chunk the quadratic dual form, across chunks the
    linear recurrence over chunk states.  Returns (y (b, s, H, P) f32,
    final_state (b, H, P, N) f32), and with ``return_states`` also the
    state entering each chunk, (b, nc, H, P, N) f32 (what
    :func:`ssd_chunked_bwd_ref` needs)."""
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
    y = (Y_diag + Y_off).reshape(b, s, H, P)
    return (y, h, prev_states) if return_states else (y, h)


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor,
                        chunk_states: torch.Tensor, dy: torch.Tensor,
                        dstate: Optional[torch.Tensor], chunk: int
                        ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_chunked_ref` (zero initial state), chunk
    by chunk as ``csrc/ssd_backward.cu`` computes it.  ``chunk_states``:
    the state entering each chunk (``return_states``); ``dy`` (b, s, H, P)
    the cotangent of y; ``dstate`` (b, H, P, N) that of the final state,
    or None for zero.  Returns (dx, ddt, dA, dB, dC) in x's, dt's, A's,
    B's and C's types.

    Per head and chunk, with a = dt A, cum its inclusive cumsum, X = dt x,
    L_ij = exp(cum_i - cum_j) for j <= i, S = C Bᵀ, w_j = exp(cum_last -
    cum_j), h0 / h1 the states entering / leaving the chunk: the reverse
    carry dh0 = exp(cum_last) dh1 + Σ_i exp(cum_i) dy_i C_iᵀ gives each
    chunk's dh1; then M = L ∘ (dy Xᵀ), dX = (S∘L)ᵀ dy + w (dh1 B), dC = M B
    + exp(cum) (dy h0), dB = Mᵀ C + w (X dh1), and dcum = rowsum(S∘M) -
    colsum(S∘M) + o - r (o_i = exp(cum_i) dy_i·h0 C_i, r_j = w_j X_jᵀ dh1
    B_j), the last position also taking exp(cum_last) <dh1, h0> + Σ r; da
    is dcum's reverse cumsum.  The cumsum and the differences that go into
    exp are f64, the rest f32."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, hpg = s // chunk, H // G
    xc = x.float().reshape(b, nc, chunk, H, P)
    dtc = dt.float().reshape(b, nc, chunk, H)
    Bh = B.float().repeat_interleave(hpg, dim=2).reshape(b, nc, chunk, H, N)
    Ch = C.float().repeat_interleave(hpg, dim=2).reshape(b, nc, chunk, H, N)
    dyc = dy.float().reshape(b, nc, chunk, H, P)
    X = xc * dtc[..., None]
    # the chunk's cumsum and the differences that go into exp in f64, as
    # the kernel takes them: exp turns cum's rounding into relative error
    cum = torch.cumsum((dtc * A.float()).double(), dim=2)            # (b, nc, l, H)
    ecum = torch.exp(cum).float()
    w = torch.exp(cum[:, :, -1:] - cum).float()
    h0 = chunk_states.float()                                        # (b, nc, H, P, N)

    # the reverse carry over chunks: dh1 of each chunk
    dh = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
          if dstate is None else dstate.float())
    dh1 = [None] * nc
    for k in reversed(range(nc)):
        dh1[k] = dh
        dh = ecum[:, k, -1, :, None, None] * dh + torch.einsum(
            "bihp,bihn->bhpn", ecum[:, k, :, :, None] * dyc[:, k], Ch[:, k])
    dh1 = torch.stack(dh1, dim=1)                                    # (b, nc, H, P, N)

    # each chunk on its own
    ct = cum.permute(0, 1, 3, 2)                                     # (b, nc, H, l)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    Lm = torch.exp((ct[..., :, None] - ct[..., None, :]).float()
                   .masked_fill(~mask, float("-inf")))               # (b, nc, H, i, j)
    S = torch.einsum("bkihn,bkjhn->bkhij", Ch, Bh)
    M = Lm * torch.einsum("bkihp,bkjhp->bkhij", dyc, X)
    R = S * M
    dyh0 = torch.einsum("bkihp,bkhpn->bkihn", dyc, h0)
    xdh1 = torch.einsum("bkjhp,bkhpn->bkjhn", X, dh1)
    dX = torch.einsum("bkhij,bkihp->bkjhp", S * Lm, dyc) + \
        w[..., None] * torch.einsum("bkhpn,bkjhn->bkjhp", dh1, Bh)
    dC = torch.einsum("bkhij,bkjhn->bkihn", M, Bh) + ecum[..., None] * dyh0
    dB = torch.einsum("bkhij,bkihn->bkjhn", M, Ch) + w[..., None] * xdh1
    o = ecum * (dyh0 * Ch).sum(-1)                                   # (b, nc, l, H)
    r = w * (xdh1 * Bh).sum(-1)
    dcum = (R.sum(-1) - R.sum(-2)).permute(0, 1, 3, 2) + o - r
    last = ecum[:, :, -1] * (dh1 * h0).sum((-1, -2)) + r.sum(2)      # (b, nc, H)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]],
                     dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))

    dx = (dtc[..., None] * dX).reshape(b, s, H, P)
    ddt = ((xc * dX).sum(-1) + A.float() * da).reshape(b, s, H)
    dA = (dtc * da).sum((0, 1, 2))
    dB = dB.reshape(b, s, G, hpg, N).sum(3)
    dC = dC.reshape(b, s, G, hpg, N).sum(3)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype))


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
