"""Decoder building blocks — the port's counterpart of the reference
package's ``models/layers.py``: RMSNorm, rotary embeddings (partial
rotary, and qwen2-vl's M-RoPE), GQA attention with qk-norm — full-sequence
attention (causal or full, or cross-attention over K/V from
:func:`cross_kv`) and prefill, decode at one shared position over a
contiguous cache (the generic decode of ``registry.decode_step``), decode
over a slotted cache, and prefill and decode over a paged KV arena — the
SwiGLU (or GELU) MLP and the tied embedding.

Parameters live in ``nn.Module``s; the math is plain functions on tensors
that follow the reference's rounding order (norms in f32 then cast back,
rotary tables cast to the activation type, q scaled and cast to the cache
type before the dot; the probabilities stay f32 through P·V, as in the
kernels).  Every attention goes through ``kernels/ops.py``: the
Hopper kernels for CUDA tensors, their plain versions on the CPU.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_paged_kv
from repro_torch.models.config import ModelConfig

__all__ = ["RMSNorm", "Attention", "MLP", "rmsnorm_apply", "rope_table",
           "mrope_table", "apply_rope", "cross_kv", "mlp_apply",
           "embedding_apply", "embedding_logits",
           "blocked_attention", "decode_attention", "slot_write_index",
           "attention_apply", "attention_prefill_apply",
           "attention_decode_apply", "attention_decode_slots_apply",
           "gather_paged_kv", "attention_decode_paged_apply",
           "attention_prefill_paged_apply", "init_dense", "trunc_normal",
           "grad_mode", "remat"]


def trunc_normal(shape, stddev: float, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator) -> torch.Tensor:
    """Normal(0, stddev) truncated to ±2 stddev, drawn in f32 on ``device``
    then cast — the reference's ``truncated_normal`` init (the two packages'
    generators give different numbers; parity runs carry weights across
    through ``models/bridge.py``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev, b=2 * stddev,
                          generator=gen)
    return t.to(dtype)


def init_dense(d_in: int, d_out: int, cfg: ModelConfig, device, gen,
               bias: bool = False, stddev: Optional[float] = None
               ) -> nn.Linear:
    """``nn.Linear`` holding the reference's (d_in, d_out) dense weight
    transposed, as PyTorch keeps it."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device, dtype=cfg.dtype)
    std = stddev if stddev is not None else d_in ** -0.5
    with torch.no_grad():
        lin.weight.copy_(trunc_normal((d_in, d_out), std, cfg.dtype, device,
                                      gen).T)
        if bias:
            lin.bias.zero_()
    return lin


# =============================================================================
# training: grad mode and per-layer activation checkpointing
# =============================================================================
def grad_mode(train: bool):
    """The context of a forward: gradients recorded for a training forward,
    none for inference (the serving paths' ``no_grad``)."""
    return torch.enable_grad() if train else torch.no_grad()


# the products whose outputs the "dots" policy keeps: matrix products
# without a batch dimension (every projection, in its 2-D form), as the
# reference's dots_with_no_batch_dims_saveable keeps its dot_generals;
# batched products (the MoE experts' bmm) and attention are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, cfg: ModelConfig, train: bool) -> Callable:
    """``fn`` (a layer's forward) under the activation checkpointing of a
    training forward, the reference's ``_maybe_remat``: with ``cfg.remat``
    and ``cfg.remat_policy`` "full" the backward recomputes the whole of
    ``fn`` from its inputs; "dots" keeps the outputs of its products
    without a batch dimension and recomputes the rest; "none", ``remat``
    False or inference (``train`` False) run ``fn`` as it is.  The
    decoder's "collectives" (keep each layer's attention output and block
    output) is its caller's: it checkpoints the attention and the MLP
    halves of a layer apart; for any other ``fn`` it recomputes the whole,
    as the reference's enc-dec does.  Checkpointing changes what the
    backward keeps, never the numbers."""
    if not train or not cfg.remat or cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


# =============================================================================
# norms
# =============================================================================
def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale


class RMSNorm(nn.Module):
    def __init__(self, dim: int, cfg: ModelConfig, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=cfg.dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(self.scale, x, self.eps)


# =============================================================================
# rotary position embeddings (RoPE / partial rotary)
# =============================================================================
def rope_table(positions: torch.Tensor, d_rot: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables.  positions: (..., s) int -> (..., s, d_rot//2) f32."""
    half = d_rot // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_table(positions: torch.Tensor, d_rot: int, theta: float,
                sections: Tuple[int, ...]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (qwen2-vl).  positions: (3, b, s) — the temporal,
    height and width streams; ``sections`` split the d_rot//2 frequencies
    among them, in that order.  Returns (b, s, d_rot//2) f32 tables."""
    assert sum(sections) == d_rot // 2, (sections, d_rot)
    cos_all, sin_all = rope_table(positions, d_rot, theta)  # (3, b, s, half)
    cos_parts, sin_parts = [], []
    off = 0
    for i, sec in enumerate(sections):
        cos_parts.append(cos_all[i, ..., off:off + sec])
        sin_parts.append(sin_all[i, ..., off:off + sec])
        off += sec
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               partial: float = 1.0) -> torch.Tensor:
    """x: (b, s, h, d).  cos/sin: (b, s, d_rot//2) or (s, d_rot//2)."""
    d = x.shape[-1]
    d_rot = int(d * partial)
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    if cos.dim() == 2:           # (s, half) -> broadcast over batch & heads
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:                        # (b, s, half)
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    cos_b = cos_b.to(x.dtype)
    sin_b = sin_b.to(x.dtype)
    out = torch.cat([x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b], -1)
    if d_rot < d:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# =============================================================================
# attention (GQA + qk-norm): full sequence, slotted cache, paged arena
# =============================================================================
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        d, dh, H, K = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
        self.cfg = cfg
        self.wq = init_dense(d, H * dh, cfg, device, gen, bias=cfg.qkv_bias)
        self.wk = init_dense(d, K * dh, cfg, device, gen, bias=cfg.qkv_bias)
        self.wv = init_dense(d, K * dh, cfg, device, gen, bias=cfg.qkv_bias)
        self.wo = init_dense(
            H * dh, d, cfg, device, gen,
            stddev=(H * dh) ** -0.5 / (2 * cfg.n_layers) ** 0.5)
        self.q_norm = RMSNorm(dh, cfg, device) if cfg.qk_norm else None
        self.k_norm = RMSNorm(dh, cfg, device) if cfg.qk_norm else None

    def project_q(self, x: torch.Tensor, cos: Optional[torch.Tensor],
                  sin: Optional[torch.Tensor]) -> torch.Tensor:
        """q of :meth:`project_qkv` alone (a cross-attention decode reads
        its K/V from the encoder's cache)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, cfg.n_heads, cfg.d_head)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if cos is not None:
            q = apply_rope(q, cos, sin, cfg.partial_rotary)
        return q

    def project_kv(self, x: torch.Tensor, cos: Optional[torch.Tensor],
                   sin: Optional[torch.Tensor]):
        """k and v (b, s, K, dh) of x (b, s, d): k normed and rotated as
        in :meth:`project_qkv`."""
        cfg = self.cfg
        b, s, _ = x.shape
        k = self.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        v = self.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        if self.k_norm is not None:
            k = self.k_norm(k)
        if cos is not None:
            k = apply_rope(k, cos, sin, cfg.partial_rotary)
        return k, v

    def project_qkv(self, x: torch.Tensor, cos: Optional[torch.Tensor],
                    sin: Optional[torch.Tensor]):
        """The reference's ``_project_qkv``: x (b, s, d) -> q (b, s, H,
        dh), k and v (b, s, K, dh), q and k rotated unless ``cos`` is None
        (cross-attention's queries)."""
        return (self.project_q(x, cos, sin),) + self.project_kv(x, cos, sin)


def _scaled_q(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """q * dh**-0.5 in q's type, then cast to the K/V type — the rounding
    order of the reference's model path; the kernels then take
    ``sm_scale=1.0``."""
    return (q * q.shape[-1] ** -0.5).to(kv.dtype).contiguous()


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, window: int = 0) -> torch.Tensor:
    """Full-sequence attention (the reference's ``blocked_attention`` with
    ``q_offset=0``): q (b, sq, H, dh) against k, v (b, skv, K, dh), GQA by
    head grouping, causal on positions from 0, and a sliding window when
    ``window`` is > 0.  The reference scans q blocks to bound its score
    memory; the kernel's tiles do that here.  Returns (b, sq, H, dh) in
    q's type."""
    o = ops.flash_attention(_scaled_q(q, k), k, v, causal=causal,
                            window=max(window, 0), sm_scale=1.0)
    return o.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths, *,
                     window: int = 0) -> torch.Tensor:
    """Single-position attention against a contiguous KV cache (the model
    path of the reference's ``layers.decode_attention_ref``).  q: (b, 1, H,
    dh); caches (b, S, K, dh); lengths () shared or (b,) per row, the new
    token's position being ``lengths - 1``; with ``window`` > 0 only the
    positions ``>= lengths - window`` are seen.  Returns (b, 1, H, dh)."""
    o = ops.decode_attention(_scaled_q(q[:, 0], k_cache), k_cache, v_cache,
                             lengths, sm_scale=1.0, window=window)
    return o.to(q.dtype)[:, None]


def attention_prefill_apply(attn: Attention, x: torch.Tensor, cos, sin, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Full-sequence attention that also returns the rotated K/V, so one
    prefill pass populates a decode cache.  x: (b, s, d).  Returns (out
    (b, s, d), k (b, s, K, dh), v (b, s, K, dh))."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    o = blocked_attention(q, k, v, causal=causal, window=window)
    b, s = x.shape[:2]
    return attn.wo(o.reshape(b, s, cfg.n_heads * cfg.d_head)), k, v


def attention_apply(attn: Attention, x: torch.Tensor, cos, sin, *,
                    causal: bool = True, window: int = 0,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Full-sequence attention (the forward): self-attention, causal or
    full, with a sliding window when ``window`` > 0; ``kv`` (k, v of
    (b, skv, K, dh), from :func:`cross_kv`) replaces the self K/V —
    cross-attention, full and without a window, as in the reference.
    x: (b, s, d) -> (b, s, d)."""
    if kv is None:
        return attention_prefill_apply(attn, x, cos, sin, causal=causal,
                                       window=window)[0]
    cfg = attn.cfg
    q = attn.project_q(x, cos, sin)
    o = blocked_attention(q, *kv, causal=False)
    b, s = x.shape[:2]
    return attn.wo(o.reshape(b, s, cfg.n_heads * cfg.d_head))


def cross_kv(attn: Attention, memory: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (b, s_src, K, dh) from the encoder memory (b,
    s_src, d): projected, k normed when ``qk_norm``, no rotary."""
    return attn.project_kv(memory, None, None)


def attention_decode_apply(attn: Attention, x: torch.Tensor, cos, sin,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           pos: torch.Tensor, *, window: int = 0
                           ) -> torch.Tensor:
    """One-token decode at the position ``pos`` (() int32) shared by every
    row: the new K/V land at ``pos`` — clamped into the cache, as the
    reference's ``dynamic_update_slice`` clamps — and the token attends
    over the first ``pos + 1`` positions (the last ``window`` of them when
    ``window`` > 0).  x: (b, 1, d); caches (b, S, K,
    dh), written IN PLACE (the reference returns new ones).  Returns out
    (b, 1, d)."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    at = pos.clamp(max=cache_k.shape[1] - 1).long().reshape(1)
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    o = decode_attention(q, cache_k, cache_v, pos + 1, window=window)
    return attn.wo(o.reshape(x.shape[0], 1, cfg.n_heads * cfg.d_head))


def slot_write_index(lengths: torch.Tensor, S: int):
    """Where a slotted decode step writes each row's new K/V: (rows,
    positions, keep).  The reference scatters at ``lengths[i]`` with
    ``mode="drop"``, so a row whose length is >= S writes nothing; here its
    index is clamped into the cache and ``keep`` (b, 1, 1) writes the old
    row back — no host sync and no out-of-range index."""
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    return (rows, lengths.clamp(max=S - 1).long(),
            (lengths < S)[:, None, None])


def attention_decode_slots_apply(attn: Attention, x: torch.Tensor, cos, sin,
                                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                                 lengths: torch.Tensor, write, *,
                                 window: int = 0) -> torch.Tensor:
    """One continuous-batching decode step over a slotted cache: each row
    writes its new K/V at its own position ``lengths[i]`` (dropped when
    that is past the cache, ``write`` from :func:`slot_write_index`) and
    attends over its own first ``lengths[i] + 1`` positions (the last
    ``window`` of them when ``window`` > 0).  x: (b, 1, d);
    caches (b, S, K, dh), written IN PLACE (the reference returns new
    ones); lengths (b,) i32.  Returns out (b, 1, d)."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    rows, pos, keep = write
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache.index_put_((rows, pos), torch.where(
            keep, new[:, 0].to(cache.dtype), cache[rows, pos]))
    o = decode_attention(q, cache_k, cache_v, lengths + 1, window=window)
    return attn.wo(o.reshape(x.shape[0], 1, cfg.n_heads * cfg.d_head))


def attention_decode_paged_apply(attn: Attention, x: torch.Tensor,
                                 cos, sin, arena_k: torch.Tensor,
                                 arena_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 write_bid: torch.Tensor,
                                 write_off: torch.Tensor, *,
                                 window: int = 0) -> torch.Tensor:
    """One paged continuous-batching decode step: each row writes its new
    K/V into arena block ``write_bid[i]`` at offset ``write_off[i]`` (the
    junk block 0 for inactive rows) and attends over its own block table's
    first ``lengths[i] + 1`` positions (the last ``window`` of them when
    ``window`` > 0).  x: (b, 1, d); arenas (n_blocks, bs,
    K, dh), written IN PLACE (the reference donates them to XLA instead);
    tables (b, n_pages) i32; lengths (b,) i32.  Returns out (b, 1, d)."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    b = x.shape[0]
    arena_k.index_put_((write_bid, write_off), k[:, 0].to(arena_k.dtype))
    arena_v.index_put_((write_bid, write_off), v[:, 0].to(arena_v.dtype))
    o = ops.paged_decode_attention(_scaled_q(q[:, 0], arena_k), arena_k,
                                   arena_v, tables, lengths + 1, sm_scale=1.0,
                                   window=window)
    return attn.wo(o.to(q.dtype).reshape(b, 1, cfg.n_heads * cfg.d_head))


def attention_prefill_paged_apply(attn: Attention, x: torch.Tensor,
                                  cos, sin, arena_k: torch.Tensor,
                                  arena_v: torch.Tensor, table: torch.Tensor,
                                  positions: torch.Tensor,
                                  write_bid: torch.Tensor,
                                  write_off: torch.Tensor, *,
                                  window: int = 0) -> torch.Tensor:
    """One chunk of chunked prefill for a single sequence against the paged
    arena: the chunk's rotated K/V land in their arena slots IN PLACE (junk
    block 0 for the padded tail), then the chunk's queries attend causally
    over the table — cached prefix blocks included, so a prefix-cache hit
    never replays shared tokens — within ``window`` positions when
    ``window`` > 0.  x: (1, C, d); table (span,) i32;
    positions (C,) i32 absolute positions.  Returns out (1, C, d)."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    C = x.shape[1]
    arena_k.index_put_((write_bid, write_off), k[0].to(arena_k.dtype))
    arena_v.index_put_((write_bid, write_off), v[0].to(arena_v.dtype))
    o = ops.paged_prefill_attention(_scaled_q(q[0], arena_k), arena_k,
                                    arena_v, table, positions, sm_scale=1.0,
                                    window=window)
    return attn.wo(o.to(q.dtype).reshape(1, C, cfg.n_heads * cfg.d_head))


# =============================================================================
# MLP (SwiGLU or plain GELU)
# =============================================================================
class MLP(nn.Module):
    """SwiGLU (or GELU) MLP of width ``d_ff`` (``cfg.d_ff`` by default; an
    MoE's shared experts pass their summed width)."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, d_ff = cfg.d_model, d_ff or cfg.d_ff
        out_std = d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5
        self.wi_gate = (init_dense(d, d_ff, cfg, device, gen)
                        if cfg.act == "silu" else None)
        self.wi_up = init_dense(d, d_ff, cfg, device, gen)
        self.wo = init_dense(d_ff, d, cfg, device, gen, stddev=out_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    up = p.wi_up(x)
    if p.wi_gate is not None:
        h = F.silu(p.wi_gate(x)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return p.wo(h)


# =============================================================================
# embedding
# =============================================================================
def embedding_apply(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def embedding_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied-softmax readout: x @ table.T."""
    return F.linear(x, table)
