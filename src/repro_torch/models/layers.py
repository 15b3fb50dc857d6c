"""Decoder building blocks — the port's counterpart of the reference
package's ``models/layers.py``: RMSNorm, rotary embeddings (partial
rotary, and qwen2-vl's M-RoPE), GQA attention with qk-norm — full-sequence
attention (causal or full, or cross-attention over K/V from
:func:`cross_kv`) and prefill, decode at one shared position over a
contiguous cache (the generic decode of ``registry.decode_step``) or over
a read-only prefix and a suffix ring (the append-buffer decode,
``cfg.decode_window``), decode over a slotted cache, and prefill and
decode over a paged KV arena — the SwiGLU (or GELU) MLP and the tied
embedding, and the greedy pick of a token from the logits.

Parameters live in ``nn.Module``s; the math is plain functions on tensors
that follow the reference's rounding order (norms in f32 then cast back,
rotary tables cast to the activation type, q scaled and cast to the cache
type before the dot; the probabilities stay f32 through P·V, as in the
kernels).  Every attention goes through ``kernels/ops.py``: the
Hopper kernels for CUDA tensors, their plain versions on the CPU.

On a rank mesh (``models/registry.py`` ``shard_params``) the modules hold
the rank's shard and say so in a ``mesh`` attribute (None unsharded):
``Attention`` the rank's heads, Megatron-style — column-parallel ``wq``,
``wk``, ``wv``, a row-parallel ``wo`` followed by one all-reduce over
"model" (:meth:`Attention.out`) — the ``MLP`` column-parallel
``wi_gate`` / ``wi_up`` and a row-parallel ``wo`` with one all-reduce,
and the embedding the rank's slice of the vocab (a masked lookup summed
over "model"; the readout gives the rank's slice of the logits, which
:func:`greedy_token` reduces).  qk-norm and RoPE act per head and need no
collective.  In training the pairs carry gradients (Megatron's conjugate
pair, ``sharding/collectives.py``): the input of the column-parallel
projections is :func:`~repro_torch.sharding.collectives.copy_to` (its
gradient summed over "model"), the row-parallel output
:func:`~repro_torch.sharding.collectives.reduce_from`; with ``sp`` (the
sequence-parallel forward, ``cfg.seq_parallel``) the output is
reduce-scattered along the sequence instead.

A contiguous decode cache cut over the sequence (``rules.cache_specs``:
the few-KV-head fallback, or ``seq_shard``) is described by a
:class:`KVCut`; its decode (:func:`attention_decode_seq_apply`)
all-gathers every head's query and new K/V row over "model", decodes the
rank's segment with the window end and the lse, merges the segments by
:func:`combine_lse_parts` over an all-gather of (out, lse), and keeps the
rank's heads for the row-parallel ``wo``; only the rank whose segment
holds the position writes the new row.
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
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (MODEL_AXIS, axes_of, axes_size,
                                        block_index)

__all__ = ["RMSNorm", "Attention", "MLP", "rmsnorm_apply", "rope_table",
           "mrope_table", "apply_rope", "cross_kv", "mlp_apply",
           "embedding_apply", "embedding_logits", "greedy_token",
           "blocked_attention", "decode_attention", "slot_write_index",
           "attention_apply", "attention_prefill_apply",
           "attention_decode_apply", "attention_decode_slots_apply",
           "decode_attention_parts", "combine_attention_parts",
           "combine_lse_parts", "attention_decode_split_apply",
           "KVCut", "attention_decode_seq_apply", "cross_decode_seq_apply",
           "gather_paged_kv", "attention_decode_paged_apply",
           "attention_prefill_paged_apply", "init_dense", "trunc_normal",
           "seeded_generator",
           "grad_mode", "remat"]


def seeded_generator(device: torch.device, seed: int
                     ) -> Optional[torch.Generator]:
    """The init's ``torch.Generator`` on ``device`` from ``seed``; None on
    the meta device, where the init draws nothing (``launch/steps.py``'s
    abstract models: shapes and dtypes only, no memory)."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def trunc_normal(shape, stddev: float, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """Normal(0, stddev) truncated to ±2 stddev, drawn in f32 on ``device``
    then cast — the reference's ``truncated_normal`` init (the two packages'
    generators give different numbers; parity runs carry weights across
    through ``models/bridge.py``).  On the meta device: an empty tensor of
    the shape and type."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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
    """GQA attention's projections.  ``n_heads`` / ``n_kv_heads`` are the
    heads this module computes: the config's, or on a rank mesh the
    rank's — H/m query heads (when m divides H) over K/m KV heads (when m
    divides K; otherwise the KV projections stay whole and the rank keeps
    the heads ``kv_heads`` = (first, end) that its query heads read).
    ``mesh`` is set when ``wo`` is row-parallel (its partial sums are
    all-reduced over "model"), None otherwise."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        d, dh, H, K = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
        self.cfg = cfg
        self.n_heads, self.n_kv_heads = H, K
        self.kv_heads: Optional[Tuple[int, int]] = None
        self.mesh = None
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
        return self._q(C.copy_to(x, self.mesh, MODEL_AXIS), cos, sin)

    def _q(self, x: torch.Tensor, cos, sin) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, self.n_heads, cfg.d_head)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if cos is not None:
            q = apply_rope(q, cos, sin, cfg.partial_rotary)
        return q

    def project_kv(self, x: torch.Tensor, cos: Optional[torch.Tensor],
                   sin: Optional[torch.Tensor], all_heads: bool = False):
        """k and v (b, s, K, dh) of x (b, s, d): k normed and rotated as
        in :meth:`project_qkv`; with ``all_heads`` every head the whole
        KV projections hold (all of them where the rank keeps
        ``kv_heads``)."""
        return self._kv(C.copy_to(x, self.mesh, MODEL_AXIS), cos, sin,
                        all_heads)

    def _kv(self, x: torch.Tensor, cos, sin, all_heads: bool = False):
        cfg = self.cfg
        b, s, _ = x.shape
        k = self.wk(x).reshape(b, s, -1, cfg.d_head)
        v = self.wv(x).reshape(b, s, -1, cfg.d_head)
        if self.kv_heads is not None and not all_heads:
            lo, hi = self.kv_heads
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
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
        x = C.copy_to(x, self.mesh, MODEL_AXIS)
        return (self._q(x, cos, sin),) + self._kv(x, cos, sin)

    def out(self, o: torch.Tensor, sp: bool = False) -> torch.Tensor:
        """The output projection of the heads' outputs o (b, s, heads, dh),
        or (b, s, heads·dh), -> (b, s, d), its partial sums added over
        "model" on a rank mesh; with ``sp`` reduce-scattered along the
        sequence -> (b, s / m, d)."""
        y = self.wo(o.flatten(2) if o.dim() == 4 else o)
        if sp:
            return C.scatter_dim(y, self.mesh, MODEL_AXIS, 1)
        return C.reduce_from(y, self.mesh, MODEL_AXIS)


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
                            causal: bool = True, window: int = 0,
                            sp: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Full-sequence attention that also returns the rotated K/V, so one
    prefill pass populates a decode cache.  x: (b, s, d).  Returns (out
    (b, s, d), k (b, s, K, dh), v (b, s, K, dh)); with ``sp`` out is the
    rank's block of the sequence (:meth:`Attention.out`)."""
    q, k, v = attn.project_qkv(x, cos, sin)
    o = blocked_attention(q, k, v, causal=causal, window=window)
    return attn.out(o, sp), k, v


def attention_apply(attn: Attention, x: torch.Tensor, cos, sin, *,
                    causal: bool = True, window: int = 0,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    sp: bool = False) -> torch.Tensor:
    """Full-sequence attention (the forward): self-attention, causal or
    full, with a sliding window when ``window`` > 0; ``kv`` (k, v of
    (b, skv, K, dh), from :func:`cross_kv`) replaces the self K/V —
    cross-attention, full and without a window, as in the reference.
    x: (b, s, d) -> (b, s, d); with ``sp`` the rank's block of the
    sequence of the output."""
    if kv is None:
        return attention_prefill_apply(attn, x, cos, sin, causal=causal,
                                       window=window, sp=sp)[0]
    q = attn.project_q(x, cos, sin)
    return attn.out(blocked_attention(q, *kv, causal=False))


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
    q, k, v = attn.project_qkv(x, cos, sin)
    at = pos.clamp(max=cache_k.shape[1] - 1).long().reshape(1)
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    return attn.out(decode_attention(q, cache_k, cache_v, pos + 1,
                                     window=window))


def decode_attention_parts(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length, *, pos_offset=0,
                           query_pos=None, window: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Unnormalised one-position attention over one KV segment, plain
    PyTorch with the reference's (acc, m, l) contract: acc (b, K, g, dh),
    m and l (b, K, g), all f32, for an online-softmax merge across
    segments (:func:`combine_attention_parts`).  q (b, 1, H, dh); caches
    (b, S, K, dh); the segment's slot 0 sits at absolute position
    ``pos_offset``, its first ``length`` slots are valid; with ``window`` >
    0 and ``query_pos`` given only the positions ``> query_pos - window``
    are seen.  m of a segment that sees nothing is -1e30, its l and acc 0.
    The model path runs :func:`attention_decode_split_apply`, which merges
    its segments by their log-sum-exp instead."""
    b, _, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qg = _scaled_q(q[:, 0], k_cache).reshape(b, K, H // K, dh)
    s = torch.einsum("bkgd,bnkd->bkgn", qg.float(), k_cache.float())
    off = torch.as_tensor(pos_offset, device=q.device).reshape(-1, 1)
    pos = off + torch.arange(S, device=q.device)[None, :]
    mask = pos < off + torch.as_tensor(length, device=q.device).reshape(-1, 1)
    if window > 0 and query_pos is not None:
        mask = mask & (pos > torch.as_tensor(
            query_pos, device=q.device).reshape(-1, 1) - window)
    s = torch.where(mask[:, None, None, :], s,
                    torch.full_like(s, float("-inf")))
    m = s.amax(-1)
    p = torch.exp(s - m.clamp(min=-1e30)[..., None])
    acc = torch.einsum("bkgn,bnkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return acc, m.clamp(min=-1e30), p.sum(-1)


def combine_attention_parts(parts) -> torch.Tensor:
    """Merge the partials ``[(acc, m, l), ...]`` of
    :func:`decode_attention_parts` into (b, K, g, dh) f32, as the
    reference does."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    acc = sum(a * torch.exp(mi - m)[..., None] for a, mi, _ in parts)
    l = sum(li * torch.exp(mi - m) for _, mi, li in parts)
    return acc / l.clamp(min=1e-30)[..., None]


def combine_lse_parts(parts) -> torch.Tensor:
    """Merge normalised segment outputs ``[(out (b, H, dh) f32, lse (b, H)
    f32), ...]`` by their log-sum-exps: weights ``exp(lse_i - max)`` in
    f32, so a segment that saw nothing (lse -inf) weighs 0; a row that no
    segment saw comes back 0.  Returns (b, H, dh) f32."""
    m = parts[0][1]
    for _, li in parts[1:]:
        m = torch.maximum(m, li)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ws = [torch.exp(li - m) for _, li in parts]
    num = sum(w[..., None] * o for (o, _), w in zip(parts, ws))
    return num / sum(ws).clamp(min=1e-30)[..., None]


def attention_decode_split_apply(attn: Attention, x: torch.Tensor, cos, sin,
                                 prefix_k: torch.Tensor,
                                 prefix_v: torch.Tensor, sk: torch.Tensor,
                                 sv: torch.Tensor, pos: torch.Tensor,
                                 prefix_len: torch.Tensor, *,
                                 window: int = 0,
                                 cut: Optional["KVCut"] = None
                                 ) -> torch.Tensor:
    """The append-buffer decode (the reference's
    ``attention_decode_split_apply``): the prefix cache (b, S, K, dh) is
    read only; the new token's K/V go into the suffix ring sk, sv (b, W, K,
    dh) at ``slot = pos - prefix_len``, clamped into ``[0, W - 1]`` on the
    device as the reference's ``dynamic_update_slice`` clamps (written IN
    PLACE; no host read of ``pos``).  The token attends over two segments,
    one decode call each — the prefix's first ``prefix_len`` positions,
    its window ending at ``pos + 1``, and the ring's first ``slot + 1``
    (all W once ``slot >= W``, as in the reference) — and their outputs
    are merged by their log-sum-exps (:func:`combine_lse_parts`).  On CUDA
    both calls are the contiguous decode kernel with its window end and
    lse; on the CPU its plain version.  x: (b, 1, d); pos, prefix_len: ()
    int32.  ``cut`` (a :class:`KVCut` of the prefix) on a rank mesh.
    Returns out (b, 1, d)."""
    if cut is not None:
        return _split_apply_cut(attn, x, cos, sin, prefix_k, prefix_v, sk,
                                sv, pos, prefix_len, window, cut)
    q, k, v = attn.project_qkv(x, cos, sin)
    slot = pos - prefix_len
    at = slot.clamp(0, sk.shape[1] - 1).long().reshape(1)
    sk.index_copy_(1, at, k.to(sk.dtype))
    sv.index_copy_(1, at, v.to(sv.dtype))
    prefix = ops.decode_attention(
        _scaled_q(q[:, 0], prefix_k), prefix_k, prefix_v, prefix_len,
        sm_scale=1.0, window=window, window_end=pos + 1, return_lse=True)
    suffix = ops.decode_attention(
        _scaled_q(q[:, 0], sk), sk, sv, slot + 1, sm_scale=1.0,
        window=window, return_lse=True)
    return attn.out(combine_lse_parts([prefix, suffix]).to(q.dtype).reshape(
        x.shape[0], 1, -1))


class KVCut:
    """How a rank holds a contiguous KV cache (b, S, K, dh) of a rank
    mesh under a spec of ``rules.cache_specs`` (for the per-layer tensor:
    batch, sequence, heads, head dim): ``heads`` when its KV heads are
    cut over "model"; otherwise it holds every head, and the sequence
    segment ``offset .. offset + S_l - 1`` of ``S`` positions, one of
    ``n_seg`` blocks over ``seq_axes`` (the first axis the slowest; one
    block when the sequence is whole)."""

    def __init__(self, spec, S: int, mesh):
        self.mesh, self.S = mesh, int(S)
        self.heads = spec[2] == MODEL_AXIS
        self.seq_axes = axes_of(spec[1])
        self.n_seg = axes_size(mesh, self.seq_axes) if self.seq_axes else 1
        self.S_l = -(-self.S // self.n_seg)
        self.offset = block_index(mesh, self.seq_axes) * self.S_l

    @property
    def whole_heads(self) -> bool:
        """True when the rank's cache holds every KV head while the heads
        or the sequence are cut over the mesh (its decode then needs every
        head's query and a merge: :func:`attention_decode_seq_apply`)."""
        return not self.heads and (self.mesh.shape[MODEL_AXIS] > 1
                                   or self.n_seg > 1)


def _gather_heads(t: torch.Tensor, mesh) -> torch.Tensor:
    """(b, 1, h, dh) heads of each rank on "model" -> (b, 1, m·h, dh), in
    rank order."""
    g = C.all_gather(t, mesh, MODEL_AXIS)                 # (m, b, 1, h, dh)
    return g.permute(1, 2, 0, 3, 4).flatten(2, 3)


def _my_heads(o: torch.Tensor, attn: Attention, mesh) -> torch.Tensor:
    """This rank's query heads of o (b, H, ...) when its attention is
    cut over "model" (the input of its row-parallel ``wo``)."""
    if attn.mesh is None:
        return o
    r, hl = mesh.coord(MODEL_AXIS), attn.n_heads
    return o[:, r * hl:(r + 1) * hl]


def _merge_segments(o: torch.Tensor, lse: torch.Tensor, cut: KVCut,
                    extra=()) -> torch.Tensor:
    """The segments' (out (b, H, dh) f32, lse (b, H)) of every rank on
    ``cut.seq_axes``, all-gathered (packed in one tensor) and merged by
    :func:`combine_lse_parts` with the ``extra`` parts."""
    b, H, dh = o.shape
    parts = [(o, lse)]
    if cut.n_seg > 1:
        t = torch.cat([o.reshape(b, H * dh), lse], -1)
        for a in reversed(cut.seq_axes):
            t = C.all_gather(t, cut.mesh, a)
        t = t.reshape(cut.n_seg, b, H * dh + H)
        parts = [(p[:, :H * dh].reshape(b, H, dh), p[:, H * dh:])
                 for p in t.unbind(0)]
    return combine_lse_parts(parts + list(extra))


def _whole_qkv(attn: Attention, x: torch.Tensor, cos, sin, mesh):
    """q, k, v (b, 1, all heads, dh) of a decode token on a rank whose
    cache holds every head: the rank's heads all-gathered over "model"
    (every head of the whole KV projections where it keeps
    ``kv_heads``)."""
    q = attn.project_q(x, cos, sin)
    k, v = attn.project_kv(x, cos, sin, all_heads=True)
    if attn.mesh is not None:
        q = _gather_heads(q, mesh)
        if attn.kv_heads is None:
            k, v = _gather_heads(k, mesh), _gather_heads(v, mesh)
    return q, k, v


def _write_segment(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor, cut: KVCut) -> None:
    """Write the new row (b, 1, K, dh) at ``pos`` (clamped into the whole
    cache, as the reference's ``dynamic_update_slice`` clamps) on the rank
    whose segment holds it; the others write their old row back."""
    local = pos.clamp(max=cut.S - 1) - cut.offset
    own = (local >= 0) & (local < cut.S_l)
    at = local.clamp(0, cut.S_l - 1).long().reshape(1)
    cache.index_copy_(1, at, torch.where(own, new.to(cache.dtype),
                                         cache.index_select(1, at)))


def _decode_segment(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, length: torch.Tensor,
                    cut: KVCut, window: int, window_end=None):
    """This rank's segment of one decode position that sees the first
    ``length`` (() int32) positions of the whole cache, its window ending
    at ``window_end`` (``length`` when None): (out (b, H, dh) f32, lse
    (b, H)), a segment that sees nothing giving 0 and -inf."""
    end = length if window_end is None else window_end
    return ops.decode_attention(
        _scaled_q(q[:, 0], cache_k), cache_k, cache_v,
        (length - cut.offset).clamp(0, cut.S_l).to(torch.int32),
        sm_scale=1.0, window=window,
        window_end=(end - cut.offset).to(torch.int32) if window > 0
        else None, return_lse=True)


def attention_decode_seq_apply(attn: Attention, x: torch.Tensor, cos, sin,
                               cache_k: torch.Tensor, cache_v: torch.Tensor,
                               pos: torch.Tensor, cut: KVCut, *,
                               window: int = 0) -> torch.Tensor:
    """:func:`attention_decode_apply` on a rank whose cache (b, S_l, K,
    dh) holds every KV head and a segment of the sequence (``cut``): every
    head's q and new K/V row gathered over "model", the row written by
    the rank whose segment holds ``pos``, each rank's segment decoded with
    the contiguous decode kernel's window end and lse at the shared length
    ``pos + 1`` clamped into it, the segments merged by their
    log-sum-exps, and the rank's heads through the row-parallel ``wo``.
    Returns out (b, 1, d)."""
    q, k, v = _whole_qkv(attn, x, cos, sin, cut.mesh)
    _write_segment(cache_k, k, pos, cut)
    _write_segment(cache_v, v, pos, cut)
    o, lse = _decode_segment(q, cache_k, cache_v, pos + 1, cut, window)
    o = _my_heads(_merge_segments(o, lse, cut), attn, cut.mesh)
    return attn.out(o.to(q.dtype).reshape(x.shape[0], 1, -1))


def cross_decode_seq_apply(attn: Attention, x: torch.Tensor,
                           xk: torch.Tensor, xv: torch.Tensor,
                           length: torch.Tensor, cut: KVCut) -> torch.Tensor:
    """The cross-attention decode over the encoder's K/V cached as in
    :func:`attention_decode_seq_apply` (no write; ``length`` the source
    length, () int32).  Returns out (b, 1, d)."""
    q = attn.project_q(x, None, None)
    if attn.mesh is not None:
        q = _gather_heads(q, cut.mesh)
    o, lse = _decode_segment(q, xk, xv, length, cut, 0)
    o = _my_heads(_merge_segments(o, lse, cut), attn, cut.mesh)
    return attn.out(o.to(q.dtype).reshape(x.shape[0], 1, -1))


def _split_apply_cut(attn: Attention, x: torch.Tensor, cos, sin,
                     prefix_k, prefix_v, sk, sv, pos, prefix_len,
                     window: int, cut: KVCut) -> torch.Tensor:
    """The append-buffer decode on a rank mesh: the suffix ring,
    replicated over "model" with every KV head, takes every head's new
    row; the prefix is read per ``cut`` (the rank's heads, or its segment
    of every head, merged with the other ranks' segments), and the ring's
    part joins the merge once."""
    mesh = cut.mesh
    if cut.whole_heads:
        q, k, v = _whole_qkv(attn, x, cos, sin, mesh)
    else:
        q, k, v = attn.project_qkv(x, cos, sin)
        if attn.mesh is not None:
            k, v = _gather_heads(k, mesh), _gather_heads(v, mesh)
    slot = pos - prefix_len
    at = slot.clamp(0, sk.shape[1] - 1).long().reshape(1)
    sk.index_copy_(1, at, k.to(sk.dtype))
    sv.index_copy_(1, at, v.to(sv.dtype))
    if cut.whole_heads:
        prefix = _decode_segment(q, prefix_k, prefix_v, prefix_len, cut,
                                 window, window_end=pos + 1)
        suffix = ops.decode_attention(
            _scaled_q(q[:, 0], sk), sk, sv, slot + 1, sm_scale=1.0,
            window=window, return_lse=True)
        o = _my_heads(_merge_segments(*prefix, cut, [suffix]), attn, mesh)
    else:
        kl = attn.n_kv_heads
        lo = mesh.coord(MODEL_AXIS) * kl if attn.mesh is not None else 0
        ring_k = sk[:, :, lo:lo + kl].contiguous()
        ring_v = sv[:, :, lo:lo + kl].contiguous()
        prefix = ops.decode_attention(
            _scaled_q(q[:, 0], prefix_k), prefix_k, prefix_v, prefix_len,
            sm_scale=1.0, window=window, window_end=pos + 1,
            return_lse=True)
        suffix = ops.decode_attention(
            _scaled_q(q[:, 0], ring_k), ring_k, ring_v, slot + 1,
            sm_scale=1.0, window=window, return_lse=True)
        o = combine_lse_parts([prefix, suffix])
    return attn.out(o.to(q.dtype).reshape(x.shape[0], 1, -1))


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
    q, k, v = attn.project_qkv(x, cos, sin)
    rows, pos, keep = write
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache.index_put_((rows, pos), torch.where(
            keep, new[:, 0].to(cache.dtype), cache[rows, pos]))
    return attn.out(decode_attention(q, cache_k, cache_v, lengths + 1,
                                     window=window))


def attention_decode_paged_apply(attn: Attention, x: torch.Tensor,
                                 cos, sin, arena_k: torch.Tensor,
                                 arena_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 write_bid: torch.Tensor,
                                 write_off: torch.Tensor, *,
                                 window: int = 0,
                                 kv_rows: Optional[Callable] = None
                                 ) -> torch.Tensor:
    """One paged continuous-batching decode step: each row writes its new
    K/V into arena block ``write_bid[i]`` at offset ``write_off[i]`` (the
    junk block 0 for inactive rows) and attends over its own block table's
    first ``lengths[i] + 1`` positions (the last ``window`` of them when
    ``window`` > 0).  x: (b, 1, d); arenas (n_blocks, bs,
    K, dh), written IN PLACE (the reference donates them to XLA instead);
    tables (b, n_pages) i32; lengths (b,) i32.  ``kv_rows`` maps the rows'
    new K/V (b, 2, K, dh) to those of every row the write indices cover
    (the all-gather over "data" when a rank mesh cuts the rows); without
    it they are the same rows.  Returns out (b, 1, d)."""
    q, k, v = attn.project_qkv(x, cos, sin)
    k, v = k[:, 0], v[:, 0]
    if kv_rows is not None:
        k, v = kv_rows(torch.stack([k, v], 1)).unbind(1)
    arena_k.index_put_((write_bid, write_off), k.to(arena_k.dtype))
    arena_v.index_put_((write_bid, write_off), v.to(arena_v.dtype))
    o = ops.paged_decode_attention(_scaled_q(q[:, 0], arena_k), arena_k,
                                   arena_v, tables, lengths + 1, sm_scale=1.0,
                                   window=window)
    return attn.out(o.to(q.dtype).reshape(x.shape[0], 1, -1))


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
    q, k, v = attn.project_qkv(x, cos, sin)
    arena_k.index_put_((write_bid, write_off), k[0].to(arena_k.dtype))
    arena_v.index_put_((write_bid, write_off), v[0].to(arena_v.dtype))
    o = ops.paged_prefill_attention(_scaled_q(q[0], arena_k), arena_k,
                                    arena_v, table, positions, sm_scale=1.0,
                                    window=window)
    return attn.out(o.to(q.dtype).reshape(1, x.shape[1], -1))


# =============================================================================
# MLP (SwiGLU or plain GELU)
# =============================================================================
class MLP(nn.Module):
    """SwiGLU (or GELU) MLP of width ``d_ff`` (``cfg.d_ff`` by default; an
    MoE's shared experts pass their summed width).  On a rank mesh
    ``wi_gate`` / ``wi_up`` hold the rank's columns of the width and
    ``wo`` its rows, and ``mesh`` is set: one all-reduce over "model"
    adds the partial outputs."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        self.mesh = None
        d, d_ff = cfg.d_model, d_ff or cfg.d_ff
        out_std = d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5
        self.wi_gate = (init_dense(d, d_ff, cfg, device, gen)
                        if cfg.act == "silu" else None)
        self.wi_up = init_dense(d, d_ff, cfg, device, gen)
        self.wo = init_dense(d_ff, d, cfg, device, gen, stddev=out_std)

    def forward(self, x: torch.Tensor, sp: bool = False) -> torch.Tensor:
        return mlp_apply(self, x, sp)


def mlp_apply(p: MLP, x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """The MLP of x (b, s, d); on a rank mesh its partial outputs summed
    over "model", or with ``sp`` reduce-scattered along the sequence."""
    x = C.copy_to(x, p.mesh, MODEL_AXIS)
    up = p.wi_up(x)
    if p.wi_gate is not None:
        h = F.silu(p.wi_gate(x)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    if sp:
        return C.scatter_dim(p.wo(h), p.mesh, MODEL_AXIS, 1)
    return C.reduce_from(p.wo(h), p.mesh, MODEL_AXIS)


# =============================================================================
# embedding
# =============================================================================
def embedding_apply(table: torch.Tensor, ids: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """Rows of ``table`` for ``ids``.  On a rank mesh (``mesh`` given,
    ``table`` the rank's vocab slice) the ids outside the slice are masked,
    their rows zeroed, and the ranks' lookups summed over "model"."""
    if mesh is None:
        return F.embedding(ids, table)
    n = table.shape[0]
    lo = mesh.coord(MODEL_AXIS) * n
    mine = (ids >= lo) & (ids < lo + n)
    rows = F.embedding((ids - lo).clamp(0, n - 1), table)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return C.reduce_from(rows, mesh, MODEL_AXIS)


def embedding_logits(table: torch.Tensor, x: torch.Tensor, mesh=None,
                     padded_vocab: Optional[int] = None) -> torch.Tensor:
    """Tied-softmax readout: x @ table.T.  On a rank mesh, the logits of the
    rank's vocab slice, its padding rows (ids past ``padded_vocab``) at
    -inf, so that they never win the greedy pick."""
    logits = F.linear(x, table)
    if mesh is not None:
        n = table.shape[0]
        real = padded_vocab - mesh.coord(MODEL_AXIS) * n
        if real < n:
            logits[..., max(real, 0):] = float("-inf")
    return logits


def greedy_token(logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """The argmax token of ``logits`` (..., V) -> (...) int64.  On a rank
    mesh ``logits`` is the rank's vocab slice: each rank's best value and
    its global id are gathered over "model" (one collective, both packed
    exactly in f64) and the best wins, ties to the lowest id —
    ``torch.argmax``'s rule.  Nothing is read back to the host."""
    if mesh is None or mesh.shape[MODEL_AXIS] == 1:
        return logits.argmax(dim=-1)
    idx = logits.argmax(dim=-1, keepdim=True)
    val = logits.gather(-1, idx)[..., 0]
    lo = mesh.coord(MODEL_AXIS) * logits.shape[-1]
    both = C.all_gather(torch.stack([val.double(), (idx[..., 0] + lo).double()],
                                    -1), mesh, MODEL_AXIS)
    vals, ids = both[..., 0], both[..., 1]
    best = vals.amax(0)
    ids = torch.where(vals == best, ids, torch.full_like(ids, float("inf")))
    return ids.amin(0).long()
