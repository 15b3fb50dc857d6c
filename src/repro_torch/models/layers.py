"""Dense decoder building blocks — the port's counterpart of the reference
package's ``models/layers.py``, for the dense family the paged engine
serves: RMSNorm, rotary embeddings (partial rotary), GQA attention with
qk-norm over a paged KV arena, the SwiGLU MLP and the tied embedding.

Parameters live in ``nn.Module``s; the math is plain functions on tensors
that follow the reference's rounding order (norms in f32 then cast back,
rotary tables cast to the activation type, q scaled and cast to the arena
type before the dot).  The attention over the arena goes through
``kernels/ops.py``: the Hopper kernels for CUDA tensors, their plain
versions on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import gather_paged_kv
from repro_torch.models.config import ModelConfig

__all__ = ["RMSNorm", "Attention", "MLP", "rmsnorm_apply", "rope_table",
           "apply_rope", "mlp_apply", "embedding_apply", "embedding_logits",
           "gather_paged_kv", "attention_decode_paged_apply",
           "attention_prefill_paged_apply", "init_dense", "trunc_normal"]


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
# attention (GQA + qk-norm) over the paged arena
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

    def project_qkv(self, x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor):
        """The reference's ``_project_qkv``: x (b, s, d) -> rotated q
        (b, s, H, dh), k and v (b, s, K, dh)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, cfg.n_heads, cfg.d_head)
        k = self.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        v = self.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, cos, sin, cfg.partial_rotary)
        k = apply_rope(k, cos, sin, cfg.partial_rotary)
        return q, k, v


def _scaled_q(q: torch.Tensor, arena: torch.Tensor) -> torch.Tensor:
    """q * dh**-0.5 in q's type, then cast to the arena's — the rounding
    order of the reference's model path; the kernels then take
    ``sm_scale=1.0``."""
    return (q * q.shape[-1] ** -0.5).to(arena.dtype).contiguous()


def attention_decode_paged_apply(attn: Attention, x: torch.Tensor,
                                 cos, sin, arena_k: torch.Tensor,
                                 arena_v: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 write_bid: torch.Tensor,
                                 write_off: torch.Tensor) -> torch.Tensor:
    """One paged continuous-batching decode step: each row writes its new
    K/V into arena block ``write_bid[i]`` at offset ``write_off[i]`` (the
    junk block 0 for inactive rows) and attends over its own block table's
    first ``lengths[i] + 1`` positions.  x: (b, 1, d); arenas (n_blocks, bs,
    K, dh), written IN PLACE (the reference donates them to XLA instead);
    tables (b, n_pages) i32; lengths (b,) i32.  Returns out (b, 1, d)."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    b = x.shape[0]
    arena_k.index_put_((write_bid, write_off), k[:, 0].to(arena_k.dtype))
    arena_v.index_put_((write_bid, write_off), v[:, 0].to(arena_v.dtype))
    o = ops.paged_decode_attention(_scaled_q(q[:, 0], arena_k), arena_k,
                                   arena_v, tables, lengths + 1, sm_scale=1.0)
    return attn.wo(o.to(q.dtype).reshape(b, 1, cfg.n_heads * cfg.d_head))


def attention_prefill_paged_apply(attn: Attention, x: torch.Tensor,
                                  cos, sin, arena_k: torch.Tensor,
                                  arena_v: torch.Tensor, table: torch.Tensor,
                                  positions: torch.Tensor,
                                  write_bid: torch.Tensor,
                                  write_off: torch.Tensor) -> torch.Tensor:
    """One chunk of chunked prefill for a single sequence against the paged
    arena: the chunk's rotated K/V land in their arena slots IN PLACE (junk
    block 0 for the padded tail), then the chunk's queries attend causally
    over the table — cached prefix blocks included, so a prefix-cache hit
    never replays shared tokens.  x: (1, C, d); table (span,) i32;
    positions (C,) i32 absolute positions.  Returns out (1, C, d)."""
    cfg = attn.cfg
    q, k, v = attn.project_qkv(x, cos, sin)
    C = x.shape[1]
    arena_k.index_put_((write_bid, write_off), k[0].to(arena_k.dtype))
    arena_v.index_put_((write_bid, write_off), v[0].to(arena_v.dtype))
    o = ops.paged_prefill_attention(_scaled_q(q[0], arena_k), arena_k,
                                    arena_v, table, positions, sm_scale=1.0)
    return attn.wo(o.to(q.dtype).reshape(1, C, cfg.n_heads * cfg.d_head))


# =============================================================================
# MLP (SwiGLU or plain GELU)
# =============================================================================
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_ff
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
