"""Plain reference of the dense decoder (qwen3, glm4): the forward pass in
PyTorch, f32 throughout, layer by layer, attention in blocks of queries.
It imports nothing of the program and reads nothing the program made:
only the benchmark's weights (``weights.py``) and token ids.

Equations (pre-norm decoder):
    x = embed[tokens]
    per layer:  h = rmsnorm(x) * ln1
                q = h Wq^T (+ bq), k = h Wk^T (+ bk), v = h Wv^T (+ bv)
                qwen3: q, k = rmsnorm over each head's dh * q_norm / k_norm
                rotary on the first d_rot = dh * partial_rotary dims of
                each head, rotate-half pairing (i, i + d_rot / 2),
                inverse frequencies theta^(-j / (d_rot / 2))
                query head h reads KV head h // (H / K); softmax(q k^T /
                sqrt(dh)) causal; x += (attn) Wo^T
                h = rmsnorm(x) * ln2; x += (silu(h Wg^T) * (h Wu^T)) Wd^T
    logits = (rmsnorm(x) * final_norm) E^T, E the embedding (tied) or the
    head, over every row the weights hold (padding rows included).

Departure: GLM-4 pairs interleaved dimensions (2i, 2i + 1) in its rotary
part; here, as in the program, the pairs are (i, i + 32).  The two are
the same function up to a fixed permutation of the rotary columns of Wq
and Wk; with seeded weights the work and its numerics are the same.

``quant="fp8"`` is the control: every projection and MLP product takes
its weight and its input rounded to float8 e4m3 with a scale per output
row and per token, as an fp8 serving path would (the embedding and the
head stay f32).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Q_BLOCK = 512
FP8_MAX = 448.0


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        scale.float()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled per row (last dim)."""
    s = t.abs().amax(-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            quant: Optional[str]) -> torch.Tensor:
    wf = w.float()
    if quant == "fp8":
        x, wf = _fp8(x), _fp8(wf)
    y = x @ wf.T
    return y if b is None else y + b.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, d_rot: int, theta: float
          ) -> torch.Tensor:
    """x (S, heads, dh) rotated at positions ``pos`` (S,)."""
    half = d_rot // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.double()[:, None] * inv).float()
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:d_rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., d_rot:]], -1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Causal GQA attention, q (S, H, dh), k and v (S, K, dh), in blocks
    of queries."""
    S, H, dh = q.shape
    g = H // k.shape[1]
    kh = k.repeat_interleave(g, 1).transpose(0, 1)       # (H, S, dh)
    vh = v.repeat_interleave(g, 1).transpose(0, 1)
    out = torch.empty_like(q)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        qb = q[q0:q1].transpose(0, 1)                    # (H, qb, dh)
        s = (qb @ kh[:, :q1].transpose(1, 2)) * dh ** -0.5
        mask = (torch.arange(q1, device=q.device)[None, :]
                > torch.arange(q0, q1, device=q.device)[:, None])
        s.masked_fill_(mask, float("-inf"))
        out[q0:q1] = (s.softmax(-1) @ vh[:, :q1]).transpose(0, 1)
    return out


@torch.no_grad()
def logits(w: Dict[str, torch.Tensor], model: Dict, n_layers: int,
           tokens: torch.Tensor, first: int, quant: Optional[str] = None
           ) -> torch.Tensor:
    """f32 logits (S - first, rows) of the positions ``first`` .. S - 1
    of ``tokens`` (S,), through the first ``n_layers`` layers."""
    eps = float(model["norm_eps"])
    H, K, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    d_rot = int(dh * float(model["partial_rotary"]))
    theta = float(model["rope_theta"])
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = F.embedding(tokens, w["embed"]).float()
    for i in range(n_layers):
        p = f"layers.{i}."
        h = _rms(x, w[p + "ln1"], eps)
        q = _linear(h, w[p + "wq"], w.get(p + "bq"), quant).view(S, H, dh)
        k = _linear(h, w[p + "wk"], w.get(p + "bk"), quant).view(S, K, dh)
        v = _linear(h, w[p + "wv"], w.get(p + "bv"), quant).view(S, K, dh)
        if p + "q_norm" in w:
            q = _rms(q, w[p + "q_norm"], eps)
            k = _rms(k, w[p + "k_norm"], eps)
        q, k = _rope(q, pos, d_rot, theta), _rope(k, pos, d_rot, theta)
        a = _attention(q, k, v).reshape(S, H * dh)
        x = x + _linear(a, w[p + "wo"], None, quant)
        h = _rms(x, w[p + "ln2"], eps)
        x = x + _linear(F.silu(_linear(h, w[p + "w_gate"], None, quant))
                        * _linear(h, w[p + "w_up"], None, quant),
                        w[p + "w_down"], None, quant)
    head = w.get("lm_head", w["embed"])
    return _rms(x[first:], w["final_norm"], eps) @ head.float().T
