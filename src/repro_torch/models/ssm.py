"""Mamba2 (state-space duality) block — the port's counterpart of the
reference package's ``models/ssm.py``.

The full-sequence block (:func:`mamba2_apply`) runs the chunked SSD scan
through ``kernels/ops.py``: the Hopper kernel for CUDA tensors, its plain
version (``kernels/ref.py`` ``ssd_chunked_ref``, the one plain version) on
the CPU.  Decode (:func:`mamba2_decode_step`) is the exact O(1)
recurrence h <- h exp(dt A) + dt x Bᵀ, y = h C + D x, plus a rolling
depthwise-conv history, in plain PyTorch (the reference has no kernel for
it).  z / x / B / C / dt are separate projections, as in the reference.

Rounding follows the reference: the forward conv sums its k shifted
products in the model's type; the decode conv computes in f32 on a history
of the cache's type (the new column is rounded to it); the gate is
``rmsnorm(y) * silu(z)``; ``dt = softplus(dt + dt_bias)`` and
``A = -exp(A_log)`` in f32.

On a rank mesh (``models/registry.py`` ``shard_params``, after
``sharding/rules.py``'s mamba2 rules) a block holds the rank's heads:
``wz``, ``wx``, ``wdt`` cut by column, ``conv_x`` / ``conv_bx`` by channel,
``A_log`` / ``D`` / ``dt_bias`` by head, ``out_proj`` by row with one
all-reduce over "model"; ``wB``, ``wC`` and their convs stay whole, and
the rank passes the scan the groups its heads read (``groups``: the
kernels map a head to its group by the local head count).  The gate's
RMSNorm runs over the whole ``d_inner``: the rank's sum of squares is
all-reduced over "model" (its gradient too, since each rank's slice of
the work reads it) and the rank applies its slice of the scale.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as CL
from repro_torch.sharding.rules import MODEL_AXIS

SSMCache = Dict[str, torch.Tensor]


class Mamba2(nn.Module):
    """One Mamba2 block's weights, initialised as the reference's
    ``init_mamba2``: dense projections (d -> d_inner, G·N, G·N, H; out
    d_inner -> d), depthwise conv kernels (k, channels) and biases in the
    model's type; ``A_log``, ``D`` and ``dt_bias`` (H,) in f32 whatever
    the model's type.  ``heads`` and ``groups`` are (first, count) of the
    heads the block computes and of the groups they read (all of them
    unsharded); ``mesh`` is the rank mesh of a cut block (None
    unsharded)."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.mesh = None
        self.heads = (0, cfg.n_ssm_heads)
        self.groups = (0, cfg.ssm_groups)
        d, di = cfg.d_model, cfg.d_inner
        G, N, H, k = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads, \
            cfg.ssm_conv
        self.cfg = cfg
        self.wz = L.init_dense(d, di, cfg, device, gen)
        self.wx = L.init_dense(d, di, cfg, device, gen)
        self.wB = L.init_dense(d, G * N, cfg, device, gen)
        self.wC = L.init_dense(d, G * N, cfg, device, gen)
        self.wdt = L.init_dense(d, H, cfg, device, gen)

        def conv(c):
            return nn.Parameter(L.trunc_normal((k, c), k ** -0.5, cfg.dtype,
                                               device, gen))

        def zeros(c, dtype=cfg.dtype):
            return nn.Parameter(torch.zeros(c, dtype=dtype, device=device))
        self.conv_x, self.conv_B, self.conv_C = conv(di), conv(G * N), \
            conv(G * N)
        self.conv_bx, self.conv_bB, self.conv_bC = zeros(di), zeros(G * N), \
            zeros(G * N)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=device)))
        self.D = nn.Parameter(torch.ones(H, dtype=torch.float32,
                                         device=device))
        self.dt_bias = zeros(H, torch.float32)
        self.gate_norm = L.RMSNorm(di, cfg, device)
        self.out_proj = L.init_dense(
            di, d, cfg, device, gen,
            stddev=di ** -0.5 / (2 * cfg.n_layers) ** 0.5)


# =============================================================================
# projections + causal depthwise conv
# =============================================================================
def conv_causal(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (b, s, c); w: (k, c); the k shifted
    products are summed in x's type."""
    s, k = x.shape[1], w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def project(m: Mamba2, x: torch.Tensor):
    """(z, x, B, C, dt) projections of x (..., d)."""
    return m.wz(x), m.wx(x), m.wB(x), m.wC(x), m.wdt(x)


def _my_groups(m: Mamba2, t: torch.Tensor) -> torch.Tensor:
    """The groups (dim -2) a cut block's heads read, contiguous."""
    if m.mesh is None:
        return t
    g0, gl = m.groups
    return t[..., g0:g0 + gl, :].contiguous()


def _gate_out(m: Mamba2, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``out_proj(rmsnorm(y) * silu(z))``; on a rank mesh the norm over
    the whole ``d_inner`` from the ranks' summed squares, the rank's
    slice of its scale, and the row-parallel output summed over
    "model"."""
    if m.mesh is None:
        return m.out_proj(m.gate_norm(y) * F.silu(z))
    yf = y.float()
    ss = CL.sum_over(yf.square().sum(-1, keepdim=True), m.mesh, MODEL_AXIS,
                     backward_sum=True)
    yn = yf * torch.rsqrt(ss / m.cfg.d_inner + m.gate_norm.eps)
    lo = m.heads[0] * m.cfg.ssm_head_dim
    scale = m.gate_norm.scale[lo:lo + y.shape[-1]]
    return CL.reduce_from(m.out_proj(yn.to(y.dtype) * scale * F.silu(z)),
                          m.mesh, MODEL_AXIS)


def mamba2_apply(m: Mamba2, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (b, s, d) -> (b, s, d); s must be a
    multiple of the config's ``ssm_chunk`` (the scan does not pad)."""
    cfg = m.cfg
    b, s, _ = x.shape
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, m.heads[1], \
        cfg.ssm_head_dim
    x = CL.copy_to(x, m.mesh, MODEL_AXIS)
    z, xs, B, C, dt = project(m, x)
    xs = F.silu(conv_causal(xs, m.conv_x, m.conv_bx)).reshape(b, s, H, P)
    B = _my_groups(m, F.silu(conv_causal(B, m.conv_B, m.conv_bB)).reshape(
        b, s, G, N))
    C = _my_groups(m, F.silu(conv_causal(C, m.conv_C, m.conv_bC)).reshape(
        b, s, G, N))
    dt = F.softplus(dt.float() + m.dt_bias[None, None, :])
    A = -torch.exp(m.A_log)
    y, _ = ops.ssd_chunked(xs, dt, A, B, C, chunk=cfg.ssm_chunk)
    y = y + xs.float() * m.D[None, None, :, None]
    y = y.reshape(b, s, H * P).to(x.dtype)
    return _gate_out(m, y, z)


# =============================================================================
# decode (exact O(1) recurrence)
# =============================================================================
def init_ssm_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> SSMCache:
    """Decode state of a Mamba2 block: the conv histories ``conv_x``
    (b, k-1, d_inner), ``conv_B`` and ``conv_C`` (b, k-1, G·N) in
    ``dtype``, and the f32 ``state`` (b, H, P, N)."""
    di, GN, k = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_conv
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    return {"conv_x": zeros(batch, k - 1, di),
            "conv_B": zeros(batch, k - 1, GN),
            "conv_C": zeros(batch, k - 1, GN),
            "state": zeros(batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state, dt=torch.float32)}


def conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One step of the causal conv.  hist: (b, k-1, c), advanced IN PLACE
    (the reference returns the new history); new: (b, c), rounded to the
    history's type.  Returns out (b, c) f32."""
    full = torch.cat([hist, new[:, None, :].to(hist.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", full.float(), w.float()) + b.float()
    hist.copy_(full[:, 1:])
    return out


def mamba2_decode_step(m: Mamba2, x: torch.Tensor,
                       cache: SSMCache) -> torch.Tensor:
    """x: (b, 1, d) -> y (b, 1, d).  ``cache`` is one layer's decode state
    (:func:`init_ssm_cache`), advanced IN PLACE."""
    cfg = m.cfg
    b = x.shape[0]
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, m.heads[1], \
        cfg.ssm_head_dim
    di = H * P
    z, xs, B, C, dt = project(m, x[:, 0, :])
    xs = F.silu(conv_step(cache["conv_x"], xs, m.conv_x, m.conv_bx))
    B = F.silu(conv_step(cache["conv_B"], B, m.conv_B, m.conv_bB))
    C = F.silu(conv_step(cache["conv_C"], C, m.conv_C, m.conv_bC))
    xs = xs.reshape(b, H, P)
    hpg = H // m.groups[1]
    Bh = _my_groups(m, B.reshape(b, G, N)).repeat_interleave(hpg, dim=1)
    Ch = _my_groups(m, C.reshape(b, G, N)).repeat_interleave(hpg, dim=1)
    dt = F.softplus(dt.float() + m.dt_bias[None, :])                # (b, H)
    dA = torch.exp(dt * -torch.exp(m.A_log)[None, :])
    state = cache["state"]
    state.mul_(dA[..., None, None]).add_(
        (dt[..., None] * xs)[..., None] * Bh[:, :, None, :])       # (b, H, P, N)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xs * m.D[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    return _gate_out(m, y, z)[:, None, :]

