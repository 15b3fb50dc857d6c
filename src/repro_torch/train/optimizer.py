"""AdamW with global-norm clipping and a cosine schedule — the port's
counterpart of the reference package's ``train/optimizer.py``, with its
arithmetic: f32 moments, clipping by ``min(1, clip / (gnorm + 1e-9))``,
bias corrections ``1 - b ** t`` in f32, decoupled weight decay on the
reference's matrices, and the update cast to the parameter's type before
it is subtracted.

The state mirrors the parameters by name: ``{"m": {name: f32}, "v": {name:
f32}, "step": () int32}``.  The reference decays a leaf of two or more
dimensions in its stacked layout, so every per-layer leaf decays (a norm
scale is (L, d) there) and of the unstacked ones only the matrices; the
port's per-layer tensors are 1-D, so the mask comes from the reference's
layout (``models/bridge.py`` ``decay_mask``), never from the port's own
``ndim``.  Parameters are updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch.models import bridge

Grads = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``lr * min_lr_ratio``
    at ``total_steps``: an f32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: nn.Module) -> dict:
    """Zero f32 moments for every parameter, on its device, and step 0."""
    named = dict(params.named_parameters())
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    dev = next(iter(named.values())).device
    return {"m": zeros, "v": {n: z.clone() for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Grads) -> torch.Tensor:
    """sqrt of the sum of every tensor's sum of squares, in f32."""
    return torch.sqrt(torch.stack(
        [g.float().square().sum() for g in grads.values()]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Grads, opt_state: dict,
                 params: nn.Module) -> Tuple[nn.Module, dict, dict]:
    """One AdamW step on ``params`` (updated in place) from ``grads`` keyed
    by parameter name -> (params, the new optimizer state, {"grad_norm",
    "lr"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1 - torch.full_like(t, b1) ** t
    bc2 = 1 - torch.full_like(t, b2) ** t
    lr = schedule(cfg, step)
    decay = bridge.decay_mask(params)
    m_new: Dict[str, torch.Tensor] = {}
    v_new: Dict[str, torch.Tensor] = {}
    for name, p in params.named_parameters():
        g = grads[name].float() * scale
        m = b1 * opt_state["m"][name] + (1 - b1) * g
        v = b2 * opt_state["v"][name] + (1 - b2) * g.square()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay[name]:               # decoupled weight decay
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p - (lr * delta).to(p.dtype))
        m_new[name], v_new[name] = m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": m_new, "v": v_new, "step": step}, metrics
