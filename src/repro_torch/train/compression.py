"""Compressed gradient all-reduce over ``torch.distributed`` — the port's
counterpart of the reference package's ``train/compression.py`` (there a
``psum`` over a mesh axis inside ``shard_map``).

Methods:
  * None / "f32" — f32 all-reduce, divided by the world size;
  * "bf16" — cast to bf16 before the all-reduce (half the wire bytes),
    the mean taken in bf16, then widened to f32;
  * "int8" — per-tensor scale, shared by an all-reduce MAX, the int8
    payload summed as int32 (no overflow up to 2**24 ranks) and divided by
    the world size; :class:`ErrorFeedback` carries the quantisation error
    of one step into the next.

Gradients are dicts keyed by parameter name; the process group (the
default when None) must be initialised by the caller.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

Grads = Mapping[str, torch.Tensor]


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_mean(grads: Grads, group=None, method: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the group's ranks of each gradient, f32, by
    ``method`` (None / "f32", "bf16" or "int8")."""
    n = dist.get_world_size(group)
    if method is None or method == "f32":
        return {k: _sum(g.float().clone(), group) / n
                for k, g in grads.items()}
    if method == "bf16":
        return {k: (_sum(g.to(torch.bfloat16).clone(), group) / n).float()
                for k, g in grads.items()}
    if method == "int8":
        return {k: _int8_mean(g.float(), group, n)[0]
                for k, g in grads.items()}
    raise ValueError(f"unknown compressor {method!r}")


def _int8_mean(gf: torch.Tensor, group, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the int8-compressed mean of gf over the group, gf's dequantised
    int8 form on this rank)."""
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    summed = _sum(q.to(torch.int8).to(torch.int32), group)
    return summed.float() * scale / float(n), q * scale


class ErrorFeedback:
    """Residual accumulator for the biased int8 compressor: the
    quantisation error of step t is added to the gradient of step t+1."""

    @staticmethod
    def init(grads_like: Grads) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device)
                for k, g in grads_like.items()}

    @staticmethod
    def compress_with_feedback(grads: Grads, residual: Grads, group=None
                               ) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor]]:
        """(the int8 mean of grads + residual, the new residual)."""
        n = dist.get_world_size(group)
        out, res = {}, {}
        for k, g in grads.items():
            gf = g.float() + residual[k]
            out[k], deq = _int8_mean(gf, group, n)
            res[k] = gf - deq
        return out, res
