"""Mixture-of-Experts layer — the port's counterpart of the reference
package's ``models/moe.py``: group-wise GShard routing with a capacity per
expert and group, Switch load-balance aux loss, shared experts (qwen2-moe:
4 shared + 60 routed top-4, padded to 64).

The reference tiles the ``T = b·s`` tokens of a call into groups, gives each
expert ``C`` slots per group and drops, in token order, the (token, expert)
pairs beyond them; it dispatches and combines through one-hot tensors of
shape (G, t, k, E, C).  :func:`moe_apply` computes the same routing,
positions and drops, but moves the rows by index: each kept pair's row is
scattered to its (expert, slot) of a (G, E, C, d) buffer, and the combine
gathers the experts' outputs back with the gates.  The expert products run
over all E experts as batched products, as the reference's einsums do.
Group size and capacity come from shapes only, so nothing here reads the
device from the host.

On a rank mesh (``models/registry.py`` ``shard_params``, after
``sharding/rules.py``'s "E" / "F" entries) the router and the dispatch
stay whole — every rank routes every token, with the reference's capacity
and drop order — and the experts are cut over "model": whole experts
(``experts`` = (first, count), expert parallelism) when the model axis
divides the padded expert count, else every expert's FF width (its
columns of ``w_gate`` / ``w_up``, its rows of ``w_down``).  Either way a
rank's combine is a partial sum of the token's outputs, which one f32
all-reduce over "model" completes before the cast to the model's type
(with ``sp``, the sequence-parallel forward, a reduce-scatter along the
sequence).  In training the replicated router's gradient is whole on
every rank: the rows dispatched to the experts and the gates that weigh
their outputs enter the cut work through ``collectives.copy_to``, whose
backward sums the ranks' partial gradients over "model", and the
load-balance loss is computed alike on every rank.  A training step
gives each data replica its rows of the global batch (``train/
parallel.py``); there the routing groups and capacity are the global
batch's — a group may not span two replicas' rows — and the
load-balance loss's two per-expert means are over the global batch,
each replica's means summed over the data axes.  The mean probability's
gradient is summed over them too: every replica's loss holds the same
load-balance term, and the step averages the replicas' gradients.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as CL
from repro_torch.sharding.rules import MODEL_AXIS, axes_size, data_axes


class MoE(nn.Module):
    """``router`` (d, E) f32 whatever the model's type; ``w_gate``, ``w_up``
    (E, d, F) and ``w_down`` (E, F, d) in ``cfg.dtype`` with E =
    ``cfg.padded_experts``; ``shared``, an MLP of width ``n_shared_experts ·
    d_expert_ff``, when the config has shared experts.  ``experts`` is
    (first, count) of the experts the weights hold (all of them unsharded)
    and ``mesh`` the rank mesh their partial outputs are summed over (None
    unsharded)."""

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator):
        super().__init__()
        self.experts = (0, cfg.padded_experts)
        self.mesh = None
        d, E, F_ = cfg.d_model, cfg.padded_experts, cfg.d_expert_ff
        out_std = F_ ** -0.5 / (2 * cfg.n_layers) ** 0.5
        self.router = nn.Parameter(L.trunc_normal(
            (d, E), d ** -0.5, torch.float32, device, gen))
        self.w_gate = nn.Parameter(L.trunc_normal(
            (E, d, F_), d ** -0.5, cfg.dtype, device, gen))
        self.w_up = nn.Parameter(L.trunc_normal(
            (E, d, F_), d ** -0.5, cfg.dtype, device, gen))
        self.w_down = nn.Parameter(L.trunc_normal(
            (E, F_, d), out_std, cfg.dtype, device, gen))
        self.shared = (L.MLP(cfg, device, gen,
                             d_ff=cfg.n_shared_experts * F_)
                       if cfg.n_shared_experts else None)


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.padded_experts
            * cfg.capacity_factor)
    return max(c, 1)


def group_and_capacity(b: int, s: int, cfg: ModelConfig) -> Tuple[int, int]:
    """(group size, capacity per expert and group) of a (b, s) call: the
    group is ``moe_group_size`` tokens, halved until it divides ``b·s``;
    a prefill's capacity is ``_capacity``, a decode's (s == 1) about
    ``decode_capacity_factor`` times the mean load, at least ``top_k`` and
    at most the group."""
    T = b * s
    gsz = min(cfg.moe_group_size, T)
    while T % gsz:
        gsz //= 2
    C = _capacity(gsz, cfg)
    if s == 1:
        c_head = int(gsz * cfg.top_k / cfg.padded_experts
                     * cfg.decode_capacity_factor)
        C = min(gsz, max(c_head, cfg.top_k, 1))
    return gsz, C


def _route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (..., E) f32 over the real experts (the padding
    experts' logits at -1e30), the top-k experts and their renormalised
    gates."""
    E = cfg.padded_experts
    logits = x.float() @ p.router
    if E > cfg.n_experts:
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _dispatch(xg: torch.Tensor, gate_idx: torch.Tensor, E: int, C: int):
    """Each (token, slot) pair's place in its expert's queue, token-major
    (a token reaches an expert at most once, so slot order cannot matter),
    and the kept pairs' rows moved to their (expert, slot); the dropped
    ones go to a spare row.  xg (G, t, d), gate_idx (G, t, k) -> (rows of
    every expert (E, G·C, d), the pairs' experts (G, t·k), their slots
    (G, t·k) clamped into C, keep (G, t·k))."""
    G, t, d = xg.shape
    k = gate_idx.shape[-1]
    idx = gate_idx.reshape(G, t * k)
    chosen = (idx[..., None] == torch.arange(E, device=xg.device)
              ).to(torch.int32)                            # (G, t·k, E)
    pos = (chosen.cumsum(1, dtype=torch.int32) - 1).gather(
        2, idx[..., None])[..., 0]
    keep = pos < C
    pos = pos.clamp(max=C - 1)
    dest = torch.where(keep, idx * C + pos, E * C)
    rows = xg[:, :, None, :].expand(G, t, k, d).reshape(G, t * k, d)
    xin = xg.new_zeros((G, E * C + 1, d)).scatter_(
        1, dest[..., None].expand(-1, -1, d), rows)[:, :E * C]
    xe = xin.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    return xe, idx, pos, keep


def _experts(p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its own rows: xe (E, n, d) -> (E, n, d),
    each product rounded to the input's type."""
    h = torch.bmm(xe, p.w_gate)
    u = torch.bmm(xe, p.w_up)
    return torch.bmm(F.silu(h) * u, p.w_down)


def _combine(out: torch.Tensor, gate_vals: torch.Tensor, idx: torch.Tensor,
             pos: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each kept pair's expert output times its gate (rounded to the
    outputs' type), summed in f32 over the token's slots.  out (E, G·C,
    d) -> (G, t, d) f32."""
    G, t, k = gate_vals.shape
    E, d = out.shape[0], out.shape[-1]
    C = out.shape[1] // G
    g_off = (torch.arange(G, device=out.device) * C)[:, None]
    src = (idx * (G * C) + g_off + pos).reshape(-1)
    picked = out.reshape(E * G * C, d).index_select(0, src).reshape(
        G, t * k, d).float()
    gates = gate_vals.to(out.dtype).reshape(G, t * k, 1).float()
    y = torch.where(keep[..., None], picked * gates, 0.0)
    return y.reshape(G, t, k, d).sum(2)


def _replicas(p: MoE, train: bool) -> Tuple[str, ...]:
    """The data axes (of more than one rank) whose replicas each hold
    their rows of a training step's batch; none outside training or
    without a rank mesh."""
    mesh = p.mesh
    if not train or mesh is None:
        return ()
    return tuple(a for a in data_axes(mesh) if mesh.shape[a] > 1)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig, sp: bool = False,
              train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y (b, s, d), aux ()); with ``sp`` y is the rank's
    block of the sequence; with ``train`` on a rank mesh x is a data
    replica's rows of the global batch (the module docstring).

    Routing: softmax over experts, top-k per token, renormalised gates;
    per group of :func:`group_and_capacity`, each expert takes the first C
    of its (token, slot) pairs in token order and drops the rest.  The
    dispatched rows, each expert product and the combine are in
    ``x.dtype`` (the gates rounded to it), as in the reference."""
    b, s, d = x.shape
    E = cfg.padded_experts
    dp_axes = _replicas(p, train)
    dp = axes_size(p.mesh, dp_axes) if dp_axes else 1
    gsz, C = group_and_capacity(b * dp, s, cfg)
    if (b * s) % gsz:
        raise ValueError(f"{cfg.name}: a routing group of {gsz} tokens "
                         f"spans the rows of {dp} data replicas ({b} x {s} "
                         f"tokens a replica)")
    xg = x.reshape(b * s // gsz, gsz, d)
    probs, gate_vals, gate_idx = _route(p, xg, cfg)      # (G, t, E), (G, t, k)
    # Switch load-balance loss: mean probability x fraction routed (top-1)
    me = probs.mean((0, 1))
    ce = (gate_idx[..., :1] == torch.arange(E, device=x.device)
          ).float().mean((0, 1))
    for a in dp_axes:
        me = CL.sum_over(me, p.mesh, a, backward_sum=True)
        ce = CL.sum_over(ce, p.mesh, a)
    if dp > 1:
        me, ce = me / dp, ce / dp
    aux = cfg.router_aux_weight * E * (me * ce).sum()
    xe, idx, pos, keep = _dispatch(CL.copy_to(xg, p.mesh, MODEL_AXIS),
                                   gate_idx, E, C)
    first, n_e = p.experts
    if n_e < E:
        # this rank's experts only: a pair routed elsewhere adds nothing
        keep = keep & (idx >= first) & (idx < first + n_e)
        idx = (idx - first).clamp(0, n_e - 1)
        xe = xe[first:first + n_e]
    y = _combine(_experts(p, xe), CL.copy_to(gate_vals, p.mesh, MODEL_AXIS),
                 idx, pos, keep)
    if sp:
        y = CL.scatter_dim(y.reshape(b, s, d), p.mesh, MODEL_AXIS,
                           1).to(x.dtype)
    else:
        y = CL.reduce_from(y, p.mesh, MODEL_AXIS).to(x.dtype)
        y = y.reshape(b, s, d)
    if p.shared is not None:
        y = y + p.shared(x, sp)
    return y, aux


def moe_apply_dense_ref(p: MoE, x: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Oracle: run every expert on every token and weight by the
    renormalised top-k gates.  Equals :func:`moe_apply` when no pair is
    dropped."""
    b, s, d = x.shape
    probs, gv, gi = _route(p, x, cfg)
    gates = torch.zeros_like(probs).scatter(-1, gi, gv)   # (b, s, E)
    xe = x.reshape(1, b * s, d).expand(cfg.padded_experts, -1, -1)
    out = _experts(p, xe)                                 # (E, b·s, d)
    y = torch.einsum("te,etd->td", gates.reshape(b * s, -1).to(x.dtype), out)
    y = y.reshape(b, s, d)
    if p.shared is not None:
        y = y + p.shared(x)
    return y
