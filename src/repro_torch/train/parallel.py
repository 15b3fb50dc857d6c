"""Training on a rank mesh — what the reference's ``build_train`` leaves
to GSPMD, written out for one process a device (``launch/ranks.py``).

A rank holds its shard of the model (``models/registry.py``
``shard_params``; every family) and of the optimizer state.  A
:class:`Plan` says, for each of the rank's parameters, how its gradient
is reduced and where its AdamW moments live:

  * the rows of the global batch are cut over the data axes ("pod",
    "data"); each data replica's gradients are summed over them and
    divided by their size;
  * a replicated parameter that the rank applies to activations cut over
    "model" (``registry.partial_grads``) has its gradient summed over
    "model" first; the others need nothing (Megatron's conjugate pairs
    in the model already sum the activations' gradients);
  * the global norm for clipping sums the squares of the gradients cut
    over "model" across it and counts the replicated ones once;
  * ZeRO-1 (``rules.opt_state_specs``): a moment cut over the data axes
    lives on the rank that owns its slice — a block of one dimension of
    the rank's parameter shard, or, where the reference cuts a stack's
    layer axis, the whole of layer i's tensor on the data shard that
    holds index i.  The gradient's data sum is then a reduce-scatter (an
    all-reduce and the rank's slice: gloo has no reduce-scatter), each
    rank updates the slice it owns, and the new slices are all-gathered
    over the data axes (an all-reduce of zero-filled shards, exact).

Each parameter has its own collectives: one flat bucket of a step's
gradients (and one of its weights) made a (2, 2) mesh's qwen3-1.7b step
slower through gloo on an H100 (13.2 s against 9.9-10.2 s).

The AdamW arithmetic is ``train/optimizer.py``'s, element for element,
so ZeRO-1 changes no parameter.  :meth:`Plan.whole` and
:meth:`Plan.local` move a parameter or a moment between the rank's part
and the whole tensor (GSPMD's shard padding dropped), for the
checkpoints (``train/checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.rules import MODEL_AXIS

Grads = Mapping[str, torch.Tensor]


def rank_mesh(model) -> Optional[object]:
    """The rank mesh of a rank's shard (a rank mesh or the dry run's
    representative rank), else None."""
    mesh = getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.distributed else None


@dataclasses.dataclass(frozen=True)
class Zero:
    """Where one parameter's moments live on this rank: ``dim`` None and
    ``layer`` False — the whole shard; ``dim`` — the block ``lo .. lo +
    n - 1`` of that dimension; ``layer`` — the whole shard on the data
    shard that owns the layer (``owner``), nothing elsewhere."""
    dim: Optional[int] = None
    lo: int = 0
    n: int = 0
    layer: bool = False
    owner: bool = True

    @property
    def cut(self) -> bool:
        return self.dim is not None or self.layer

    def take(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """This rank's part of a shard-shaped ``t`` (None: it owns none)."""
        if self.dim is not None:
            return t.narrow(self.dim, self.lo, self.n)
        return t if self.owner else None


class Plan:
    """The reduction and ZeRO-1 layout of a rank's shard ``model`` on its
    rank mesh (see the module docstring); ``zero1`` cuts the moments over
    the data axes."""

    def __init__(self, model, zero1: bool):
        from repro_torch.models import registry as R
        self.mesh = mesh = model.mesh
        self.zero1 = zero1
        cfg = model.cfg
        whole = R.init_params(cfg, device="meta")
        p_specs = rules.param_specs(whole, cfg, mesh)
        o_specs = (rules.opt_state_specs(whole, cfg, mesh) if zero1
                   else p_specs)
        self.dp_axes = tuple(a for a in rules.data_axes(mesh)
                             if mesh.shape[a] > 1)
        self.dp = rules.axes_size(mesh, self.dp_axes) if self.dp_axes else 1
        self.block = rules.block_index(mesh, self.dp_axes)
        self.partial = frozenset(R.partial_grads(model))
        shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
        local = dict(model.named_parameters())
        self.spec: Dict[str, rules.Spec] = {}
        self.shape: Dict[str, Tuple[int, ...]] = {}
        self.zero: Dict[str, Zero] = {}
        for _, names, _, stacked, _ in rules._reference_leaves(whole):
            for i, name in enumerate(names):
                ps, os_ = p_specs[name], o_specs[name]
                if stacked:
                    ps, (lay, os_) = ps[1:], (os_[0], os_[1:])
                else:
                    lay = None
                self.spec[name], self.shape[name] = ps, shapes[name]
                self.zero[name] = self._zero(local[name], ps, os_, lay, i,
                                             len(names))
        # the parameters cut over "model": their squares are summed over it
        self.cut_model = {n: MODEL_AXIS in sum(map(rules.axes_of, sp), ())
                          for n, sp in self.spec.items()}

    def _zero(self, p, ps, os_, lay, i: int, n_layers: int) -> Zero:
        if lay:
            per = n_layers // self.dp
            return Zero(layer=True, owner=i // per == self.block)
        for d, (a, b) in enumerate(zip(ps, os_)):
            if a != b:
                n = p.shape[d] // self.dp
                return Zero(dim=d, lo=self.block * n, n=n)
        return Zero()

    # --------------------------------------------------------------- rows
    def rows(self, batch: dict) -> dict:
        """This data replica's rows of the global batch."""
        from repro_torch.train.train_loop import _split_rows
        if self.dp == 1:
            return batch
        return _split_rows(batch, self.dp, self.block)

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data replicas of a per-replica value."""
        if self.dp == 1:
            return t
        return C.all_reduce_axes(t.clone(), self.mesh,
                                 self.dp_axes) / self.dp

    # --------------------------------------------------------- gradients
    def reduce_grads(self, grads: Grads) -> Dict[str, torch.Tensor]:
        """Each gradient in f32, summed over "model" where it is a part
        (``partial``), then the mean over the data axes: a reduce-scatter
        for a ZeRO-1-cut one (:meth:`update` takes its slice), else an
        all-reduce.  In the dict's order, the same on every rank (a
        set's order is not: collectives issued in two orders pair the
        wrong tensors)."""
        out = {}
        for name, g in grads.items():
            g = g.float().contiguous().clone()
            if name in self.partial:
                C.all_reduce(g, self.mesh, MODEL_AXIS)
            if self.dp > 1:
                kind = ("reduce_scatter" if self.zero[name].cut
                        else "all_reduce")
                for a in self.dp_axes:
                    C.all_reduce(g, self.mesh, a, kind=kind)
                g = g / self.dp
            out[name] = g
        return out

    def global_norm(self, grads: Grads) -> torch.Tensor:
        """The norm of the whole gradient: the squares of the shards cut
        over "model" summed across it, the replicated ones counted
        once."""
        cut = self.cut_model
        dev = next(iter(grads.values())).device
        sq = {True: torch.zeros((), dtype=torch.float32, device=dev),
              False: torch.zeros((), dtype=torch.float32, device=dev)}
        for name, g in grads.items():
            sq[cut[name]] = sq[cut[name]] + g.float().square().sum()
        total = C.all_reduce(sq[True], self.mesh, MODEL_AXIS) + sq[False]
        return torch.sqrt(total)

    # ------------------------------------------------------------ update
    def init_moment(self, p: torch.Tensor, name: str) -> torch.Tensor:
        part = self.zero[name].take(p)
        if part is None:
            return torch.zeros((0,), dtype=torch.float32, device=p.device)
        return torch.zeros(part.shape, dtype=torch.float32, device=p.device)

    def update(self, name: str, p: torch.Tensor, g: torch.Tensor, m, v,
               leaf) -> Tuple[torch.Tensor, torch.Tensor]:
        """One parameter's AdamW step on the slice this rank owns
        (``leaf(p, g, m, v) -> (new p, m, v)``, ``optimizer._leaf``), the
        new slices all-gathered over the data axes; p is updated in
        place.  Returns the new moments."""
        z = self.zero[name]
        part = z.take(p)
        if part is not None:
            new, m, v = leaf(part, z.take(g), m, v)
        if not z.cut:
            p.copy_(new)
            return m, v
        p.zero_()
        if part is not None:
            z.take(p).copy_(new)
        for a in self.dp_axes:
            C.all_reduce(p, self.mesh, a, kind="all_gather")
        return m, v

    # ------------------------------------------------------- checkpoints
    def whole(self, name: str, t: torch.Tensor,
              moment: bool = False) -> torch.Tensor:
        """The whole tensor of the rank's part ``t`` of parameter ``name``
        (or of one of its moments), gathered over the mesh, GSPMD's
        padding dropped.  Collective: every rank calls it."""
        if moment and self.zero[name].cut:
            z = self.zero[name]
            shard = rules.shard_shape(self.shape[name], self.spec[name],
                                      self.mesh)
            buf = torch.zeros(shard, dtype=t.dtype, device=t.device)
            if z.take(buf) is not None:
                z.take(buf).copy_(t)
            t = C.all_reduce_axes(buf, self.mesh, self.dp_axes)
        for d, ax in enumerate(self.spec[name]):
            for a in reversed(rules.axes_of(ax)):
                t = torch.cat(C.all_gather(t.contiguous(), self.mesh,
                                           a).unbind(0), d)
            t = t.narrow(d, 0, self.shape[name][d])
        return t

    def local(self, name: str, whole: torch.Tensor,
              moment: bool = False) -> torch.Tensor:
        """This rank's part of the whole tensor of parameter ``name`` (or
        of a moment: its ZeRO-1 slice, empty on a rank that owns none)."""
        t = rules.local_shard(whole, self.spec[name], self.mesh)
        if moment:
            part = self.zero[name].take(t)
            if part is None:
                return whole.new_zeros((0,))
            t = part
        return t


def plan_for(model, zero1: bool) -> Plan:
    """The model's :class:`Plan`, made once a model and ``zero1``."""
    plans = model.__dict__.setdefault("_train_plans", {})
    if zero1 not in plans:
        plans[zero1] = Plan(model, zero1)
    return plans[zero1]


def plan_of(state: dict) -> Optional[Plan]:
    """The :class:`Plan` of a train state whose model is a rank's shard
    (its moments ZeRO-1 slices when the state says ``"zero1"``), else
    None."""
    model = state["params"]
    if rank_mesh(model) is None:
        return None
    return plan_for(model, state["opt"].get("zero1", False))


def init_opt_state(model, zero1: bool) -> dict:
    """Zero f32 moments of a rank's shard — each parameter's shard, or
    with ``zero1`` the slice the rank owns — step 0, and ``"zero1"``."""
    plan = plan_for(model, zero1)
    named = dict(model.named_parameters())
    m = {n: plan.init_moment(p, n) for n, p in named.items()}
    dev = next(iter(named.values())).device
    return {"m": m, "v": {n: t.clone() for n, t in m.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "zero1": zero1}
