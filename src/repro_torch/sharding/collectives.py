"""Collectives over a rank mesh's axes — the explicit ``torch.distributed``
calls of tensor and data parallelism, which the reference leaves to
GSPMD.

The device collectives take the mesh (``launch/mesh.py``) and an axis
name and do nothing on an axis of one device, or without a mesh, so the
unsharded paths run the same code.  ``all_gather`` is an ``all_reduce``
sum of zero-filled slots, one a rank, each rank writing its own: exact
(a value plus zeros), and it runs on CUDA tensors over gloo, which has
no CUDA all-gather (two ranks sharing one card run over gloo); a
reduce-scatter is an all-reduce followed by the rank's slice, for the
same reason.  The host's own values (the schedulers' clock, the
session's stats) are broadcast from rank 0 over the mesh's gloo group,
as CPU tensors and objects.

Training's collectives carry gradients: Megatron's conjugate pair
(:func:`copy_to`: identity forward, all-reduce backward, before a
column-parallel product; :func:`reduce_from`: all-reduce forward,
identity backward, after a row-parallel one), :func:`sum_over` (an
all-reduce whose backward is the identity or another all-reduce), and
the sequence-parallel moves along a dimension (:func:`gather_dim`,
:func:`scatter_dim`, :func:`split_dim`).  Each is a
``torch.autograd.Function`` over this module's own calls, so every
launch is counted; without a mesh, on an axis of one device, or outside
a recorded graph it is the plain collective (or nothing), so the
one-device path dispatches no operation more.

The dry run's representative rank (``launch/mesh.py``
``representative_rank``: an abstract mesh with coordinates, its
tensors on the meta device) runs the same calls: they are counted and
not executed, and return tensors of the right shape.

Each call counts its calls, the bytes it hands to the backend and its
wire bytes into :func:`stats`, by kind; :func:`reset` zeroes them.  The
wire bytes follow the reference's formulas
(``src/repro/launch/hlo_analysis.py``), g being the axis group's size:
all-gather ``out x (g-1)/g``, all-reduce ``2 x in x (g-1)/g``,
reduce-scatter ``in x (g-1)/g``; a broadcast counts its bytes once.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")
_COUNTS: Dict[str, List[float]] = {k: [0, 0, 0.0] for k in _KINDS}


def stats() -> Dict[str, Dict[str, float]]:
    """Calls, bytes and wire bytes of each kind since :func:`reset`."""
    return {k: {"calls": c, "bytes": b, "wire_bytes": w}
            for k, (c, b, w) in _COUNTS.items()}


def totals() -> Dict[str, float]:
    """Calls, bytes and wire bytes of all kinds together."""
    return {"calls": sum(v[0] for v in _COUNTS.values()),
            "bytes": sum(v[1] for v in _COUNTS.values()),
            "wire_bytes": sum(v[2] for v in _COUNTS.values())}


def reset() -> None:
    for v in _COUNTS.values():
        v[0] = v[1] = 0
        v[2] = 0.0


_WIRE = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0}


def _count(kind: str, t: torch.Tensor, g: int = 2) -> None:
    n = t.numel() * t.element_size()
    _COUNTS[kind][0] += 1
    _COUNTS[kind][1] += n
    _COUNTS[kind][2] += (n if kind == "broadcast"
                         else _WIRE[kind] * n * (g - 1) / g)


def _active(mesh, axis: str) -> bool:
    return mesh is not None and mesh.shape.get(axis, 1) > 1


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum",
               kind: str = "all_reduce") -> torch.Tensor:
    """The sum (or ``op="max"``) of ``x`` over ``axis``'s ranks, in place;
    returns ``x``.  ``kind`` is what the call stands for in the counts
    (a reduce-scatter or an all-gather written as an all-reduce)."""
    if _active(mesh, axis):
        _count(kind, x, mesh.shape[axis])
        if not mesh.counting:
            dist.all_reduce(x, op=(dist.ReduceOp.MAX if op == "max"
                                   else dist.ReduceOp.SUM),
                            group=mesh.group(axis))
    return x


def all_reduce_axes(x: torch.Tensor, mesh, axes: Sequence[str]
                    ) -> torch.Tensor:
    """:func:`all_reduce` over each of ``axes`` in turn (the sum over
    their product), in place."""
    for a in axes:
        all_reduce(x, mesh, a)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` of every rank on ``axis``, stacked in coordinate order: (n,
    *x.shape).  An all-reduce of zero-filled slots, exact."""
    if not _active(mesh, axis):
        return x[None]
    n = mesh.shape[axis]
    out = x.new_zeros((n,) + tuple(x.shape))
    _count("all_gather", out, n)
    if mesh.counting:
        return out
    out[mesh.coord(axis)] = x
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``'s leading dim concatenated over ``axis``'s ranks in coordinate
    order (each rank holds an equal block of the rows)."""
    if not _active(mesh, axis):
        return x
    return all_gather(x, mesh, axis).flatten(0, 1)


def _gather_cat(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``x`` of every rank on ``axis`` concatenated along ``dim`` in
    coordinate order."""
    return torch.cat(all_gather(x, mesh, axis).unbind(0), dim)


def _reduce_slice(x: torch.Tensor, mesh, axis: str, dim: int
                  ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks, this rank's equal block of
    ``dim`` (a reduce-scatter: an all-reduce, then the slice)."""
    n = mesh.shape[axis]
    out = x.contiguous().clone()
    _count("reduce_scatter", out, n)
    if not mesh.counting:
        dist.all_reduce(out, group=mesh.group(axis))
    return _slice(out, mesh, axis, dim).clone()


def _slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    per = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axis) * per, per)


# =============================================================================
# collectives that carry gradients
# =============================================================================
def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


class _SumOver(torch.autograd.Function):
    """All-reduce forward; backward the identity (the result feeds
    replicated work: Megatron's g) or another all-reduce (it feeds each
    rank's own slice of the work)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, backward_sum):
        ctx.mesh, ctx.axis, ctx.sum = mesh, axis, backward_sum
        return all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum:
            g = all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis)
        return g, None, None, None


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward, the rank's slice backward (the
    gathered tensor feeds replicated work, or cut work whose own
    ``copy_to`` sums its gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_cat(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterDim(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_slice(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), \
            None, None, None


class _SplitDim(torch.autograd.Function):
    """The rank's slice along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _slice(x, mesh, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), \
            None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is; in a recorded graph its gradient is summed over
    ``axis`` (the input of column-parallel products)."""
    if _active(mesh, axis) and _recorded(x):
        return _CopyTo.apply(x, mesh, axis)
    return x


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (the partial sums of a
    row-parallel product); its gradient passes through.  Outside a
    recorded graph the sum is taken in place."""
    return sum_over(x, mesh, axis)


def sum_over(x: torch.Tensor, mesh, axis: str,
             backward_sum: bool = False) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; in a recorded graph its gradient
    passes through, or with ``backward_sum`` is summed over ``axis`` as
    well.  Outside a recorded graph the sum is taken in place."""
    if not _active(mesh, axis):
        return x
    if _recorded(x):
        return _SumOver.apply(x, mesh, axis, backward_sum)
    return all_reduce(x, mesh, axis)


def max_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The maximum of ``x`` over ``axis`` (no gradient), exact."""
    if not _active(mesh, axis):
        return x
    return all_reduce(x.detach().clone(), mesh, axis, op="max")


def gather_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` on ``axis`` concatenated along ``dim``; its
    gradient is the rank's slice."""
    if not _active(mesh, axis):
        return x
    if _recorded(x):
        return _GatherDim.apply(x, mesh, axis, dim)
    return _gather_cat(x, mesh, axis, dim)


def scatter_dim(x: torch.Tensor, mesh, axis: str, dim: int
                ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, this rank's block of ``dim`` (a
    reduce-scatter); its gradient is all-gathered."""
    if not _active(mesh, axis):
        return x
    if _recorded(x):
        return _ScatterDim.apply(x, mesh, axis, dim)
    return _reduce_slice(x, mesh, axis, dim)


def split_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated ``x``; its gradient
    is all-gathered."""
    if not _active(mesh, axis):
        return x
    if _recorded(x):
        return _SplitDim.apply(x, mesh, axis, dim)
    return _slice(x, mesh, axis, dim)


# =============================================================================
# the host's values
# =============================================================================
def _host_mesh(mesh) -> bool:
    return (mesh is not None and mesh.distributed and mesh.size > 1
            and not mesh.counting)


def broadcast_host(value: float, mesh) -> float:
    """Rank 0's ``value`` (a host float) on every rank of the mesh, over
    its gloo group; ``value`` itself without a rank mesh."""
    if not _host_mesh(mesh):
        return value
    t = torch.tensor([value], dtype=torch.float64)
    _count("broadcast", t)
    dist.broadcast(t, group=mesh.host_group, src=int(mesh.ranks.flat[0]))
    return float(t[0])


def broadcast_object(obj, mesh):
    """Rank 0's picklable ``obj`` on every rank of the mesh (its gloo
    group); ``obj`` itself without a rank mesh."""
    if not _host_mesh(mesh):
        return obj
    box = [obj]
    _COUNTS["broadcast"][0] += 1
    dist.broadcast_object_list(box, group=mesh.host_group,
                               src=int(mesh.ranks.flat[0]))
    return box[0]


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (its gloo group)."""
    if _host_mesh(mesh):
        dist.barrier(group=mesh.host_group)
