"""Collectives over a rank mesh's axes — the explicit ``torch.distributed``
calls of tensor and data parallelism, which the reference leaves to
GSPMD.

The device collectives take the mesh (``launch/mesh.py``) and an axis
name and do nothing on an axis of one device, or without a mesh, so the
unsharded paths run the same code.  ``all_gather`` is an ``all_reduce``
sum of zero-filled slots, one a rank, each rank writing its own: exact
(a value plus zeros), and it runs on CUDA tensors over gloo, which has
no CUDA all-gather (two ranks sharing one card run over gloo).  The
host's own values (the schedulers' clock, the session's stats) are
broadcast from rank 0 over the mesh's gloo group, as CPU tensors and
objects.

Each call counts its calls and the bytes it hands to the backend into
:func:`stats`, by kind; :func:`reset` zeroes them.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

_KINDS = ("all_reduce", "all_gather", "broadcast")
_COUNTS: Dict[str, List[int]] = {k: [0, 0] for k in _KINDS}


def stats() -> Dict[str, Dict[str, int]]:
    """Calls and bytes of each kind of collective since :func:`reset`."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in _COUNTS.items()}


def totals() -> Dict[str, int]:
    """Calls and bytes of all kinds together."""
    return {"calls": sum(c for c, _ in _COUNTS.values()),
            "bytes": sum(b for _, b in _COUNTS.values())}


def reset() -> None:
    for v in _COUNTS.values():
        v[0] = v[1] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    _COUNTS[kind][0] += 1
    _COUNTS[kind][1] += t.numel() * t.element_size()


def _active(mesh, axis: str) -> bool:
    return mesh is not None and mesh.shape.get(axis, 1) > 1


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks, in place; returns ``x``."""
    if _active(mesh, axis):
        _count("all_reduce", x)
        dist.all_reduce(x, group=mesh.group(axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` of every rank on ``axis``, stacked in coordinate order: (n,
    *x.shape).  An all-reduce of zero-filled slots, exact."""
    if not _active(mesh, axis):
        return x[None]
    out = x.new_zeros((mesh.shape[axis],) + tuple(x.shape))
    out[mesh.coord(axis)] = x
    _count("all_gather", out)
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``'s leading dim concatenated over ``axis``'s ranks in coordinate
    order (each rank holds an equal block of the rows)."""
    if not _active(mesh, axis):
        return x
    return all_gather(x, mesh, axis).flatten(0, 1)


def broadcast_host(value: float, mesh) -> float:
    """Rank 0's ``value`` (a host float) on every rank of the mesh, over
    its gloo group; ``value`` itself without a rank mesh."""
    if mesh is None or not mesh.distributed or mesh.size == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    _count("broadcast", t)
    dist.broadcast(t, group=mesh.host_group, src=int(mesh.ranks.flat[0]))
    return float(t[0])


def broadcast_object(obj, mesh):
    """Rank 0's picklable ``obj`` on every rank of the mesh (its gloo
    group); ``obj`` itself without a rank mesh."""
    if mesh is None or not mesh.distributed or mesh.size == 1:
        return obj
    box = [obj]
    _COUNTS["broadcast"][0] += 1
    dist.broadcast_object_list(box, group=mesh.host_group,
                               src=int(mesh.ranks.flat[0]))
    return box[0]
