"""Device meshes — the port's counterpart of the reference package's
``launch/mesh.py``.

A :class:`Mesh` is a grid of devices with named axes: ``("data",
"model")`` for a serving instance, ``("pod", "data", "model")`` for the
reference's multi-pod training mesh.  It holds what the sharding rules
(``sharding/rules.py``) read — ``axis_names`` and ``shape``, a mapping of
axis name to size — with ``size`` and the devices.  Three kinds:

  * abstract: shapes only, no devices — the production meshes (16 x 16
    and 2 x 16 x 16, the reference's TPU v5e pods), for the rules and the
    dry run (``launch/dryrun.py``);
  * one device: runs in this process;
  * the dry run's representative rank (:func:`representative_rank`): an
    abstract mesh's shapes with this process at coordinates (0, ..., 0)
    on the meta device, whose collectives are counted and not run;
  * a rank mesh, made inside a ``torch.distributed`` process group (one
    process a device, ``launch/ranks.py``): each process is one rank,
    knows its coordinates on the axes and holds one process group a
    axis, from PyTorch's ``DeviceMesh``.  The collectives
    (``sharding/collectives.py``) run over those groups, plus one gloo
    group over the whole mesh for the host's own values (the schedulers'
    clock).  The reference runs one controller over every device
    (GSPMD); the port runs one program a rank instead, so every rank of a
    mesh calls the same entry points in the same order.

Under a process group the device count is the world size: a mesh takes
ranks 0 .. n-1 of the group, and every rank of the group makes it (group
creation is collective); a rank outside a mesh smaller than the world
gets one it is not part of (``member`` False).  A rank's device is
``cuda:{local_rank % device_count}``, or the CPU when asked.

Functions, not module-level constants: importing touches no device.  The
reference's ``TPU_XLA_PERF_FLAGS`` are an XLA setting and have no
counterpart here.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


class Mesh:
    """Devices on named axes.  ``devices`` is an object array of
    ``torch.device``s shaped like the axes, or None for an abstract mesh
    (shapes only).  A rank mesh (:func:`make_mesh_for` and the others
    inside a process group) also holds ``ranks`` (the group's rank of
    each device, shaped like the axes), this rank's coordinates
    (``coords``, None on a rank outside the mesh), one process group a
    axis and a gloo group over the whole mesh."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[np.ndarray] = None, *,
                 ranks: Optional[np.ndarray] = None,
                 coords: Optional[Tuple[int, ...]] = None,
                 groups: Optional[Dict[str, object]] = None,
                 host_group=None, backend: Optional[str] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n)
                                      for a, n in zip(axis_names, sizes)}
        self.size = int(np.prod(sizes))
        if devices is not None and devices.shape != tuple(sizes):
            raise ValueError(f"devices {devices.shape} for a mesh of "
                             f"{tuple(sizes)}")
        self.devices = devices
        self.ranks = ranks
        self.coords = None if coords is None else tuple(int(c)
                                                        for c in coords)
        self.groups = groups or {}
        self.host_group = host_group
        self.backend = backend

    @property
    def abstract(self) -> bool:
        return self.devices is None

    @property
    def counting(self) -> bool:
        """True on the dry run's representative rank (its collectives are
        counted, not run)."""
        return self.backend == "count"

    @property
    def distributed(self) -> bool:
        """True for a rank mesh (one process a device)."""
        return self.ranks is not None

    @property
    def member(self) -> bool:
        """False only on a rank outside a rank mesh."""
        return not self.distributed or self.coords is not None

    @property
    def device(self) -> torch.device:
        """The device this process runs the mesh's work on: a one-device
        mesh's device, or this rank's in a rank mesh."""
        if self.distributed and self.coords is not None:
            return self.devices[self.coords]
        if self.devices is None or self.size != 1:
            raise ValueError(f"mesh {self} has no single device")
        return self.devices.reshape(-1)[0]

    def local_device(self, what: str) -> torch.device:
        """The device ``what`` runs on in this process (:attr:`device`).
        Raises ``ValueError`` for an abstract mesh, for a mesh of several
        devices made outside a process group (one process cannot drive
        them: start one rank a device, ``launch.ranks.spawn``) and on a
        rank outside the mesh."""
        if self.devices is None:
            raise ValueError(f"{what}: {self} is abstract (shapes only)")
        if self.distributed and self.coords is None:
            raise ValueError(f"{what}: this rank ({dist.get_rank()}) is "
                             f"not in {self}")
        if not self.distributed and self.size != 1:
            raise ValueError(
                f"{what}: {self} has {self.size} devices but no process "
                f"group: run one rank a device (launch.ranks.spawn) and "
                f"make the mesh there")
        return self.device

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on a one-device mesh)."""
        if self.coords is None:
            if self.shape[axis] == 1:
                return 0
            raise ValueError(f"{self} has no coordinates for this process")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.groups[axis]

    def __repr__(self) -> str:
        if self.devices is None:
            where = "abstract"
        elif self.counting:
            where = f"representative rank {self.coords}"
        elif self.distributed:
            where = (f"{self.devices.reshape(-1)[0].type}, {self.backend}, "
                     f"rank coords {self.coords}")
        else:
            where = str(self.devices.reshape(-1)[0].type)
        return f"Mesh({self.shape}, {where})"


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (the local
    rank from ``LOCAL_RANK``, else the group's rank), or the CPU when
    ``device`` says so."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _rank_mesh(sizes: Tuple[int, ...], names: Tuple[str, ...],
               device) -> Mesh:
    """A mesh over ranks 0 .. n-1 of the process group, its groups from
    PyTorch's ``DeviceMesh`` (collective: every rank of the group calls
    this, in the same order)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    world = dist.get_world_size()
    n = int(np.prod(sizes))
    if n > world:
        raise ValueError(f"a mesh of {n} devices asked for, but only "
                         f"{world} ranks exist in the process group")
    backend = dist.get_backend()
    # the groups' tensors live on the card only under NCCL; gloo moves
    # CUDA tensors through the host, and its groups are the CPU's kind
    kind = "cuda" if backend == "nccl" else "cpu"
    if n == world:
        dm = init_device_mesh(kind, tuple(sizes), mesh_dim_names=names)
    else:
        dm = DeviceMesh(kind, torch.arange(n).reshape(sizes),
                        mesh_dim_names=names)
    coords = dm.get_coordinate()
    groups = ({a: dm.get_group(a) for a in names}
              if coords is not None else {})
    # the host's values (the schedulers' clock, the session's stats) go
    # over a gloo group of the whole mesh: no device tensor, no sync
    if backend == "gloo" and n == world:
        host = dist.group.WORLD
    else:
        host = dist.new_group(list(range(n)), backend="gloo")
    mine = _rank_device(device)
    devs = np.empty(n, dtype=object)
    for r in range(n):
        devs[r] = (mine if mine.type != "cuda" else
                   torch.device("cuda", r % torch.cuda.device_count()))
    return Mesh(sizes, names, devs.reshape(sizes),
                ranks=np.arange(n).reshape(sizes),
                coords=None if coords is None else tuple(coords),
                groups=groups, host_group=host, backend=backend)


def _devices(n: int, device) -> np.ndarray:
    """The first ``n`` devices of ``device``'s type (the GPUs by default;
    the CPU is one device), raising when fewer exist."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        devs = [torch.device("cuda", i) for i in range(have)]
    else:
        devs = [dev]
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices asked for, but only "
                         f"{len(devs)} {dev.type} device(s) exist")
    out = np.empty(n, dtype=object)
    out[:] = devs[:n]
    return out


def make_mesh_for(n_devices: Optional[int] = None,
                  model_parallel: Optional[int] = None,
                  device=None) -> Mesh:
    """Size a ("data", "model") serving mesh to the devices that exist.

      n_devices       total devices to use (default: all of them — the
                      process group's ranks inside one, else the visible
                      CUDA devices, or the one CPU with ``device="cpu"``)
      model_parallel  size of the "model" axis (default: all of them —
                      pure tensor parallelism; must divide n_devices)

    Inside a process group the mesh is a rank mesh over ranks 0 ..
    n_devices-1, each on its own device (``device="cpu"``: the CPU)."""
    group = _in_group()
    if n_devices:
        n = int(n_devices)
    elif group:
        n = dist.get_world_size()
    else:
        n = (torch.cuda.device_count()
             if resolve_device(device).type == "cuda" else 1)
    m = int(model_parallel) if model_parallel else n
    if m <= 0 or n % m != 0:
        raise ValueError(f"model_parallel={m} does not divide n_devices={n}")
    if group:
        return _rank_mesh((n // m, m), ("data", "model"), device)
    return Mesh((n // m, m), ("data", "model"),
                _devices(n, device).reshape(n // m, m))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, abstract: one pod of 16 x 16
    ("data", "model"), or two pods (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def representative_rank(mesh: Mesh) -> Mesh:
    """One rank of the abstract ``mesh`` for the dry run: its shapes, this
    process at coordinates (0, ..., 0), every tensor on the meta device;
    its collectives (``sharding/collectives.py``) are counted by their
    group's size and not run."""
    sizes = tuple(mesh.shape[a] for a in mesh.axis_names)
    devs = np.empty(mesh.size, dtype=object)
    devs[:] = [torch.device("meta")] * mesh.size
    return Mesh(sizes, mesh.axis_names, devs.reshape(sizes),
                ranks=np.arange(mesh.size).reshape(sizes),
                coords=(0,) * len(sizes), backend="count")


def make_mesh(sizes: Sequence[int], axis_names: Sequence[str],
              device=None) -> Mesh:
    """A mesh of any named axes (the reference's ``jax.make_mesh``): a rank
    mesh over ranks 0 .. n-1 inside a process group, else the first n
    devices of ``device``'s type."""
    sizes, names = tuple(int(n) for n in sizes), tuple(axis_names)
    if _in_group():
        return _rank_mesh(sizes, names, device)
    n = int(np.prod(sizes))
    return Mesh(sizes, names, _devices(n, device).reshape(sizes))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device=None) -> Mesh:
    """A small mesh on real devices (raises when fewer exist); a rank
    mesh inside a process group."""
    sizes = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    return make_mesh(sizes, names, device)


def make_slice_mesh(devices: Sequence[torch.device],
                    model_parallel: int) -> Mesh:
    """A mesh over a sub-slice of the devices (one Clover serving
    instance): the given devices become a (1, model_parallel) ("data",
    "model") mesh; inside a process group, a rank mesh of ranks 0 ..
    model_parallel-1 on their own devices, of ``devices``' type."""
    if len(devices) != model_parallel:
        raise ValueError(f"{len(devices)} devices for a (1, "
                         f"{model_parallel}) mesh")
    if _in_group():
        return _rank_mesh((1, model_parallel), ("data", "model"),
                          torch.device(devices[0]).type)
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    return Mesh((1, model_parallel), ("data", "model"),
                devs.reshape(1, model_parallel))
