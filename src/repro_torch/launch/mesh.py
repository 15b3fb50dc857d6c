"""Device meshes — the port's counterpart of the reference package's
``launch/mesh.py``.

A :class:`Mesh` is a grid of devices with named axes: ``("data",
"model")`` for a serving instance, ``("pod", "data", "model")`` for the
reference's multi-pod training mesh.  It holds what the sharding rules
(``sharding/rules.py``) read — ``axis_names`` and ``shape``, a mapping of
axis name to size — with ``size`` and the devices.  The production meshes
(16 x 16 and 2 x 16 x 16, the reference's TPU v5e pods) are abstract:
shapes only, no devices, for the rules and the dry run
(``launch/dryrun.py``), which need nothing more.

Functions, not module-level constants: importing touches no device.  The
reference's ``TPU_XLA_PERF_FLAGS`` are an XLA setting and have no
counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


class Mesh:
    """Devices on named axes.  ``devices`` is an object array of
    ``torch.device``s shaped like the axes, or None for an abstract mesh
    (shapes only)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[np.ndarray] = None):
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

    @property
    def abstract(self) -> bool:
        return self.devices is None

    @property
    def device(self) -> torch.device:
        """The device of a one-device mesh (the only kind that runs)."""
        if self.devices is None or self.size != 1:
            raise ValueError(f"mesh {self} has no single device")
        return self.devices.reshape(-1)[0]

    def single_device(self, what: str) -> torch.device:
        """The device ``what`` runs on: a mesh of one device runs there; a
        mesh of more is refused with ``NotImplementedError`` (executing
        across devices — Megatron column / row pairs with all-reduces, a
        vocab-parallel embedding, expert parallelism, sequence
        parallelism — needs a multi-GPU host and is not ported); an
        abstract mesh has no device."""
        if self.size != 1:
            raise NotImplementedError(
                f"{what}: multi-device execution (a mesh of {self.size} "
                f"devices, {self.shape}) is not ported; a mesh of one "
                f"device runs")
        if self.devices is None:
            raise ValueError(f"{what}: {self} is abstract (shapes only)")
        return self.device

    def __repr__(self) -> str:
        where = "abstract" if self.devices is None else \
            str(self.devices.reshape(-1)[0].type)
        return f"Mesh({self.shape}, {where})"


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

      n_devices       total devices to use (default: all visible ones — the
                      CUDA devices, or the one CPU with ``device="cpu"``)
      model_parallel  size of the "model" axis (default: all of them —
                      pure tensor parallelism; must divide n_devices)
    """
    if n_devices:
        n = int(n_devices)
    else:
        n = (torch.cuda.device_count()
             if resolve_device(device).type == "cuda" else 1)
    m = int(model_parallel) if model_parallel else n
    if m <= 0 or n % m != 0:
        raise ValueError(f"model_parallel={m} does not divide n_devices={n}")
    return Mesh((n // m, m), ("data", "model"),
                _devices(n, device).reshape(n // m, m))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, abstract: one pod of 16 x 16
    ("data", "model"), or two pods (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device=None) -> Mesh:
    """A small mesh on real devices (raises when fewer exist)."""
    sizes = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    n = int(np.prod(sizes))
    return Mesh(sizes, names, _devices(n, device).reshape(sizes))


def make_slice_mesh(devices: Sequence[torch.device],
                    model_parallel: int) -> Mesh:
    """A mesh over a sub-slice of the devices (one Clover serving
    instance): the given devices become a (1, model_parallel) ("data",
    "model") mesh."""
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    return Mesh((1, model_parallel), ("data", "model"),
                devs.reshape(1, model_parallel))
