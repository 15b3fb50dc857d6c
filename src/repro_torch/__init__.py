"""PyTorch/CUDA port of the Clover serving system.

The JAX package ``src/repro`` is the reference this package is held
against; the port imports nothing of it.  Module names mirror the
reference's (``models/layers.py`` ↔ ``models/layers.py`` and so on).  The
Pallas TPU kernels on the ported path have hand-written CUDA C++ kernels for
Hopper here (``kernels/``), each beside its plain PyTorch version.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no GPU present and no device given they raise instead of moving quietly to
the CPU (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  Raises when neither exists — the CPU path is only
    taken on request."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
