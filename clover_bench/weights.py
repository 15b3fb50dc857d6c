"""Seeded weights, made on the device in a few large calls, and handed
the same tensors to the port and to the plain reference.

One flat buffer per ladder rung, in the type the weights are served in,
filled by ``normal_`` from one ``torch.Generator`` on the device in chunks
of at most 2**30 elements; each weight is a view of it, scaled to the
init's spread.  Which weights a model has, and the port's names for them,
come from its family's file (``families/<family>.py``, named by the
config's ``model.family``): the reference reads the benchmark's names
directly, and :func:`bind` puts the same tensors into the port's module
tree (built on the meta device, so the port allocates nothing).
"""
from __future__ import annotations

import importlib.util
import pathlib
from typing import Dict

import torch

HERE = pathlib.Path(__file__).resolve().parent
CHUNK = 1 << 30


def family(name: str):
    """``families/<name>.py``, loaded by path."""
    path = HERE / "families" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_family_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(shape: Dict, n_layers: int, vocab_rows: int,
         gen: torch.Generator, dtype: torch.dtype, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """The weights of one rung: views of one flat buffer drawn by
    ``gen``."""
    spec = family(shape["family"]).leaves(shape, n_layers, vocab_rows)
    total = sum(int(torch.Size(s).numel()) for _, s, _, _ in spec)
    flat = torch.empty((total,), dtype=dtype, device=device)
    for c0 in range(0, total, CHUNK):
        flat[c0:c0 + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    with torch.no_grad():
        for name, s, mean, spread in spec:
            n = int(torch.Size(s).numel())
            t = flat[off:off + n].view(s)
            off += n
            t.mul_(spread)
            if mean:
                t.add_(mean)
            out[name] = t
    return out


def bind(model: torch.nn.Module, w: Dict[str, torch.Tensor], n_layers: int,
         shape: Dict) -> torch.nn.Module:
    """Put the weights into the port's model (built on the meta device):
    every parameter becomes the benchmark's tensor itself, no copy."""
    state = family(shape["family"]).port_state(w, n_layers, shape)
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(False)
