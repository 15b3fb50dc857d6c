"""Weights across the two packages.

The reference keeps parameters as a pytree with every layer's leaves
stacked on a leading L axis; its checkpoints flatten that tree into a
numpy dict keyed by "/"-joined paths (``train/checkpoint.py``'s
``_flatten``: ``embed/table``, ``final_norm/scale``,
``layers/attn/wq/w`` of shape (L, d, H·dh), ...; for the SSM families
``layers/ln/scale``, ``layers/mamba/wz/w``, ``layers/mamba/conv_x`` (L, k,
d_inner), ``layers/mamba/A_log`` (L, H), ..., and for the hybrid the
unstacked ``shared/...`` block; an MoE layer has ``layers/moe/router`` (L,
d, E) and ``layers/moe/w_gate`` / ``w_up`` (L, E, d, F) / ``w_down`` (L,
E, F, d) as plain arrays, and its shared experts' dense weights under
``layers/moe/shared/...``).  An enc-dec model has two stacks in place of
``layers/...``: ``enc_layers/{ln1,attn,ln2,mlp}/...`` and
``dec_layers/{ln1,attn,lnx,xattn,ln2,mlp}/...``, and ``enc_norm/scale``
beside the top leaves.  :func:`load_reference` splits the stacked leaves
along axis 0 into the port's per-layer modules (dense weights transposed
to PyTorch's (out, in); conv kernels stay (k, channels), expert weights as
they are), and :func:`export_reference` is its exact inverse, so weights
round-trip.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

Arrays = Dict[str, np.ndarray]

# (norms, dense weights, plain arrays) of a decoder layer (dense or MoE)
# or the hybrid's shared block, and of a Mamba2 layer
_ATTN_MLP = (("ln1", "ln2", "attn/q_norm", "attn/k_norm"),
             ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi_gate",
              "mlp/wi_up", "mlp/wo"), ())
_ATTN_MOE = (_ATTN_MLP[0],
             _ATTN_MLP[1][:4] + ("moe/shared/wi_gate", "moe/shared/wi_up",
                                 "moe/shared/wo"),
             ("moe/router", "moe/w_gate", "moe/w_up", "moe/w_down"))
_MAMBA = (("ln", "mamba/gate_norm"),
          ("mamba/wz", "mamba/wx", "mamba/wB", "mamba/wC", "mamba/wdt",
           "mamba/out_proj"),
          ("mamba/conv_x", "mamba/conv_B", "mamba/conv_C", "mamba/conv_bx",
           "mamba/conv_bB", "mamba/conv_bC", "mamba/A_log", "mamba/D",
           "mamba/dt_bias"))
# an enc-dec decoder layer: the self- and the cross-attention, then the MLP
_CROSS = (("ln1", "lnx", "ln2", "attn/q_norm", "attn/k_norm",
           "xattn/q_norm", "xattn/k_norm"),
          _ATTN_MLP[1][:4] + ("xattn/wq", "xattn/wk", "xattn/wv",
                              "xattn/wo") + _ATTN_MLP[1][4:], ())


def _leaves(mod, spec) -> Iterator[Tuple[str, str, bool]]:
    """(reference path, port attribute path, is a dense weight) for every
    leaf of ``mod`` named in ``spec``."""
    norms, denses, arrays = spec
    for name in norms:
        attr = name.replace("/", ".")
        if _get(mod, attr) is not None:
            yield f"{name}/scale", f"{attr}.scale", False
    for name in denses:
        attr = name.replace("/", ".")
        lin = _get(mod, attr)
        if lin is None:
            continue
        yield f"{name}/w", f"{attr}.weight", True
        if lin.bias is not None:
            yield f"{name}/b", f"{attr}.bias", False
    for name in arrays:
        yield name, name.replace("/", "."), False


def _stacks(model: Union[LM, EncDec]
            ) -> Iterator[Tuple[str, nn.ModuleList,
                                Tuple[Tuple[str, str, bool], ...]]]:
    """(the reference's prefix, the port's layers, the leaves of one
    layer) of every stack of layers: ``layers`` (decoder-only), or
    ``enc_layers`` and ``dec_layers`` (enc-dec)."""
    cfg = model.cfg
    if isinstance(model, EncDec):
        yield ("enc_layers", model.enc_layers,
               tuple(_leaves(model.enc_layers[0], _ATTN_MLP)))
        yield ("dec_layers", model.dec_layers,
               tuple(_leaves(model.dec_layers[0], _CROSS)))
        return
    if cfg.family in ("ssm", "hybrid"):
        spec = _MAMBA
    else:
        spec = _ATTN_MOE if cfg.is_moe else _ATTN_MLP
    yield "layers", model.layers, tuple(_leaves(model.layers[0], spec))


def _get(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
        if obj is None:
            return None
    return obj


def _top_leaves(model: Union[LM, EncDec]
                ) -> Iterator[Tuple[str, str, bool]]:
    yield "embed/table", "embed", False
    if isinstance(model, EncDec):
        yield "enc_norm/scale", "enc_norm.scale", False
    yield "final_norm/scale", "final_norm.scale", False
    if model.lm_head is not None:
        yield "lm_head/w", "lm_head.weight", True
    if getattr(model, "shared", None) is not None:
        for key, attr, dense in _leaves(model.shared, _ATTN_MLP):
            yield f"shared/{key}", f"shared.{attr}", dense


@torch.no_grad()
def load_reference(model: Union[LM, EncDec],
                   arrays: Arrays) -> Union[LM, EncDec]:
    """Copy the reference's flattened params into ``model`` (its device and
    dtype).  Every leaf of the model must be present with the reference's
    shape; extra keys are an error too."""
    used = set()

    def put(key: str, attr_owner, attr: str, dense: bool, value) -> None:
        dst = _get(attr_owner, attr)
        value = np.asarray(value)
        if value.dtype.name == "bfloat16":       # ml_dtypes: torch can't read
            value = value.astype(np.float32)
        src = torch.tensor(value)
        if dense:
            src = src.T
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: reference shape {tuple(src.shape)} "
                             f"!= port shape {tuple(dst.shape)}")
        dst.copy_(src.to(dtype=dst.dtype, device=dst.device))
        used.add(key)

    for key, attr, dense in _top_leaves(model):
        put(key, model, attr, dense, arrays[key])
    for prefix, layers, leaves in _stacks(model):
        for key, attr, dense in leaves:
            stacked = arrays[f"{prefix}/{key}"]
            if stacked.shape[0] != len(layers):
                raise ValueError(f"{prefix}/{key}: {stacked.shape[0]} "
                                 f"layers in the reference, {len(layers)} "
                                 f"here")
            for i, layer in enumerate(layers):
                put(f"{prefix}/{key}", layer, attr, dense, stacked[i])
    extra = set(arrays) - used
    if extra:
        raise ValueError(f"reference leaves the port has no place for: "
                         f"{sorted(extra)}")
    return model


@torch.no_grad()
def export_reference(model: Union[LM, EncDec]) -> Arrays:
    """The inverse of :func:`load_reference`: the model's weights as the
    reference's flattened params (stacked layers, (in, out) dense
    weights), in their own dtype on the host."""
    def host(t: torch.Tensor, dense: bool) -> np.ndarray:
        t = t.T if dense else t
        return t.detach().float().cpu().numpy().astype(
            _np_dtype(t.dtype))

    out: Arrays = {}
    for key, attr, dense in _top_leaves(model):
        out[key] = host(_get(model, attr), dense)
    for prefix, layers, leaves in _stacks(model):
        for key, attr, dense in leaves:
            out[f"{prefix}/{key}"] = np.stack(
                [host(_get(layer, attr), dense) for layer in layers])
    return out


def _np_dtype(dtype: torch.dtype):
    """numpy dtype for a torch dtype; bf16 (which numpy lacks) goes out as
    f32, which holds it exactly."""
    if dtype == torch.bfloat16:
        return np.float32
    return torch.empty((), dtype=dtype).numpy().dtype
