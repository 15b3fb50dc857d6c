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
round-trip.  Both go through :func:`leaf_map` (:func:`to_reference`,
:func:`from_reference`), which maps any tensors keyed by the model's
parameter names — the training state's gradients and Adam moments too —
and gives the reference's weight-decay mask (:func:`decay_mask`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple, Union

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


def leaf_map(model: Union[LM, EncDec]
             ) -> List[Tuple[str, Tuple[str, ...], bool, bool]]:
    """Every leaf of the reference's flattened params with its place in
    the port: (reference key, the port's parameter names — one per layer,
    in order, for a stacked leaf —, is a dense weight (transposed between
    the two), is stacked).  The names are ``model.named_parameters()``'s,
    so any per-parameter tensors (weights, gradients, Adam's moments) go
    through the same map (:func:`to_reference`, :func:`from_reference`)."""
    out = [(key, (attr,), dense, False)
           for key, attr, dense in _top_leaves(model)]
    for prefix, layers, leaves in _stacks(model):
        for key, attr, dense in leaves:
            out.append((f"{prefix}/{key}",
                        tuple(f"{prefix}.{i}.{attr}"
                              for i in range(len(layers))), dense, True))
    return out


def to_reference(model: Union[LM, EncDec],
                 tensors: Mapping[str, torch.Tensor]) -> Arrays:
    """Per-parameter tensors keyed by ``model``'s parameter names (every
    one present) -> the reference's flattened layout: stacked layers on a
    leading axis, dense weights (in, out), on the host in their own dtype
    (bf16 as f32, which holds it exactly)."""
    def host(t: torch.Tensor, dense: bool) -> np.ndarray:
        t = t.detach()
        t = t.T if dense else t
        return t.float().cpu().numpy().astype(_np_dtype(t.dtype))

    out: Arrays = {}
    for key, names, dense, stacked in leaf_map(model):
        parts = [host(tensors[n], dense) for n in names]
        out[key] = np.stack(parts) if stacked else parts[0]
    return out


def from_reference(model: Union[LM, EncDec], arrays: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`to_reference`: the reference's flattened
    arrays -> CPU tensors keyed by ``model``'s parameter names, each of
    its parameter's shape, in the arrays' dtype (bf16 as f32).  Every leaf
    must be present with the reference's shape; extra keys are an error
    too."""
    params = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    for key, names, dense, stacked in leaf_map(model):
        value = np.asarray(arrays[key])
        if value.dtype.name == "bfloat16":       # ml_dtypes: torch can't read
            value = value.astype(np.float32)
        if stacked and value.shape[0] != len(names):
            raise ValueError(f"{key}: {value.shape[0]} layers in the "
                             f"reference, {len(names)} here")
        for i, name in enumerate(names):
            src = torch.tensor(value[i] if stacked else value)
            if dense:
                src = src.T
            if tuple(src.shape) != tuple(params[name].shape):
                raise ValueError(f"{key}: reference shape "
                                 f"{tuple(src.shape)} != port shape "
                                 f"{tuple(params[name].shape)}")
            out[name] = src
    extra = set(arrays) - {key for key, *_ in leaf_map(model)}
    if extra:
        raise ValueError(f"reference leaves the port has no place for: "
                         f"{sorted(extra)}")
    return out


def decay_mask(model: Union[LM, EncDec]) -> Dict[str, bool]:
    """Which parameters the reference's AdamW decays: a leaf of two or
    more dimensions in ITS layout (``train/optimizer.py``'s ``p.ndim >=
    2``), so every stacked per-layer leaf — norm scales, biases, the SSM's
    ``A_log`` / ``D`` / ``dt_bias`` of shape (L, ...) — decays, and of the
    unstacked leaves (the embedding, the final and encoder norms, the LM
    head, the hybrid's ``shared`` block) only the matrices."""
    params = dict(model.named_parameters())
    return {name: stacked or params[name].dim() >= 2
            for _, names, _, stacked in leaf_map(model) for name in names}


@torch.no_grad()
def load_reference(model: Union[LM, EncDec],
                   arrays: Arrays) -> Union[LM, EncDec]:
    """Copy the reference's flattened params into ``model`` (its device and
    dtype).  Every leaf of the model must be present with the reference's
    shape; extra keys are an error too."""
    params = dict(model.named_parameters())
    for name, src in from_reference(model, arrays).items():
        dst = params[name]
        dst.copy_(src.to(dtype=dst.dtype, device=dst.device))
    return model


def export_reference(model: Union[LM, EncDec]) -> Arrays:
    """The inverse of :func:`load_reference`: the model's weights as the
    reference's flattened params (stacked layers, (in, out) dense
    weights), in their own dtype on the host."""
    return to_reference(model, dict(model.named_parameters()))


def _np_dtype(dtype: torch.dtype):
    """numpy dtype for a torch dtype; bf16 (which numpy lacks) goes out as
    f32, which holds it exactly."""
    if dtype == torch.bfloat16:
        return np.float32
    return torch.empty((), dtype=dtype).numpy().dtype
