"""Sharding rules — the port's counterpart of the reference package's
``sharding/rules.py``: which mesh axis each dimension of a parameter, an
optimizer moment, a batch entry, a decode cache and the paged arena is cut
over.

A spec is a tuple with one entry per dimension: None (replicated), an axis
name, or a tuple of two or more axis names (the dimension cut over their
product) — the entries of the reference's ``PartitionSpec``, which writes
a tuple of one axis as that axis.  The rules read only the
mesh's ``shape`` (axis name to size) and ``axis_names``
(``launch/mesh.py``), so an abstract mesh of the reference's production
pods serves them and the dry run.  On a rank mesh :func:`local_shard`
cuts a whole tensor to the rank's slice under a spec
(``models/registry.py`` ``shard_params``).

Logical layout on the production mesh (pod, data, model), as in the
reference:
  * parameters replicated over (pod, data); tensor- and expert-parallel
    over ``model`` (Megatron column / row pairs; MoE experts over model);
  * batch over (pod, data); a long context's KV optionally
    sequence-sharded.

The parameter rules are the reference's regexes on the reference's
parameter paths ('layers/attn/wq/w').  The port keeps one module per layer
and PyTorch's (out, in) dense weights, so :func:`param_specs` maps each
port parameter to its reference leaf through ``models/bridge.py``
``leaf_map``, takes the spec there (in the reference's layout, stacked
layers on a leading axis) and reverses the two entries of a dense weight,
which the port stores transposed.  A parameter of a layer stack
(``layers.{i}``, ``enc_layers.{i}``, ``dec_layers.{i}``) keeps the stack's
layer entry first: its spec has one entry more than its tensor has
dimensions.  The rules never cut that axis of a parameter; ZeRO-1
(:func:`opt_state_specs`) may cut it over the data axes, as the reference
does, and layer i's moments then live on the data shard that holds index
i.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig

MODEL_AXIS = "model"

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# Ordered (regex on the reference's 'a/b/c' parameter path, spec for the
# *unstacked* leaf).  First match wins.  "M" marks the model axis.
# Head-alignment guards (resolved against cfg x mesh in spec_for_param):
#   * attention q projections shard over model ONLY if n_heads % model == 0
#   * attention k/v projections ONLY if n_kv_heads % model == 0
#   (otherwise the cut falls inside d_head and partial-head products must
#   be summed across devices at activation size; replicated KV projections
#   are the standard GQA tensor-parallel fallback)
#   * MoE experts shard over model if padded_experts % model == 0 (expert
#     parallelism), else the expert-FF dim shards (qwen2-moe's 60 experts,
#     padded to 64, on a model axis that does not divide them)
_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r"embed/table$",            ("M", None)),          # vocab-sharded
    (r"lm_head/w$",              (None, "M")),
    (r"wq/w$",                   (None, "Q")),
    (r"wq/b$",                   ("Q",)),
    (r"(wk|wv)/w$",              (None, "K")),
    (r"(wk|wv)/b$",              ("K",)),
    (r"attn/wo/w$",              ("Q", None)),
    (r"xattn/wo/w$",             ("Q", None)),
    (r"(q_norm|k_norm)/scale$",  (None,)),
    (r"(wi_gate|wi_up)/w$",      (None, "M")),
    (r"mlp/wo/w$",               ("M", None)),
    (r"shared/wo/w$",            ("M", None)),          # MoE shared expert
    (r"moe/router$",             (None, None)),
    (r"(w_gate|w_up)$",          ("E", None, "F")),     # expert- or FF-par.
    (r"w_down$",                 ("E", "F", None)),
    # mamba2
    (r"(wz|wx|wdt)/w$",          (None, "M")),
    (r"(wB|wC)/w$",              (None, None)),
    (r"conv_x$",                 (None, "M")),
    (r"(conv_B|conv_C)$",        (None, None)),
    (r"conv_bx$",                ("M",)),
    (r"(conv_bB|conv_bC)$",      (None,)),
    (r"(A_log|D|dt_bias)$",      ("M",)),
    (r"out_proj/w$",             ("M", None)),
    # norms / default
    (r"scale$",                  (None,)),
    (r"bias$",                   (None,)),
    (r"b$",                      (None,)),
)

_STACKED_PREFIXES = ("layers/", "enc_layers/", "dec_layers/")


def _norm(spec) -> Spec:
    """A spec with each one-axis tuple written as its axis, as a
    ``PartitionSpec`` writes it."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def spec_for_param(path_str: str, ndim: int, cfg: ModelConfig,
                   n_model: int) -> Spec:
    """The spec of the reference's leaf at ``path_str`` of ``ndim``
    dimensions (a stacked leaf's first is the layer axis)."""
    stacked = path_str.startswith(_STACKED_PREFIXES)
    eff_ndim = ndim - 1 if stacked else ndim
    q_ok = cfg.n_heads > 0 and cfg.n_heads % n_model == 0
    k_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % n_model == 0
    e_ok = cfg.n_experts > 0 and cfg.padded_experts % n_model == 0

    def resolve(a):
        if a == "M":
            return MODEL_AXIS
        if a == "Q":
            return MODEL_AXIS if q_ok else None
        if a == "K":
            return MODEL_AXIS if k_ok else None
        if a == "E":
            return MODEL_AXIS if e_ok else None
        if a == "F":
            return None if e_ok else MODEL_AXIS
        return None

    for pat, spec in _RULES:
        if re.search(pat, path_str):
            axes = tuple(resolve(a) for a in spec)
            if len(axes) != eff_ndim:
                # a rank-mismatched rule (a scalar norm): replicate
                axes = (None,) * eff_ndim
            return ((None,) + axes) if stacked else axes
    return (None,) * ndim


def _reference_leaves(model):
    """(reference key, the port's names, dense, stacked, the reference
    leaf's shape) of every leaf of ``model`` (``bridge.leaf_map``)."""
    from repro_torch.models import bridge
    params = dict(model.named_parameters())
    for key, names, dense, stacked in bridge.leaf_map(model):
        shape = tuple(params[names[0]].shape)
        if dense:
            shape = shape[::-1]
        if stacked:
            shape = (len(names),) + shape
        yield key, names, dense, stacked, shape


def _to_port(spec: Spec, dense: bool, stacked: bool) -> Spec:
    """A reference-layout spec in the port's layout: a dense weight's two
    entries reversed (a stack's layer entry stays first)."""
    head, dims = (tuple(spec[:1]), tuple(spec[1:])) if stacked \
        else ((), tuple(spec))
    return head + (dims[::-1] if dense else dims)


def param_specs(model, cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    """Spec of every parameter of ``model`` (an ``LM`` or ``EncDec``, on
    any device, the meta device included), keyed by
    ``model.named_parameters()``'s names, in the port's layout (a stack's
    layer entry first, always None here)."""
    n_model = mesh.shape[MODEL_AXIS]
    out: Dict[str, Spec] = {}
    for key, names, dense, stacked, shape in _reference_leaves(model):
        spec = _to_port(spec_for_param(key, len(shape), cfg, n_model),
                        dense, stacked)
        out.update({n: spec for n in names})
    return out


def _zero1(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """The reference's ZeRO-1 extension of one leaf's spec (in its own
    layout): (a) widen the model-sharded dim across the data axes when
    divisible, else (b) shard the largest replicated dim over them."""
    dp = data_axes(mesh)
    dp_size = axes_size(mesh, dp)
    n_model = mesh.shape[MODEL_AXIS]
    if dp_size == 1 or not shape:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, ax in enumerate(dims):
        if ax == MODEL_AXIS and shape[i] % (n_model * dp_size) == 0:
            dims[i] = (MODEL_AXIS,) + dp
            return _norm(dims)
    for i in sorted(range(len(dims)), key=lambda i: -shape[i]):
        if dims[i] is None and shape[i] % dp_size == 0 \
                and shape[i] >= dp_size:
            dims[i] = dp
            return _norm(dims)
    return spec


def opt_state_specs(model, cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    """ZeRO-1: AdamW's moments shard over the data axes *in addition to*
    the model axis, per leaf as the reference decides it on its own
    layout (so a tie between equal dims breaks the same way, and a stack's
    layer axis may be the one cut), then in the port's layout; keyed as
    :func:`param_specs`."""
    n_model = mesh.shape[MODEL_AXIS]
    out: Dict[str, Spec] = {}
    for key, names, dense, stacked, shape in _reference_leaves(model):
        spec = _zero1(spec_for_param(key, len(shape), cfg, n_model), shape,
                      mesh)
        out.update({n: _to_port(spec, dense, stacked) for n in names})
    return out


# =============================================================================
# activation / batch / cache specs
# =============================================================================
def data_axes(mesh) -> Tuple[str, ...]:
    """Batch-parallel mesh axes: ('pod', 'data') when a pod axis exists."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axes_size(mesh, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, (tuple, list)) else [axes]):
        n *= mesh.shape[a]
    return n


def axes_of(ax) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (none for an uncut dim)."""
    return () if not ax else (ax,) if isinstance(ax, str) else tuple(ax)


def block_index(mesh, axes) -> int:
    """This rank's block index over ``axes`` (the first the slowest)."""
    block = 0
    for a in axes:
        block = block * mesh.shape[a] + mesh.coord(a)
    return block


def fit_axes(mesh, axes, size: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of ``axes`` whose product divides ``size`` (a batch
    of 1 keeps its batch dim unsharded)."""
    chosen = []
    for a in (axes if isinstance(axes, (tuple, list)) else [axes]):
        if size % (axes_size(mesh, chosen + [a])) == 0:
            chosen.append(a)
    return tuple(chosen) if chosen else None


def batch_specs(batch: Mapping[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    """Shard each batch entry's leading batch dim over (pod, data); M-RoPE
    positions (3, b, s) have it second.  Falls back to fewer or no axes
    when they do not divide it."""
    dp = data_axes(mesh)
    out = {}
    for name, leaf in batch.items():
        shape = tuple(leaf.shape)
        if "mrope" in name:
            spec = (None, fit_axes(mesh, dp, shape[1])) \
                + (None,) * (len(shape) - 2)
        else:
            spec = (fit_axes(mesh, dp, shape[0]),) + (None,) * (len(shape) - 1)
        out[name] = _norm(spec)
    return out


def _cache_spec(name: str, shape: Tuple[int, ...], mesh,
                seq_shard: bool) -> Spec:
    dp = data_axes(mesh)
    nd = len(shape)
    if name in ("pos", "prefix_len"):
        return ()
    if name in ("sk", "sv"):
        # the append-buffer suffix: small, replicated over model
        return (None, fit_axes(mesh, dp, shape[1]), None, None, None)
    if "ssm" in name:
        # stacked (L, b, ...): conv_* (L, b, k-1, C), state (L, b, H, P, N)
        ax = fit_axes(mesh, dp, shape[1])
        if name.endswith("state"):
            return (None, ax, MODEL_AXIS, None, None)
        if name.endswith("conv_x"):
            return (None, ax, None, MODEL_AXIS)
        return (None, ax, None, None)
    if nd == 5:                      # KV caches (L, b, S, K, dh)
        if seq_shard:
            return (None, None, fit_axes(mesh, ("data", MODEL_AXIS),
                                         shape[2]), None, None)
        ax = fit_axes(mesh, dp, shape[1])
        if shape[3] % mesh.shape[MODEL_AXIS] == 0:
            return (None, ax, None, MODEL_AXIS, None)   # KV heads -> model
        # few KV heads (glm4 2, qwen3-moe 4): the sequence over model
        return (None, ax, fit_axes(mesh, (MODEL_AXIS,), shape[2]), None,
                None)
    return (None,) * nd


def cache_specs(cache: Mapping[str, object], mesh, cfg: ModelConfig, *,
                seq_shard: bool = False, _prefix: str = "") -> dict:
    """Decode-state sharding, a dict shaped like ``cache`` (nested for the
    SSM's ``"ssm"``).  Default: batch over (pod, data), KV heads over
    model (padded where they do not divide, as GSPMD pads).
    ``seq_shard=True`` (a long context whose batch is too small to shard):
    the KV sequence dim over (data, model) jointly.  SSM states: batch
    over (pod, data), head or channel dims over model."""
    out = {}
    for key, leaf in cache.items():
        name = f"{_prefix}{key}"
        if isinstance(leaf, Mapping):
            out[key] = cache_specs(leaf, mesh, cfg, seq_shard=seq_shard,
                                   _prefix=f"{name}/")
        else:
            out[key] = _norm(_cache_spec(name, tuple(leaf.shape), mesh,
                                         seq_shard))
    return out


def arena_spec(mesh, cfg: ModelConfig) -> Spec:
    """Spec of the paged KV arena (L, n_blocks, bs, K, dh): KV heads over
    ``model``; the block map's dims stay whole, since block tables live
    on the host and index whole pages.

    Unlike :func:`cache_specs`, a head count the model axis does not
    divide is an error here, not a padded fallback: an arena has no
    contiguous sequence dim to shard (its blocks are the map), and a cut
    inside the head dims would slice partial-head products that must be
    summed across devices at activation size every decode step — the
    glm4-like (n_kv_heads=2) failure the dense rules warn about."""
    n_model = mesh.shape[MODEL_AXIS]
    if n_model == 1:
        return (None, None, None, None, None)
    if cfg.n_kv_heads % n_model == 0:
        return (None, None, None, MODEL_AXIS, None)
    raise ValueError(
        f"paged KV arena cannot shard on the head dim: n_kv_heads="
        f"{cfg.n_kv_heads} is not divisible by the mesh's model axis "
        f"({n_model}), and padding would slice inside d_head "
        f"({cfg.d_head} % {n_model} = {cfg.d_head % n_model}): partial-head "
        f"products would be summed across devices every decode step.  "
        f"Build the mesh with launch.mesh.make_mesh_for(n, model_parallel=m) "
        f"for an m dividing n_kv_heads.")


def logits_spec(mesh) -> Spec:
    return _norm((data_axes(mesh), None, MODEL_AXIS))


# =============================================================================
# per-device sizes of a spec (the dry run's memory terms)
# =============================================================================
def param_device_bytes(model, specs: Mapping[str, Spec], mesh,
                       elt: Optional[int] = None) -> int:
    """One device's bytes of ``model``'s parameters (``elt`` bytes an
    element, or each parameter's own) under ``specs`` (from
    :func:`param_specs` or :func:`opt_state_specs`), each stack counted
    as the reference's stacked leaf."""
    params = dict(model.named_parameters())
    total = 0
    for key, names, dense, stacked, shape in _reference_leaves(model):
        spec = specs[names[0]]
        ref = ((spec[0],) + (spec[1:][::-1] if dense else spec[1:])) \
            if stacked else (spec[::-1] if dense else spec)
        size = elt or params[names[0]].element_size()
        total += shard_bytes(shape, ref, mesh, size)
    return total


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``spec``: each
    cut dim ``ceil(dim / product of its axes)``, as GSPMD pads."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // (axes_size(mesh, ax) if ax else 1))
                 for n, ax in zip(shape, spec))


def local_shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``full`` under ``spec`` on a
    rank mesh: each cut dim split into blocks of :func:`shard_shape`'s
    size, the rank's block by its coordinates along the dim's axes (the
    first axis named the slowest), zero-filled past the dim's end, as
    GSPMD pads.  Uncut dims, and a spec on a mesh of one device, keep the
    whole tensor (a view)."""
    spec = tuple(spec) + (None,) * (full.dim() - len(spec))
    want = shard_shape(full.shape, spec, mesh)
    out = full
    for dim, ax in enumerate(spec):
        if not ax:
            continue
        n = want[dim]
        lo = min(block_index(mesh, axes_of(ax)) * n, full.shape[dim])
        piece = out.narrow(dim, lo, min(n, full.shape[dim] - lo))
        if piece.shape[dim] < n:
            pad = list(piece.shape)
            pad[dim] = n - piece.shape[dim]
            piece = torch.cat([piece, piece.new_zeros(pad)], dim)
        out = piece
    return out


def shard_bytes(shape: Sequence[int], spec: Spec, mesh,
                elt: int) -> int:
    n = 1
    for d in shard_shape(shape, spec, mesh):
        n *= d
    return n * elt
