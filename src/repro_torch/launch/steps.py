"""Builders of (step fn, meta inputs, specs) triples for train, prefill and
decode — the port's counterpart of the reference package's
``launch/steps.py``, shared by the dry run (``launch/dryrun.py``) and the
tests.

Everything here is allocation-free: the model is built on the meta device
(:func:`abstract_params`; a 30B config allocates nothing), inputs are
``configs/shapes.py``'s meta stand-ins, and the step functions are the
port's own train steps, forward and ``decode_step``.  On meta tensors the
kernels' dispatch (``kernels/ops.py``) takes the plain versions, which
compute shapes only; CUDA tensors still reach only the kernels.  Specs are
``sharding/rules.py``'s tuples; they say how the step is cut over the
mesh.  On a mesh with coordinates — a rank mesh (``launch/ranks.py``) or
the dry run's representative rank (``launch/mesh.py``
``representative_rank``) — the step runs as that rank: the model is the
rank's shard of the meta model (``registry.shard_params``), the train
state holds the rank's ZeRO-1 slices, the decode cache the rank's part,
and the step's collectives are the rank's (counted, not run, on the
representative rank).  The specs are always the whole tensors'.  A rank
that trains real weights builds its state from its own shard
(``make_train_state(registry.shard_params(model, cfg, mesh), opt,
zero1)``) and calls the returned step on it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs import shapes as SH
from repro_torch.models import registry as R
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.train import optimizer as O
from repro_torch.train import train_loop as TL

Built = Tuple[Callable, tuple, dict]


def abstract_params(cfg: ModelConfig, mesh=None):
    """The port's model for ``cfg`` on the meta device: every parameter's
    shape and dtype, no memory; on a mesh with coordinates the rank's
    shard of it."""
    model = R.init_params(cfg, device="meta")
    if _as_rank(mesh):
        return R.shard_params(model, cfg, mesh)
    return model


def _as_rank(mesh) -> bool:
    """True when ``mesh`` has this process's coordinates (a rank mesh or
    the dry run's representative rank): the steps run as that rank."""
    return mesh is not None and getattr(mesh, "coords", None) is not None


# =============================================================================
# train
# =============================================================================
def default_accum(cfg: ModelConfig, mesh, shape: str) -> int:
    """Microbatch count: at most 4 sequences a device a microbatch."""
    cell = SH.SHAPES[shape]
    dp = rules.axes_size(mesh, rules.data_axes(mesh))
    b_local = max(cell.global_batch // dp, 1)
    accum = max(b_local // 4, 1)
    while cell.global_batch % (accum * dp) and accum > 1:
        accum //= 2
    return accum


def build_train(cfg: ModelConfig, mesh, shape: str = "train_4k",
                opt_cfg: Optional[O.AdamWConfig] = None,
                accum: Optional[int] = None, zero1: bool = True) -> Built:
    """(train step, (state, batch), specs).  ``accum``: gradient-
    accumulation microbatches (None: at most 4 sequences a device a
    microbatch); ``zero1``: AdamW's moments cut over the data axes.
    specs: {"params", "opt": {"m", "v", "step"}, "batch", "accum"}."""
    opt_cfg = opt_cfg or O.AdamWConfig()
    model = abstract_params(cfg)
    state = TL.make_train_state(abstract_params(cfg, mesh), opt_cfg, zero1)
    p_specs = rules.param_specs(model, cfg, mesh)
    mv_specs = rules.opt_state_specs(model, cfg, mesh) if zero1 else p_specs
    batch = SH.input_specs(cfg, shape)
    if accum is None:
        accum = default_accum(cfg, mesh, shape)
    step = (TL.make_grad_accum_train_step(cfg, opt_cfg, accum) if accum > 1
            else TL.make_train_step(cfg, opt_cfg))
    specs = {"params": p_specs,
             "opt": {"m": mv_specs, "v": mv_specs, "step": ()},
             "batch": rules.batch_specs(batch, mesh), "accum": accum}
    return step, (state, batch), specs


# =============================================================================
# serve: prefill
# =============================================================================
def build_prefill(cfg: ModelConfig, mesh, shape: str = "prefill_32k"
                  ) -> Built:
    """(prefill fn -> logits, (params, batch), specs): the full forward.
    specs: {"params", "batch", "logits"}."""
    model = abstract_params(cfg)
    batch = SH.input_specs(cfg, shape)
    cell = SH.SHAPES[shape]
    axes = rules.fit_axes(mesh, rules.data_axes(mesh), cell.global_batch)

    def prefill(params, batch):
        if _as_rank(mesh) and axes:          # the rank's rows
            batch = TL._split_rows(batch, rules.axes_size(mesh, axes),
                                   rules.block_index(mesh, axes))
        return R.forward(params, batch, cfg)[0]

    specs = {"params": rules.param_specs(model, cfg, mesh),
             "batch": rules.batch_specs(batch, mesh),
             "logits": rules._norm((axes, None, rules.MODEL_AXIS))}
    return prefill, (abstract_params(cfg, mesh), batch), specs


# =============================================================================
# serve: decode
# =============================================================================
def build_decode(cfg: ModelConfig, mesh, shape: str = "decode_32k",
                 seq_shard: Optional[bool] = None) -> Built:
    """(decode step -> (logits, cache), (params, cache, batch), specs): one
    new token against a ``seq_len`` cache.  ``seq_shard``: cut the KV
    sequence dim over (data, model) in place of batch and heads; on by
    default for a batch too small to cut (the 500k cell).  specs:
    {"params", "cache", "batch", "logits"}."""
    cell = SH.SHAPES[shape]
    if seq_shard is None:
        seq_shard = cell.global_batch < 8
    model = abstract_params(cfg)
    batch = SH.input_specs(cfg, shape)
    src = SH.src_embeds_spec(cfg, shape)
    cache = R.make_cache(model, cfg, cell.global_batch, cell.seq_len,
                         src_embeds=src, device="meta")

    def serve_step(params, cache, batch):
        return R.decode_step(params, cache, batch, cfg)

    axes = rules.fit_axes(mesh, rules.data_axes(mesh), cell.global_batch)
    specs = {"params": rules.param_specs(model, cfg, mesh),
             "cache": rules.cache_specs(cache, mesh, cfg,
                                        seq_shard=seq_shard),
             "batch": rules.batch_specs(batch, mesh),
             "logits": rules._norm((axes, rules.MODEL_AXIS))}
    if _as_rank(mesh):
        model = abstract_params(cfg, mesh)
        cache = R.make_cache(model, cfg, cell.global_batch, cell.seq_len,
                             src_embeds=src, device="meta",
                             seq_shard=seq_shard)
    return serve_step, (model, cache, batch), specs


def build_step_for_cell(cfg: ModelConfig, mesh, shape: str, **kw) -> Built:
    kind = SH.SHAPES[shape].kind
    if kind == "train":
        return build_train(cfg, mesh, shape, **kw)
    if kind == "prefill":
        return build_prefill(cfg, mesh, shape, **kw)
    return build_decode(cfg, mesh, shape, **kw)


def count_flops(step: Callable, args: tuple):
    """(what one call of ``step`` on ``args`` (meta tensors) returns, its
    operations), counted by ``torch.utils.flop_counter.FlopCounterMode``:
    matrix products and attention as PyTorch's formulas count them (2 per
    multiply-add), the backward's too; elementwise work is not
    counted."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        out = step(*args)
    return out, float(counter.get_total_flops())


def device_bytes(tensors: Dict[str, object], specs: Dict[str, object],
                 mesh) -> int:
    """One device's bytes of a (nested) dict of tensors under specs of the
    same shape (``rules.cache_specs`` / ``batch_specs``)."""
    total = 0
    for key, t in tensors.items():
        if isinstance(t, dict):
            total += device_bytes(t, specs[key], mesh)
        else:
            total += rules.shard_bytes(t.shape, specs[key], mesh,
                                       t.element_size())
    return total
