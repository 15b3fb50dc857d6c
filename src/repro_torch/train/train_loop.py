"""The loss and the train steps — the port's counterpart of the reference
package's ``train/train_loop.py``.

The training state is ``{"params": model, "opt": optimizer state}``
(:func:`make_train_state`); a step takes it and a batch of tensors on the
model's device and returns ``(state, metrics)``, the model and the
optimizer state updated in place (the reference returns new ones).
Metrics are 0-d tensors on the device, so a step does not wait for the
card.  Three steps, as in the reference:

  * :func:`make_train_step` — one batch, one update;
  * :func:`make_grad_accum_train_step` — the batch in ``accum``
    microbatches, their f32 gradients summed (each divided by ``accum``)
    before one update;
  * :func:`make_ddp_train_step` — data parallel over a
    ``torch.distributed`` process group: each rank takes its rows of the
    global batch, and the gradients are averaged by
    ``compression.all_reduce_mean`` (f32, bf16 or int8).

On CUDA the attention's gradient is the flash kernel's backward and the
SSD scan's (the SSM and hybrid families) the scan's backward kernels.

On a rank mesh (the state's model a rank's shard, ``registry.
shard_params``; every family) :func:`make_train_step` and
:func:`make_grad_accum_train_step` are the reference's GSPMD step
written out (``train/parallel.py``): each data replica takes its rows of
the global batch (of each microbatch, when it accumulates), the loss is the
vocab-parallel cross-entropy over the rank's logit slice
(:func:`chunked_xent` with a mesh), the gradients are reduced over the
mesh and the update runs on the ZeRO-1 slices the state holds
(:func:`make_train_state` with ``zero1``).  The metrics are the means
over the data replicas.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import registry as R
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as CL
from repro_torch.sharding.rules import MODEL_AXIS
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O
from repro_torch.train import parallel as P

Step = Callable[[dict, dict], Tuple[dict, dict]]


# =============================================================================
# loss
# =============================================================================
def _chunk_nll(xi: torch.Tensor, w: torch.Tensor,
               li: torch.Tensor) -> torch.Tensor:
    logits = (xi @ w).float()                                  # (b, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, li.long()[..., None])[..., 0]
    return (lse - label_logit).sum()


def _chunk_nll_cut(xi: torch.Tensor, w: torch.Tensor, li: torch.Tensor,
                   vocab: int, mesh) -> torch.Tensor:
    """:func:`_chunk_nll` over the rank's slice of the vocab (columns
    ``lo .. lo + n - 1`` of the head; those past ``vocab`` are the shard's
    padding, left out of the log-sum-exp): the maximum by an exact
    all-reduce MAX, the sum of exponentials and the label's logit (from
    the rank that holds it) by all-reduces over "model"."""
    logits = (xi @ w).float()                                  # (b, c, n)
    n = logits.shape[-1]
    lo = mesh.coord(MODEL_AXIS) * n
    if vocab - lo < n:
        cols = torch.arange(n, device=logits.device)
        logits = torch.where(cols < vocab - lo, logits,
                             torch.full_like(logits, float("-inf")))
    m = CL.max_over(logits.amax(-1), mesh, MODEL_AXIS)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    se = CL.sum_over(torch.exp(logits - m[..., None]).sum(-1), mesh,
                     MODEL_AXIS)
    local = li.long() - lo
    mine = (local >= 0) & (local < n)
    label = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    label = CL.sum_over(torch.where(mine, label, torch.zeros_like(label)),
                        mesh, MODEL_AXIS)
    return (m + torch.log(se) - label).sum()


def chunked_xent(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 vocab: int, chunk: int = 512, mesh=None) -> torch.Tensor:
    """Mean next-token NLL of hidden states x (b, s, d) under the head w
    (d, vocab), one sequence chunk at a time, each chunk recomputed in the
    backward (``torch.utils.checkpoint``): one (b, chunk, vocab) slab of
    f32 logits is live at a time.  The chunking is the reference's: ``nc =
    max(s // chunk, 1)`` chunks of ``s // nc``; the logsumexp is over the
    whole (padded) vocabulary in f32; the label's logit is gathered, which
    equals the reference's one-hot contraction exactly.  On a rank mesh
    (``mesh``, whose "model" axis of m ranks cuts the vocab) w is the
    rank's (d, ceil(vocab / m)) slice and x the replicated hidden states
    (their gradient summed over "model"): the vocab-parallel
    cross-entropy (:func:`_chunk_nll_cut`)."""
    b, s, d = x.shape
    cut = mesh is not None and mesh.shape[MODEL_AXIS] > 1
    want = -(-vocab // mesh.shape[MODEL_AXIS]) if cut else vocab
    if w.shape[-1] != want:
        raise ValueError(f"chunked_xent: head of {w.shape[-1]} columns for "
                         f"a vocabulary of {vocab}")
    nc = max(s // chunk, 1)
    chunk = s // nc
    if s % chunk:
        raise ValueError(f"chunked_xent: {s} positions do not split into "
                         f"{nc} chunks")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cut:
        x = CL.copy_to(x, mesh, MODEL_AXIS)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        if cut:
            total = total + ckpt.checkpoint(
                _chunk_nll_cut, x[:, sl], w, labels[:, sl], vocab, mesh,
                use_reentrant=False)
            continue
        total = total + ckpt.checkpoint(_chunk_nll, x[:, sl], w,
                                        labels[:, sl], use_reentrant=False)
    return total / (b * s)


def lm_loss(model, batch: dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over the final hidden states (the head
    applied inside :func:`chunked_xent`) plus the MoE load-balance loss ->
    (loss, {"loss", "aux_loss", "ppl_proxy"})."""
    hidden, aux = R.forward(model, batch, cfg, train=True,
                            return_hidden=True)
    w = R.head_weights(model, cfg)
    nll = chunked_xent(hidden, w, batch["labels"], cfg.padded_vocab,
                       mesh=getattr(model, "mesh", None))
    loss = nll + aux
    metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
               "ppl_proxy": nll.detach()}
    return loss, metrics


def _grads(model, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """d loss / d each parameter, keyed by name (zeros where a parameter
    does not reach the loss)."""
    named = dict(model.named_parameters())
    gs = torch.autograd.grad(loss, list(named.values()),
                             materialize_grads=True)
    return dict(zip(named, gs))


# =============================================================================
# train steps
# =============================================================================
def make_train_state(model, opt_cfg: O.AdamWConfig,
                     zero1: bool = False) -> dict:
    """``{"params": model, "opt": zero AdamW state}``; the model's
    parameters are set to require gradients.  For a rank's shard the
    moments are its parameters' shards, or with ``zero1`` the ZeRO-1
    slices it owns (``train/parallel.py``)."""
    del opt_cfg                       # the reference's signature
    model.requires_grad_(True).train()
    if P.rank_mesh(model) is not None:
        return {"params": model, "opt": P.init_opt_state(model, zero1)}
    return {"params": model, "opt": O.init_opt_state(model)}


def _update(opt_cfg: O.AdamWConfig, state: dict, grads: dict,
            metrics: dict, plan: Optional[P.Plan]) -> Tuple[dict, dict]:
    """The AdamW update of ``state`` by ``grads`` -> (state, metrics with
    "grad_norm" and "lr").  On a rank mesh (``plan``) the gradients are
    reduced over the mesh and the metrics averaged over the data replicas
    first, and the update runs on the state's ZeRO-1 slices."""
    if plan is not None:
        grads = plan.reduce_grads(grads)
        metrics = {k: plan.data_mean(v) for k, v in metrics.items()}
    _, opt, opt_metrics = O.adamw_update(opt_cfg, grads, state["opt"],
                                         state["params"], plan=plan)
    state["opt"] = opt
    return state, {**metrics, **opt_metrics}


def make_train_step(cfg: ModelConfig, opt_cfg: O.AdamWConfig) -> Step:
    def train_step(state: dict, batch: dict) -> Tuple[dict, dict]:
        model = state["params"]
        plan = P.plan_of(state)
        loss, metrics = lm_loss(model, batch if plan is None
                                else plan.rows(batch), cfg)
        grads = _grads(model, loss)
        del loss
        return _update(opt_cfg, state, grads, metrics, plan)
    return train_step


def _split_rows(batch: dict, parts: int, index: int) -> dict:
    """Rows ``index`` of ``parts`` equal slices of the batch (axis 0, and
    axis 1 of ``mrope_positions`` (3, b, s))."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        b = v.shape[axis]
        if b % parts:
            raise ValueError(f"{k}: batch of {b} rows does not split into "
                             f"{parts}")
        out[k] = v.narrow(axis, index * (b // parts), b // parts)
    return out


def make_grad_accum_train_step(cfg: ModelConfig, opt_cfg: O.AdamWConfig,
                               accum: int) -> Step:
    """Gradient accumulation: the batch's rows in ``accum`` microbatches
    (in order; on a rank mesh each replica takes its rows of each, as
    the reference keeps a microbatch cut over the data axes), each one's
    gradients in f32 divided by ``accum`` and summed, its loss likewise,
    then one AdamW update — live activations divided by ``accum``.
    Metrics: "loss" (= "ppl_proxy"), "aux_loss" 0, "grad_norm", "lr", as
    the reference's."""
    def train_step(state: dict, batch: dict) -> Tuple[dict, dict]:
        model = state["params"]
        plan = P.plan_of(state)
        g_acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for n, p in model.named_parameters()}
        l_acc = torch.zeros((), dtype=torch.float32,
                            device=next(model.parameters()).device)
        for i in range(accum):
            mb = _split_rows(batch, accum, i)
            loss, _ = lm_loss(model, mb if plan is None else plan.rows(mb),
                              cfg)
            for n, g in _grads(model, loss).items():
                g_acc[n] = g_acc[n] + g.float() / accum
            l_acc = l_acc + loss.detach() / accum
            del loss
        return _update(opt_cfg, state, g_acc, {
            "loss": l_acc, "aux_loss": torch.zeros_like(l_acc),
            "ppl_proxy": l_acc}, plan)
    return train_step


def make_ddp_train_step(cfg: ModelConfig, opt_cfg: O.AdamWConfig,
                        group=None, compressor: Optional[str] = None
                        ) -> Step:
    """Data parallel over the ``torch.distributed`` group (the default
    group when None; initialised by the caller): each rank computes the
    gradients of its rows of the global batch, averages them over the
    group by ``compression.all_reduce_mean(method=compressor)`` and takes
    the same AdamW update; the loss is the group's mean.  Metrics:
    "loss", "grad_norm", "lr", as the reference's."""
    import torch.distributed as dist

    def step(state: dict, batch: dict) -> Tuple[dict, dict]:
        model = state["params"]
        local = _split_rows(batch, dist.get_world_size(group),
                            dist.get_rank(group))
        loss, _ = lm_loss(model, local, cfg)
        grads = C.all_reduce_mean(_grads(model, loss), group,
                                  method=compressor)
        loss = C.all_reduce_mean({"loss": loss.detach()}, group)["loss"]
        _, opt, opt_metrics = O.adamw_update(opt_cfg, grads, state["opt"],
                                             model)
        state["opt"] = opt
        return state, {"loss": loss, **opt_metrics}
    return step
