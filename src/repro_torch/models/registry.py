"""Model interface — the port's counterpart of the reference package's
``models/registry.py``: the generic entry points (:func:`forward`,
:func:`make_cache`, :func:`decode_step`; every family) and the slotted and
paged entry points of the serving engines (dense and MoE).

``params`` is the :class:`~repro_torch.models.transformer.LM` module, or
for a config with encoder layers the :class:`~repro_torch.models.encdec.
EncDec` module (each carries its config).  Batches, as in the reference:

  * decoder-only: ``{"tokens": (b, s) int}``;
  * VLM: ``+ {"mrope_positions": (3, b, s) int}`` (optional: without it
    the rotary is the plain one);
  * enc-dec: ``{"src_embeds": (b, s_src, d), "tokens": (b, s) int}``.

A decode batch carries one token column (and a VLM's (3, b, 1)
positions).  The decode cache, the slot cache ``{"k", "v", "lengths"}``
and the arena ``{"k", "v"}`` are written in place, where the reference
returns new ones.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

LM = T.LM
Params = Union[T.LM, ED.EncDec]


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Optional[torch.device] = None) -> Params:
    """Random weights from ``seed`` on ``device`` (the GPU by default): an
    ``EncDec`` for a config with encoder layers, else an ``LM``."""
    if cfg.n_enc_layers > 0:
        return ED.init_encdec(cfg, seed=seed, device=device)
    return T.init_lm(cfg, seed=seed, device=device)


def _check_cfg(params: Params, cfg: ModelConfig) -> None:
    if cfg != params.cfg:
        raise ValueError(f"cfg {cfg.name!r} is not the config of the "
                         f"params ({params.cfg.name!r})")


def forward(params: Params, batch: dict, cfg: ModelConfig,
            train: bool = False, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (b, s, V), aux_loss ()); with
    ``return_hidden`` the final hidden states (b, s, d) in place of the
    logits.  ``aux_loss`` is the MoE layers' summed load-balance loss (0
    for the other families).  The SSM and hybrid families need ``s`` to
    be a multiple of ``cfg.ssm_chunk``.  ``train=True`` is the training
    forward: it records gradients, with per-layer activation
    checkpointing by ``cfg.remat`` / ``cfg.remat_policy`` (on CUDA the
    attention's and the SSD scan's gradients are their backward kernels).
    Without it the forward runs under ``no_grad``."""
    _check_cfg(params, cfg)
    if cfg.n_enc_layers > 0:
        return ED.forward_encdec(params, batch["src_embeds"],
                                 batch["tokens"], return_hidden=return_hidden,
                                 train=train)
    return T.forward_lm(params, batch["tokens"],
                        mrope_positions=batch.get("mrope_positions"),
                        return_hidden=return_hidden, train=train)


def head_weights(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The LM head as a (d, V_padded) matrix, as the reference's: the
    embedding table's transpose when tied (a view), else the head's."""
    _check_cfg(params, cfg)
    if params.lm_head is None:
        return params.embed.T
    return params.lm_head.weight.T


def make_cache(params: Params, cfg: ModelConfig, batch_size: int,
               max_len: int, src_embeds: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> dict:
    """Decode state for :func:`decode_step` on ``device`` (the GPU by
    default): KV caches of ``max_len`` positions, SSM conv histories (in
    ``dtype``) and f32 states, and ``pos``.  Enc-dec runs the encoder on
    ``src_embeds`` (needed) and keeps every layer's cross K/V; its batch
    is ``src_embeds``'s and ``batch_size`` is ignored, as in the
    reference."""
    _check_cfg(params, cfg)
    if cfg.n_enc_layers > 0:
        if src_embeds is None:
            raise ValueError("enc-dec decode needs encoder inputs "
                             "(src_embeds)")
        return ED.init_encdec_cache(params, src_embeds, max_len, dtype,
                                    device)
    return T.init_kv_cache(cfg, batch_size, max_len, dtype, device)


def decode_step(params: Params, cache: dict, batch: dict,
                cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One-token decode at ``cache["pos"]`` -> (logits (b, V), cache),
    the cache advanced in place."""
    _check_cfg(params, cfg)
    if cfg.n_enc_layers > 0:
        return ED.decode_step_encdec(params, cache, batch["tokens"])
    return T.decode_step_lm(params, cache, batch["tokens"],
                            mrope_positions=batch.get("mrope_positions"))


def supports_slots(cfg: ModelConfig) -> bool:
    """True when the family can serve through the slotted batched KV
    cache."""
    return cfg.n_enc_layers == 0 and T.supports_slots(cfg)


def make_slot_cache(cfg: ModelConfig, n_slots: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None) -> T.SlotCache:
    """Fixed-capacity batched KV cache with a per-slot ``lengths`` vector."""
    return T.init_slot_cache(cfg, n_slots, max_len, dtype, device)


def prefill_kv(params: LM, batch: dict
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pass prefill -> (logits (b, s, V), k (L, b, s, K, dh), v) so the
    engine fills slot caches without replaying the prompt token by
    token."""
    return T.prefill_kv_lm(params, batch["tokens"])


def decode_slots(params: LM, cache: T.SlotCache, batch: dict,
                 active: torch.Tensor) -> Tuple[torch.Tensor, T.SlotCache]:
    """Batched decode over all slots -> (logits (n_slots, V), cache)."""
    return T.decode_slots_lm(params, cache, batch["tokens"], active)


def make_block_arena(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> T.Arena:
    """Paged KV arena (block 0 = junk sink); ``serving.kvpool`` owns the
    free-list / refcount / block-table map of it."""
    return T.init_block_arena(cfg, n_blocks, block_size, dtype, device)


def prefill_paged(params: LM, batch: dict, arena: T.Arena,
                  table: torch.Tensor, n_past: int, true_c: int
                  ) -> torch.Tensor:
    """One chunk of chunked prefill for one sequence -> logits (1, C, V).
    Positions n_past..n_past+true_c-1; the padded chunk tail writes into
    the junk block."""
    return T.prefill_paged_lm(params, batch["tokens"], arena, table, n_past,
                              true_c)


def decode_paged(params: LM, arena: T.Arena, batch: dict,
                 tables: torch.Tensor, lengths: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """Batched paged decode step -> logits (b, V).  Inactive rows write into
    the junk block."""
    return T.decode_paged_lm(params, arena, batch["tokens"], tables, lengths,
                             active)


def decode_paged_multi(params: LM, arena: T.Arena, batch: dict,
                       tables: torch.Tensor, lengths: torch.Tensor,
                       active: torch.Tensor, n_steps: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` fused greedy paged decode steps with on-device token
    feedback -> (toks (n_steps, b), next (b, 1), lengths (b,)).  Equal to
    ``n_steps`` host-fed :func:`decode_paged` calls; the caller guarantees
    block-table headroom and ``remaining >= n_steps``."""
    return T.decode_paged_multi_lm(params, arena, batch["tokens"], tables,
                                   lengths, active, n_steps)
