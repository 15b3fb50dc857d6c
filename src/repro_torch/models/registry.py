"""Model interface — the port's counterpart of the reference package's
``models/registry.py``: the generic entry points (:func:`forward`,
:func:`make_cache`, :func:`decode_step`; the dense, MoE, SSM and hybrid
families) and the slotted and paged entry points of the serving engines
(dense and MoE).

``params`` is the :class:`~repro_torch.models.transformer.LM` module (it
carries its config); batches are ``{"tokens": (b, s) int}``, and a decode
batch carries one token column.  The decode cache, the slot cache
``{"k", "v", "lengths"}`` and the arena ``{"k", "v"}`` are written in
place, where the reference returns new ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

LM = T.LM


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Optional[torch.device] = None) -> LM:
    """Random weights from ``seed`` on ``device`` (the GPU by default)."""
    return T.init_lm(cfg, seed=seed, device=device)


def _check_cfg(params: LM, cfg: ModelConfig) -> None:
    if cfg != params.cfg:
        raise ValueError(f"cfg {cfg.name!r} is not the config of the "
                         f"params ({params.cfg.name!r})")


def forward(params: LM, batch: dict, cfg: ModelConfig, train: bool = False,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (b, s, V), aux_loss ()); with
    ``return_hidden`` the final hidden states (b, s, d) in place of the
    logits.  ``aux_loss`` is the MoE layers' summed load-balance loss (0
    for the other families).  The SSM and hybrid families need ``s`` to
    be a multiple of ``cfg.ssm_chunk``.  ``train=True`` (the training step)
    is not ported."""
    _check_cfg(params, cfg)
    if train:
        raise NotImplementedError("the training forward is not ported yet")
    return T.forward_lm(params, batch["tokens"], return_hidden=return_hidden)


def make_cache(params: LM, cfg: ModelConfig, batch_size: int, max_len: int,
               src_embeds: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> T.KVCache:
    """Decode state for :func:`decode_step` on ``device`` (the GPU by
    default): KV caches of ``max_len`` positions, SSM conv histories (in
    ``dtype``) and f32 states, and ``pos``.  Enc-dec (``src_embeds``) is not
    ported."""
    _check_cfg(params, cfg)
    if src_embeds is not None or cfg.n_enc_layers:
        raise NotImplementedError("enc-dec decode is not ported yet")
    return T.init_kv_cache(cfg, batch_size, max_len, dtype, device)


def decode_step(params: LM, cache: T.KVCache, batch: dict,
                cfg: ModelConfig) -> Tuple[torch.Tensor, T.KVCache]:
    """One-token decode at ``cache["pos"]`` -> (logits (b, V), cache),
    the cache advanced in place."""
    _check_cfg(params, cfg)
    return T.decode_step_lm(params, cache, batch["tokens"])


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
