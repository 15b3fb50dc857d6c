"""Model interface of the paged serving engine — the port's counterpart of
the paged entry points of the reference package's ``models/registry.py``.

``params`` is the :class:`~repro_torch.models.transformer.LM` module (it
carries its config); batches are ``{"tokens": (b, s) int}``, and a decode
batch carries one token column.  The arena ``{"k", "v"}`` is written in
place, where the reference returns a new one.
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
