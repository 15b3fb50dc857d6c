"""The reference's input-shape cells and meta-tensor stand-ins for the dry
run — the port's counterpart of the reference package's
``configs/shapes.py``.

Each decoder architecture is paired with four cells:
  train_4k     seq=4096,   global_batch=256   -> a train step
  prefill_32k  seq=32768,  global_batch=32    -> serve prefill (the forward)
  decode_32k   seq=32768,  global_batch=128   -> a decode step (one token
                                                 against a KV cache)
  long_500k    seq=524288, global_batch=1     -> a decode step, for the
                                                 sub-quadratic archs only

:func:`input_specs` allocates nothing: every entry is a
``torch.empty(..., device="meta")`` of the reference's shape and dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs that can run a 500k-context decode (sub-quadratic or windowed);
# the pure full-attention archs skip that cell, as in the reference
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "gemma3-27b")


def cell_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True


def meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` that holds no memory."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for the model-facing batch of one cell.

    ``train``: tokens and labels; ``prefill``: tokens; ``decode``: one
    token column (the cache comes from ``make_cache``).  The modality
    front ends are the reference's stubs: seamless gets precomputed frame
    embeddings, qwen2-vl M-RoPE position streams."""
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        batch = {"tokens": meta((b, 1), torch.int32)}
        if cfg.mrope_sections:
            batch["mrope_positions"] = meta((3, b, 1), torch.int32)
        return batch
    batch = {"tokens": meta((b, s), torch.int32)}
    if cell.kind == "train":
        batch["labels"] = meta((b, s), torch.int32)
    if cfg.mrope_sections:
        batch["mrope_positions"] = meta((3, b, s), torch.int32)
    if cfg.n_enc_layers > 0:
        batch["src_embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
    return batch


def src_embeds_spec(cfg: ModelConfig, shape: str) -> Optional[torch.Tensor]:
    """The encoder input of an enc-dec decode cell (memory length = seq)."""
    if cfg.n_enc_layers == 0:
        return None
    cell = SHAPES[shape]
    return meta((cell.global_batch, cell.seq_len, cfg.d_model),
                torch.bfloat16)
