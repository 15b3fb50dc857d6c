"""Deterministic synthetic token pipeline — the port's counterpart of the
reference package's ``train/data.py``, in numpy, so that the same ``(seed,
step)`` gives the same batch in both packages.

``batches(start_step)`` is a pure function of (seed, step): a restart from
a checkpoint at step N replays the exact stream — the data side of fault
tolerance.  A corpus reader would keep the interface.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticLM:
    """Markov-ish synthetic stream: tokens drift from a random start by
    steps of 1-6, so a model can lower its loss on it; labels are the next
    token (the last wraps to the first)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(np.uint64(c.seed) + np.uint64(step))
        b, s, v = c.global_batch, c.seq_len, c.vocab_size
        base = rng.integers(0, v, size=(b, 1), dtype=np.int32)
        drift = rng.integers(1, 7, size=(b, s), dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % v
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = tokens[:, 0]
        return {"tokens": tokens, "labels": labels}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray],
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (the GPU by default) — the
    reference's ``shard_batch`` on one device."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}
