#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s decode-replay check moves when the SSD scan
changes: the readings that its ``REPLAY_TOL`` limits sit between.

    PYTHONPATH=src:. python3 scripts/replay_sensitivity.py

Needs one GPU.  For mamba2-2.7b and zamba2-2.7b at full width it replays
the prompts of ``chip_smoke``'s checks through ``decode_step`` — bf16
weights and cache, 4 x 128 tokens; f32 weights and cache, 2 x 256 tokens,
at the depth of ``chip_smoke.F32_REPLAY_LAYERS`` — and prints, as a fraction of the rms of the layers' part of the
forward's logits (the forward's logits less those of the embedding
alone), the rms difference between that replay and the forward computed
with the scan kernel and, in this process only, with ``ops.ssd_chunked``
replaced by: its plain version; a scan that drops its state at each chunk
boundary; and scans whose y is scaled by 0, 0.9, 0.98, 0.998 and 0.9998
— and how far each such forward moves from the kernel's, in the same
unit.  The decode path has no scan, so the replay itself never changes.
"""
from __future__ import annotations

import numpy as np
import torch

import chip_smoke
from repro_torch.configs import mamba2_2_7b, zamba2_2_7b
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.models import layers as L
from repro_torch.models import registry as R

KERNEL = ops.ssd_chunked


def _plain(x, dt, A, B, C, *, chunk: int = 128):
    return REF.ssd_chunked_ref(x, dt, A, B, C, chunk)


def _no_carry(x, dt, A, B, C, *, chunk: int = 128):
    """Each chunk as a row of its own: the state starts at zero in every
    chunk."""
    b, s = x.shape[:2]
    n = b * (s // chunk)
    y, st = KERNEL(x.reshape(n, chunk, *x.shape[2:]),
                   dt.reshape(n, chunk, *dt.shape[2:]), A,
                   B.reshape(n, chunk, *B.shape[2:]),
                   C.reshape(n, chunk, *C.shape[2:]), chunk=chunk)
    return y.reshape(b, s, *y.shape[2:]), st


def _scaled(f: float):
    def scan(x, dt, A, B, C, *, chunk: int = 128):
        y, st = KERNEL(x, dt, A, B, C, chunk=chunk)
        return y * f, st
    return scan


VARIANTS = [("kernel", KERNEL), ("plain scan", _plain),
            ("state dropped at chunk boundaries", _no_carry)] + [
    (f"y x {f:g}", _scaled(f)) for f in (0.0, 0.9, 0.98, 0.998, 0.9998)]


def measure(name: str, cfg, b: int, n: int, seed: int, max_len: int
            ) -> None:
    model = R.init_params(cfg, seed=0)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, n)).astype(np.int32), device="cuda")
    cache = R.make_cache(model, cfg, b, max_len, dtype=cfg.dtype)
    got, _ = chip_smoke._replay(model, prompts, cache)
    got = got.float()
    with torch.no_grad():
        base = model.logits(L.embedding_apply(
            model.embed, prompts[:, -1:]))[:, 0].float()
    for label, scan in VARIANTS:
        ops.ssd_chunked = scan
        try:
            ref = R.forward(model, {"tokens": prompts}, cfg)[0][:, -1]
        finally:
            ops.ssd_chunked = KERNEL
        ref = ref.float()
        if label == "kernel":
            part, kern = (ref - base).norm(), ref
        rel = ((got - ref).norm() / part).item()
        moved = ((ref - kern).norm() / part).item()
        print(f"{name} {str(cfg.dtype).replace('torch.', '')} {b} x {n}: "
              f"forward with {label}: replay reads {rel:.4g}; the forward "
              f"moves {moved:.4g} from the kernel's")
    del model
    torch.cuda.empty_cache()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_device_build()   # prints the card and its power limit
    for name, full, seeds in (("mamba2", mamba2_2_7b.FULL, (7, 8)),
                              ("zamba2", zamba2_2_7b.FULL, (13, 14))):
        # the caches of chip_smoke's checks: 128 + 32 new + 1, and 256 + 1
        measure(name, full, 4, 128, seeds[0], 161)
        measure(name, full.with_(
            dtype=torch.float32,
            n_layers=chip_smoke.F32_REPLAY_LAYERS[full.name]), 2, 256,
            seeds[1], 257)


if __name__ == "__main__":
    main()
