#!/usr/bin/env python3
"""The losses of the SSM and hybrid full-width training steps at several
learning rates: the evidence behind ``chip_smoke.TRAIN_SSM_OPT``.

    PYTHONPATH=src:. python3 scripts/train_lr_sensitivity.py

Needs one GPU (~3 min with the build).  For zamba2-2.7b at 1e-3, 3e-4,
1e-4 and 3e-5, and mamba2-2.7b at 1e-4, each at full width in f32 from
the weights of seed 0, it runs 8 AdamW steps (``chip_smoke.TRAIN_OPT``'s
warmup and schedule at that lr) of 4 x 1024 tokens of the synthetic
stream, through the scan's and the attention's backward kernels, and
prints each step's loss and the mean wall time of a step.
"""
from __future__ import annotations

import time

import torch

import chip_smoke
from repro_torch.configs import get_config
from repro_torch.models import registry as R
from repro_torch.train import optimizer as O
from repro_torch.train import train_loop as TL

RUNS = (("zamba2-2.7b", (1e-3, 3e-4, 1e-4, 3e-5)), ("mamba2-2.7b", (1e-4,)))
STEPS = 8


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_device_build()
    for arch, lrs in RUNS:
        cfg = get_config(arch).with_(dtype=torch.float32)
        batches = [chip_smoke._train_batch(cfg, chip_smoke.TRAIN_FULL_BATCH,
                                           chip_smoke.TRAIN_FULL_SEQ, i,
                                           "cuda") for i in range(STEPS)]
        for lr in lrs:
            opt = O.AdamWConfig(**dict(chip_smoke.TRAIN_OPT, lr=lr))
            state = TL.make_train_state(R.init_params(cfg, seed=0), opt)
            step = TL.make_train_step(cfg, opt)
            losses = []
            t = time.perf_counter()
            for batch in batches:
                state, m = step(state, batch)
                losses.append(round(m["loss"].item(), 4))
            ms = (time.perf_counter() - t) / STEPS * 1e3
            print(f"{arch} lr {lr:g}: losses {losses} ({ms:.0f} ms a step)",
                  flush=True)
            del state, step
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
