#!/usr/bin/env python3
"""Wall and device time of qwen3-1.7b's full-width f32 training step —
chip_smoke's phase 17c: 4 x 1024 tokens of the synthetic stream, full
activation checkpointing, AdamW — for the source tree given, to compare two
versions of the port on one card in one call.

    PYTHONPATH=src:. python3 scripts/train_step_times.py [--src DIR]
        [--label L] [--steps N]

Needs one GPU.  ``--src`` is the ``src`` directory whose ``repro_torch`` is
timed (default: this checkout's); its kernels build into that tree's own
``build/repro_torch_ext/``.  The model, its optimizer and the batches are
chip_smoke's (``TRAIN_OPT``, ``_train_batch``, weights from seed 0).  One
warm-up step, then ``--steps`` timed steps (each waits for its loss), then
one step under ``torch.profiler``: the device's busy time (every device
event once) and the flash backward's kernels' share of it.  Prints one line
``{"label": ..., "device": ..., "steps_ms": [...], "ms": mean, "busy_ms":
..., "flash_bwd_ms": ...}``.  Run it for two trees in turns (A, B, B, A)
in one call and compare within the call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as CS          # its port imports are inside functions
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL
    cfg = get_config("qwen3-1.7b").with_(dtype=torch.float32)
    opt = O.AdamWConfig(**CS.TRAIN_OPT)
    state = TL.make_train_state(R.init_params(cfg, seed=0), opt)
    step = TL.make_train_step(cfg, opt)
    b, s = CS.TRAIN_FULL_BATCH, CS.TRAIN_FULL_SEQ
    batches = [CS._train_batch(cfg, b, s, i, "cuda")
               for i in range(args.steps + 2)]
    walls = []
    for i, batch in enumerate(batches[:-1]):
        t = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()                            # waits for the step
        if i:                                       # the first warms up
            walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batches[-1])
        m["loss"].item()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    bwd = sum(e.self_device_time_total for e in dev
              if "flash_bwd" in e.key) / 1e3
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0),
                      "steps_ms": [round(w, 1) for w in walls],
                      "ms": sum(walls) / len(walls), "busy_ms": busy,
                      "flash_bwd_ms": bwd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
