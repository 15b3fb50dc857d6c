#!/usr/bin/env python3
"""Device times of the SSD scan's backward (``ssd_chunked_bwd``) at
chip_smoke's ``SSD_BWD_CASES``, f32 and bf16, for the source tree given —
to compare two versions of the kernel on one card in one call.

    PYTHONPATH=src:. python3 scripts/ssd_bwd_times.py [--src DIR] [--label L]
        [--profile] [--max-heads N]

Needs one GPU.  ``--src`` is the ``src`` directory whose ``repro_torch`` is
timed (default: this checkout's); its kernels build into that tree's own
``build/repro_torch_ext/``.  The inputs are phase 17a's (``_ssd_case`` and
its seeded dy, x, B and C rounded for bf16), the chunk states from the same
tree's forward; each case is timed by ``chip_smoke._time_ms`` behind a
device spin.  ``--profile`` adds each case's device time by CUDA kernel
(``torch.profiler``); ``--max-heads`` caps the heads the planner gives
a chunk-pass CTA (``SSD_BWD_MAX_HEADS``) for the run (trees that have the
planner).  It prints one line ``{"label": ..., "device": ..., "ms":
{case: ms}, "hb": {case: heads a chunk-pass CTA}}``.  Run it for two trees
in turns (A, B, B, A) in one call and compare each case within the call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--max-heads", type=int)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as CS          # its kernel imports are inside functions
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from attention_times import _device_ms_by_kernel
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SSD
    plan = getattr(SSD, "ssd_bwd_plan", None)
    if args.max_heads is not None and plan is not None:
        SSD.SSD_BWD_MAX_HEADS = args.max_heads
    ms, heads, profiles = {}, {}, {}
    for i, (model, b, s) in enumerate(CS.SSD_BWD_CASES):
        chunk = CS.SSD_SHAPES[model]["chunk"]
        for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            name = f"bwd {model} {b} x {s} {dn}"
            x32 = CS._ssd_case(model, b, s, torch.float32, seed=300 + i)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(400 + i)
            dy = torch.randn(x32[0].shape, device="cuda", generator=gen)
            inputs = tuple(t.to(dtype) if j in (0, 3, 4) else t
                           for j, t in enumerate(x32))
            _, _, states = SSD.ssd_chunked(*inputs, chunk=chunk,
                                           return_states=True)
            x, B = inputs[0], inputs[3]
            if plan is not None:
                heads[name] = plan(b, s, x.shape[2], B.shape[2], chunk,
                                   _build.sm_count(x.device))

            def run():
                return SSD.ssd_chunked_bwd(*inputs, states, dy, chunk=chunk)
            ms[name] = CS._time_ms(run, reps=10, warmup=2)
            if args.profile:
                profiles[name] = _device_ms_by_kernel(run)
            del x32, dy, inputs, states, x, B
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0), "ms": ms,
                      **({"hb": heads} if heads else {}),
                      **({"kernels_ms": profiles} if args.profile else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
