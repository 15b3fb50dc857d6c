#!/usr/bin/env python3
"""Device times of the port's four attention kernels at chip_smoke's
headline shapes, for the source tree given — to compare two versions of
the kernels on one card in one call.

    PYTHONPATH=src:. python3 scripts/attention_times.py [--src DIR] [--label L]
        [--dense | --bwd [--min-split-items N]] [--profile]

Needs one GPU.  ``--src`` is the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's); its kernels build into that tree's own
``build/repro_torch_ext/``.  ``--dense`` adds the decodes at the dense
family's widths (``chip_smoke.DENSE_ATTN``: gemma3 with its window of 1024
and without, glm4's group of 16; kernels that take ``window``).  ``--bwd``
times the flash backward (``flash_attention_bwd``) alone, f32 and bf16, at
``chip_smoke.BWD_CASES`` and, f32, at a rank's ``TP_FLASH``, on phase
17a's and 20c's seeded inputs, its ``out`` and ``lse`` from the same tree's
forward, with each case's dK/dV split count (``bwd_split_plan``);
``--min-split-items`` sets the planner's ``BWD_MIN_SPLIT_ITEMS`` for the
run.  ``--profile`` adds each case's device time by CUDA kernel
(``torch.profiler``).  The inputs are chip_smoke's (``_decode_case``,
``_prefill_case``, ``_contig_decode_case``, ``_flash_case``, seeded, made
once per case) and each kernel is timed by ``chip_smoke._time_ms`` behind
a device spin.  It prints one line ``{"label": ..., "device": ..., "ms":
{case: ms}}``.  Run it for two trees in turns (A, B, B, A) in one call and
compare each case within the call.
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
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--dense", action="store_true")
    which.add_argument("--bwd", action="store_true")
    ap.add_argument("--min-split-items", type=int)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as CS          # its kernel imports are inside functions
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("attention_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    f32, bf16 = torch.float32, torch.bfloat16
    z2 = dict(CS.ZAMBA2_ATTN, S=160, lengths=160)
    # case -> (kernel, its inputs' maker)
    cases = {
        "paged_decode b=8 f32": (PA.paged_decode_attention,
                                 lambda: CS._decode_case(8, f32, seed=1)),
        "paged_decode b=8 x 300 f32": (
            PA.paged_decode_attention,
            lambda: CS._decode_case(8, f32, seed=1, lengths=300)),
        "paged_decode b=8 bf16": (PA.paged_decode_attention,
                                  lambda: CS._decode_case(8, bf16, seed=1)),
        "paged_decode b=8 x 300 bf16": (
            PA.paged_decode_attention,
            lambda: CS._decode_case(8, bf16, seed=1, lengths=300)),
        "paged_prefill n_past=992 f32": (
            FA.paged_prefill_attention,
            lambda: CS._prefill_case(992, f32, seed=2)),
        "paged_prefill n_past=992 bf16": (
            FA.paged_prefill_attention,
            lambda: CS._prefill_case(992, bf16, seed=2)),
        "decode b=8 f32": (DA.decode_attention,
                           lambda: CS._contig_decode_case(8, f32, seed=3)),
        "decode b=8 bf16": (DA.decode_attention,
                            lambda: CS._contig_decode_case(8, bf16, seed=3)),
        "decode zamba2 4 x 160 f32": (
            DA.decode_attention,
            lambda: CS._contig_decode_case(4, f32, seed=4, **z2)),
        "decode zamba2 4 x 160 bf16": (
            DA.decode_attention,
            lambda: CS._contig_decode_case(4, bf16, seed=4, **z2)),
        "flash 1024 f32": (FA.flash_attention,
                           lambda: CS._flash_case(1024, f32, seed=5)),
        "flash 1024 bf16": (FA.flash_attention,
                            lambda: CS._flash_case(1024, bf16, seed=5)),
        "flash zamba2 4 x 4096 f32": (
            FA.flash_attention,
            lambda: CS._flash_case(4096, f32, seed=6, b=4,
                                   **CS.ZAMBA2_ATTN)),
        "flash zamba2 4 x 4096 bf16": (
            FA.flash_attention,
            lambda: CS._flash_case(4096, bf16, seed=6, b=4,
                                   **CS.ZAMBA2_ATTN)),
    }
    windows, splits = {}, {}
    if args.bwd:
        cases = _bwd_cases(CS, FA)
        if args.min_split_items is not None:    # read at each plan
            PA.BWD_MIN_SPLIT_ITEMS = args.min_split_items
            PA.bwd_split_plan.cache_clear()
    if args.dense:
        for m, w in (("gemma3", 1024), ("gemma3", 0), ("glm4", 0)):
            shape = dict(CS.DENSE_ATTN[m], lengths=CS.DENSE_LENGTHS)
            for d in (f32, bf16):
                dn = "f32" if d == f32 else "bf16"
                for kind, kernel, case in (
                        ("paged_decode", PA.paged_decode_attention,
                         CS._decode_case),
                        ("decode", DA.decode_attention,
                         CS._contig_decode_case)):
                    name = f"{kind} {m} window={w} {dn}"
                    cases[name] = (kernel, lambda c=case, d=d, s=shape:
                                   c(8, d, seed=7, **s))
                    windows[name] = w
    ms, profiles = {}, {}
    for name, (kernel, make) in cases.items():
        inputs = make()
        kw = {"window": windows[name]} if name in windows else {}
        if args.bwd:
            inputs, kw = inputs
            q, k = inputs[:2]
            if hasattr(PA, "bwd_split_plan"):   # trees before it: no splits
                splits[name] = PA.bwd_split_plan(
                    q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    k.shape[2], _build.sm_count(q.device),
                    PA.BWD_CTAS_PER_SM[q.dtype])
            del q, k
            ms[name] = CS._time_ms(lambda: kernel(*inputs, **kw), reps=10,
                                   warmup=2)
        else:
            ms[name] = CS._time_ms(lambda: kernel(*inputs, **kw))
        if args.profile:
            profiles[name] = _device_ms_by_kernel(lambda: kernel(*inputs,
                                                                 **kw))
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0), "ms": ms,
                      **({"n_split": splits} if splits else {}),
                      **({"kernels_ms": profiles} if args.profile else {})}))
    return 0


def _device_ms_by_kernel(fn, reps: int = 5) -> dict:
    """Device time of one call by CUDA kernel name (torch.profiler's
    events over ``reps`` calls, divided by ``reps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0:
            name = (e.key.replace("(anonymous namespace)::", "")
                    .split("(")[0].replace("repro_torch::", ""))
            out[name] = round(out.get(name, 0.0) + t / 1e3 / reps, 5)
    return out


def _bwd_cases(CS, FA) -> dict:
    """case -> (flash_attention_bwd, maker of ((q, k, v, out, lse, dO),
    flags)): phase 17a's BWD_CASES in f32 and bf16, phase 20c's rank
    shape in f32."""
    import torch

    def make(sq, dtype, seeds, b, skv, shape, causal, window):
        def inputs():
            x = CS._flash_case(sq, torch.float32, seed=seeds[0], b=b,
                               skv=skv, **shape)
            torch.manual_seed(seeds[1])
            x += (torch.randn_like(x[0]),)
            q, k, v, do = (t.to(dtype) for t in x)
            kw = dict(causal=causal, window=window)
            out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
            return (q, k, v, out, lse, do), kw
        return inputs

    cases = {}
    for i, (model, b, sq, skv, causal, window) in enumerate(CS.BWD_CASES):
        for dtype, dn in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            name = (f"bwd {model} {b} x {sq}{f' over {skv}' if skv else ''}"
                    f"{' causal' if causal else ''}"
                    f"{f' window={window}' if window else ''} {dn}")
            cases[name] = (FA.flash_attention_bwd,
                           make(sq, dtype, (100 + i, 200 + i), b, skv,
                                CS.TRAIN_ATTN[model], causal, window))
    tp = CS.TP_FLASH
    cases[f"bwd rank {tp['b']} x {tp['sq']} causal f32"] = (
        FA.flash_attention_bwd,
        make(tp["sq"], torch.float32, (70, 71), tp["b"], 0,
             dict(K=tp["K"], g=tp["g"], dh=tp["dh"]), True, 0))
    return cases


if __name__ == "__main__":
    sys.exit(main())
