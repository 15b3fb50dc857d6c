#!/usr/bin/env python3
"""Device times of the port's four attention kernels at chip_smoke's
headline shapes, for the source tree given — to compare two versions of
the kernels on one card in one call.

    PYTHONPATH=src:. python3 scripts/attention_times.py [--src DIR] [--label L]
        [--dense]

Needs one GPU.  ``--src`` is the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's); its kernels build into that tree's own
``build/repro_torch_ext/``.  ``--dense`` adds the decodes at the dense
family's widths (``chip_smoke.DENSE_ATTN``: gemma3 with its window of 1024
and without, glm4's group of 16; kernels that take ``window``).  The inputs are chip_smoke's (``_decode_case``,
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
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as CS          # its kernel imports are inside functions
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("attention_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
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
    windows = {}
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
    ms = {}
    for name, (kernel, make) in cases.items():
        inputs = make()
        kw = {"window": windows[name]} if name in windows else {}
        ms[name] = CS._time_ms(lambda: kernel(*inputs, **kw))
        del inputs
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
