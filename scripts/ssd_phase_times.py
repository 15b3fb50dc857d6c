#!/usr/bin/env python3
"""Where the SSD scan kernel's time goes: the kernel built once as it is
and once with each of its phases cut out, timed at the SSM forward's
shapes.

    PYTHONPATH=src python3 scripts/ssd_phase_times.py

Needs one GPU and the CUDA toolkit's ``nvcc``.  It copies
``csrc/ssd_scan.cu`` into ``build/ssd_phases/`` five times — as it is, and with P4 (C . state^T),
P1 + P3 (the within-chunk products), P5 (the state update) or the staging
of every chunk after the first removed by a text patch — builds each with
``nvcc`` into a shared library (all at once, a plain C entry point loaded
with ctypes), and prints each one's time by CUDA events at mamba2's widths
in bf16 (4 x 4096, the 64-column slices ``p_slice`` picks there, and 1 x
32768 with 64- and 32-column slices), with its largest error against the
plain version: a variant's time less the whole kernel's is what that
phase costs on the chunk loop's path.  The variants compute wrong results
by design; only the first is held to the plain version.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.utils.cpp_extension import CUDA_HOME

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_phases"
SHIM = r"""
#include "kernels.h"
extern "C" int run_ssd(int bf16, const void* x, const float* dt,
                       const float* A, const void* B, const void* C, float* y,
                       float* st, int b, int s, int H, int P, int G, int N,
                       int chunk, int ps, void* stream) {
  return (int)repro_torch::launch_ssd(bf16, x, dt, A, B, C, y, st, nullptr, b,
                                      s, H, P, G, N, chunk, ps,
                                      (cudaStream_t)stream);
}
"""
# variant -> (text in ssd_scan.cu, its replacement)
VARIANTS = {
    "whole kernel": None,
    "without P4": ("      if (t0 > 0) {\n        const float e_lo",
                   "      if (false) {\n        const float e_lo"),
    "without P1 + P3": ("for (int jt = 0; jt <= it; ++jt) {",
                        "for (int jt = 0; jt < 0; ++jt) {"),
    "without P5": ("for (int kt = 0; kt < NI; ++kt) {",
                   "for (int kt = 0; kt < 0; ++kt) {"),
    "without staging": ("    if (!last) {\n      stage(t0 + c);",
                        "    if (!last) {\n      if (t0 < 0) stage(t0 + c);"),
}


def build() -> dict:
    src = (CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for i, (name, patch) in enumerate(VARIANTS.items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        if patch is not None:
            if patch[0] not in src:
                raise SystemExit(f"{name}: the patch no longer matches "
                                 f"ssd_scan.cu")
        (d / "ssd_scan.cu").write_text(
            src if patch is None else src.replace(*patch))
        (d / "shim.cu").write_text(SHIM)
        procs[name] = (d, subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), "-O3",
             "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", f"-I{CSRC}",
             "-o", str(d / "lib.so"), str(d / "ssd_scan.cu"),
             str(d / "shim.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.run_ssd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        if fn():
            raise SystemExit("launch failed")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phase_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref as REF
    libs = build()
    H, P, N, chunk = 80, 64, 128, 128
    for b, s, slices in ((4, 4096, (64,)), (1, 32768, (64, 32))):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)

        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)
        x = rnd(b, s, H, P).bfloat16()
        dt = F.softplus(rnd(b, s, H))
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        B, C = rnd(b, s, 1, N).bfloat16(), rnd(b, s, 1, N).bfloat16()
        y_ref, _ = REF.ssd_chunked_ref(x, dt, A, B, C, chunk)
        y = torch.empty(b, s, H, P, device="cuda")
        st = torch.empty(b, H, P, N, device="cuda")
        for ps in slices:
            for name, lib in libs.items():
                def run(lib=lib, ps=ps):
                    return lib.run_ssd(
                        1, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr(), y.data_ptr(),
                        st.data_ptr(), b, s, H, P, 1, N, chunk, ps,
                        torch.cuda.current_stream().cuda_stream)
                ms = time_ms(run)
                err = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
                print(f"{b} x {s}, {ps}-column slices, {name}: {ms:.4f} ms "
                      f"(max |y err| {err:.3g} of max |y|)", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
