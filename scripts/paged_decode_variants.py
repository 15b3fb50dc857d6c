#!/usr/bin/env python3
"""What bounds the split-KV paged decode kernel: the kernel built as it is
and with parts of it changed, timed at chip_smoke's paged-decode shapes.

    PYTHONPATH=src:. python3 scripts/paged_decode_variants.py

Needs one GPU and the CUDA toolkit's ``nvcc``.  It builds
``csrc/paged_attention.cu`` once per variant into
``build/paged_decode_variants/`` with ``nvcc``, each a shared library
with a plain C entry point loaded with ctypes (all at once), setting the
kernel's own compile-time knobs with ``-D``: as it is; without the scores,
softmax and P·V (``REPRO_DEC_COMPUTE=0``: only the staging, the partials
and the merge are left); with a ring of three or four stages in place of
two (``REPRO_DEC_STAGES``); with tiles of 32 positions in place of 16
(``REPRO_DEC_TILE``).  It prints each one's device time
(``chip_smoke._time_ms``) with its largest error against the plain
version, at batch 8 with lengths up to 2048 (chip_smoke's
headline) in f32 and bf16, batch 8 at 2048 and at 300 positions (the
serve's decode step), and batch 1 at 2048.  The variant without compute
gives wrong results by design; the others must agree with the plain
version.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import torch
from torch.utils.cpp_extension import CUDA_HOME

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "paged_decode_variants"
SHIM = r"""
#include "paged_attention.cu"
extern "C" __attribute__((visibility("default"))) int run_decode(
    int bf16, const void* q, const void* k, const void* v, const int* tables,
    const int* lengths, void* out, float* part, int* counters, int b, int H,
    int K, int dh, int bs, int n_pages, int min_pages, int n_split, int ctas,
    float sm_scale, void* stream) {
  return (int)repro_torch::launch_paged_decode(
      bf16, q, k, v, tables, lengths, out, part, counters, b, H, K, dh, bs,
      n_pages, min_pages, n_split, ctas, sm_scale, 0, (cudaStream_t)stream);
}
"""
# variant -> the kernel's compile-time settings (csrc/paged_attention.cu)
VARIANTS = {
    "as it is": {},
    "without compute": {"REPRO_DEC_COMPUTE": 0},
    "three stages": {"REPRO_DEC_STAGES": 3},
    "four stages": {"REPRO_DEC_STAGES": 4},
    "32-position tiles": {"REPRO_DEC_TILE": 32},
}


def build() -> dict:
    procs = {}
    for i, (name, defines) in enumerate(VARIANTS.items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "shim.cu").write_text(SHIM)
        procs[name] = (d, subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), "-O3",
             "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-shared",
             "-Xcompiler", "-fPIC,-fvisibility=hidden", f"-I{CSRC}",
             *(f"-D{k}={v}" for k, v in defines.items()), "-o",
             str(d / "lib.so"), str(d / "shim.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.run_decode.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                           ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as REF
    libs = build()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("b=8 lengths up to 2048", 8, f32, {}),
             ("b=8 lengths up to 2048", 8, bf16, {}),
             ("b=8 lengths 2048", 8, f32, dict(lengths=2048)),
             ("b=8 lengths 300", 8, f32, dict(lengths=300)),
             ("b=1 length 2048", 1, f32, {})]
    for label, b, dtype, shape in cases:
        args = chip_smoke._decode_case(b, dtype, seed=1, **shape)
        q, ka, va, tables, lengths = args
        H, dh, K, bs = q.shape[1], q.shape[2], ka.shape[2], ka.shape[1]
        n_split, min_pages, ctas = PA.split_plan(
            tables.shape[1], bs, b * K, _build.sm_count(q.device),
            PA.DECODE_CTAS_PER_SM[dtype])
        out = torch.empty_like(q)
        part = torch.empty(b * K * n_split * (H // K) * (dh + 2),
                           device="cuda")
        counters = _build.counters(q.device, b * K)
        ref = REF.paged_decode_attention_ref(*args).float()
        gb = 2 * int(lengths.sum()) * K * dh * q.element_size() / 1e9
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.run_decode(
                    int(dtype == bf16), *(t.data_ptr() for t in (
                        q, ka, va, tables, lengths, out, part, counters)),
                    b, H, K, dh, bs, tables.shape[1], min_pages, n_split,
                    ctas, dh ** -0.5, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{name}: launch failed ({rc})")
            ms = chip_smoke._time_ms(run, reps=100)
            err = (out.float() - ref).abs().max().item()
            print(f"{label} {str(dtype)[6:]}, {name}: {ms:.4f} ms, "
                  f"{gb / ms:.3f} TB/s of K/V, max |err| {err:.3g}",
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
