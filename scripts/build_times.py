#!/usr/bin/env python3
"""Compile times of the extension's sources (``repro_torch/kernels/csrc``),
each source on its own, all started together as the extension's build
starts them — to see which source sets the build's wall time, and to
compare two trees' sources on one host in one call.

    python3 scripts/build_times.py [--src DIR] [--label L] [--jobs N]

Needs ``nvcc`` (the CUDA toolkit) and PyTorch's headers; no GPU.  ``--src``
is the ``src`` directory whose ``repro_torch/kernels/csrc`` is compiled
(default: this checkout's), every ``.cu`` and ``.cpp`` there with the
extension's flags (``_build.extension``: nvcc ``-O3`` for ``sm_90a``, the
host compiler ``-O2`` for ``binding.cpp``) into a temporary directory;
``--jobs`` caps how many compile at once (default: all).  It prints one
line ``{"label": ..., "wall_s": s, "s": {source: s}}``: each source's
seconds from the batch's start to its end, and the batch's.  Run two trees in turns (A, B, B, A)
and compare within the call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import sysconfig
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _commands(csrc: str, out: str) -> dict:
    from torch.utils import cpp_extension
    try:
        paths = cpp_extension.include_paths(device_type="cuda")
    except TypeError:                     # PyTorch before 2.6
        paths = cpp_extension.include_paths(cuda=True)
    inc = [a for p in paths + [sysconfig.get_paths()["include"]]
           for a in ("-isystem", p)]
    defs = ["-DTORCH_EXTENSION_NAME=repro_torch_ext",
            "-DTORCH_API_INCLUDE_EXTENSION_H", "-std=c++17"]
    nvcc = os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin",
                        "nvcc")
    cmds = {}
    for name in sorted(os.listdir(csrc)):
        src, obj = os.path.join(csrc, name), os.path.join(out, name + ".o")
        if name.endswith(".cu"):
            cmds[name] = ([nvcc] + defs + inc
                          + ["--expt-relaxed-constexpr", "--compiler-options",
                             "-fPIC", "-O3",
                             "-gencode=arch=compute_90a,code=sm_90a", "-c",
                             src, "-o", obj])
        elif name.endswith(".cpp"):
            cmds[name] = (["c++"] + defs + inc
                          + ["-fPIC", "-O2", "-c", src, "-o", obj])
    return cmds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--jobs", type=int, default=0)
    args = ap.parse_args()
    csrc = os.path.join(os.path.abspath(args.src), "repro_torch", "kernels",
                        "csrc")
    with tempfile.TemporaryDirectory() as out:
        todo = list(_commands(csrc, out).items())
        jobs = args.jobs or len(todo)
        running, seconds = {}, {}
        t0 = time.perf_counter()
        while todo or running:
            while todo and len(running) < jobs:
                name, cmd = todo.pop(0)
                log = open(os.path.join(out, name + ".log"), "w+")
                running[name] = (subprocess.Popen(
                    cmd, cwd=csrc, stdout=log, stderr=log), log)
            for name, (proc, log) in list(running.items()):
                if proc.poll() is None:
                    continue
                del running[name]
                seconds[name] = time.perf_counter() - t0
                log.seek(0)
                text = log.read()
                log.close()
                if proc.returncode:
                    for p, _ in running.values():
                        p.kill()
                        p.wait()
                    print(text[-4000:], file=sys.stderr)
                    print(f"build_times: {name} failed", file=sys.stderr)
                    return 1
            time.sleep(0.05)
        wall = time.perf_counter() - t0
    print(json.dumps({"label": args.label, "wall_s": round(wall, 2),
                      "s": {k: round(v, 2) for k, v in seconds.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
