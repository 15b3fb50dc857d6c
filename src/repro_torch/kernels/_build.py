"""Build of the CUDA kernels and the checks their wrappers share.

The sources in ``csrc/`` are compiled on first use, for Hopper only
(``sm_90a``), by ``torch.utils.cpp_extension.load`` into
``build/repro_torch_ext/`` at the root of the checkout (a directory that
``.gitignore`` lists).  Only ``csrc/binding.cpp`` includes PyTorch's
headers; the ``.cu`` files expose plain C++ launchers.  Nothing is built
when this module is imported — the CPU tests import every module and never
reach a build.
"""
from __future__ import annotations

import os
import pathlib
import time
from typing import Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_ext"
SOURCES = ("binding.cpp", "paged_attention.cu", "flash_attention.cu")

# limits of csrc/attention_tile.cuh: kMaxRows query rows per CTA, dh <=
# 32 * kMaxDimsPerLane, positions taken kGroup at a time
MAX_ROWS = 8
MAX_HEAD_DIM = 128
GROUP = 4

_EXT = None
build_seconds: Optional[float] = None     # wall time of this process's build


def extension(verbose: bool = False):
    """The compiled extension, built on the first call in the process.
    ``verbose`` prints the build log, with ptxas's register and shared
    memory report of every kernel."""
    global _EXT, build_seconds
    if _EXT is None:
        from torch.utils.cpp_extension import load
        os.makedirs(BUILD_DIR, exist_ok=True)
        cuda_flags = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
        if verbose:
            cuda_flags.append("-Xptxas=-v")
        t0 = time.perf_counter()
        _EXT = load(name="repro_torch_ext",
                    sources=[str(CSRC / s) for s in SOURCES],
                    build_directory=str(BUILD_DIR),
                    extra_cflags=["-O2"], extra_cuda_cflags=cuda_flags,
                    verbose=verbose)
        build_seconds = time.perf_counter() - t0
    return _EXT


def check_inputs(name: str, q: torch.Tensor, k_arena: torch.Tensor,
                 v_arena: torch.Tensor, int_args: Sequence[torch.Tensor]
                 ) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous CUDA tensor
    on q's device, q and the arenas share a type the kernels take (f32 or
    bf16), the arenas are (n_blocks, bs, K, dh) with q's head dim, and the
    index arguments are int32."""
    tensors = (q, k_arena, v_arena, *int_args)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise ValueError(f"{name}: arenas must have q's dtype {q.dtype}")
    if any(t.dtype != torch.int32 for t in int_args):
        raise ValueError(f"{name}: tables, lengths and positions must be "
                         f"int32")
    if (k_arena.dim() != 4 or k_arena.shape != v_arena.shape
            or k_arena.shape[3] != q.shape[-1]):
        raise ValueError(f"{name}: arenas must both be (n_blocks, bs, K, "
                         f"{q.shape[-1]}), got {tuple(k_arena.shape)} and "
                         f"{tuple(v_arena.shape)}")
    H, K, bs, dh = q.shape[-2], k_arena.shape[2], k_arena.shape[1], \
        q.shape[-1]
    if H % K:
        raise ValueError(f"{name}: {H} query heads over {K} KV heads")
    if H // K > MAX_ROWS or dh > MAX_HEAD_DIM or bs % GROUP:
        raise ValueError(f"{name}: the kernel takes g <= {MAX_ROWS} query "
                         f"heads per KV head, dh <= {MAX_HEAD_DIM} and a "
                         f"block size divisible by {GROUP}; got g={H // K}, "
                         f"dh={dh}, block_size={bs}")
