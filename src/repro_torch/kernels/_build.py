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
SOURCES = ("binding.cpp", "paged_attention.cu", "flash_attention.cu",
           "decode_attention.cu", "ssd_scan.cu")

# limits of csrc/attention_tile.cuh: kMaxRows query rows per CTA, dh <=
# 32 * kMaxDimsPerLane, positions taken kGroup at a time
MAX_ROWS = 8
MAX_HEAD_DIM = 128
GROUP = 4
# the contiguous flash kernel (csrc/flash_attention.cu): kFaRows query rows
# per CTA (4 warps of 16 in bf16), dims copied four at a time or more
FA_ROWS = 64
# limits of csrc/ssd_scan.cu: chunk and state width at most 128 (8 warps
# of 16-row tiles; 8 16-deep slices of N), P columns per CTA at most
# SSD_SLICE
SSD_MAX_CHUNK = 128
SSD_MAX_STATE = 128
SSD_SLICE = 64

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


def check_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, int_args: Sequence[torch.Tensor], *,
                 max_group: int = MAX_ROWS, page: int = GROUP) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous CUDA tensor
    on q's device, q, k and v share a type the kernels take (f32 or bf16),
    k and v are (n, positions, K, dh) with q's head dim, the index
    arguments are int32, the group g = H / K is at most ``max_group`` and
    dh at most 128; with ``page`` > 0 (a paged arena) the block size must
    be a multiple of it."""
    tensors = (q, k, v, *int_args)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: k and v must have q's dtype {q.dtype}")
    if any(t.dtype != torch.int32 for t in int_args):
        raise ValueError(f"{name}: tables, lengths and positions must be "
                         f"int32")
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != q.shape[-1]:
        raise ValueError(f"{name}: k and v must both be (n, positions, K, "
                         f"{q.shape[-1]}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    H, K, dh = q.shape[-2], k.shape[2], q.shape[-1]
    if H % K:
        raise ValueError(f"{name}: {H} query heads over {K} KV heads")
    if H // K > max_group or dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes g <= {max_group} query "
                         f"heads per KV head and dh <= {MAX_HEAD_DIM}; got "
                         f"g={H // K}, dh={dh}")
    if page and k.shape[1] % page:
        raise ValueError(f"{name}: the kernel takes a block size divisible "
                         f"by {page}; got {k.shape[1]}")
