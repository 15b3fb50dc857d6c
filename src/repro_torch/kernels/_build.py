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

import functools
import os
import pathlib
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_ext"
SOURCES = ("binding.cpp", "paged_attention.cu", "paged_prefill.cu",
           "flash_attention.cu", "flash_backward.cu", "decode_attention.cu",
           "ssd_scan.cu", "ssd_backward.cu")

# limits of the split-KV decode body (csrc/decode_split.cuh, the paged and
# the contiguous decode): up to 8 query rows per CTA (kDecMaxRows: a group
# of g heads runs as cdiv(g, 8) row-chunks), groups of up to 16 heads,
# dh <= 128
MAX_ROWS = 8
MAX_DECODE_GROUP = 16
MAX_HEAD_DIM = 128
# the contiguous flash kernel (csrc/flash_attention.cu) and the paged
# prefill kernel (csrc/paged_prefill.cu): kFaRows / kPfRows query rows per
# CTA (4 warps of 16 on the tensor cores)
FA_ROWS = 64
# limits of csrc/ssd_scan.cu: chunk and state width at most 128 (8 warps
# of 16-row tiles; 8 16-deep slices of N), P columns per CTA at most
# SSD_SLICE
SSD_MAX_CHUNK = 128
SSD_MAX_STATE = 128
SSD_SLICE = 64

_EXT = None
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
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


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (the split-KV kernels' plan)."""
    return _sm_count(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def counters(device: torch.device, n: int) -> torch.Tensor:
    """The split-KV decode kernels' arrival counters for a launch on
    ``device``'s current stream: at least ``n`` int32 zeros.  One buffer
    per stream, allocated once (grown when a launch needs more): every
    launch leaves its counters at zero again and launches on one stream
    run in order, while launches on two streams may overlap and must not
    share them."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def on_one_cuda_device(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless every tensor lies on the first one's
    CUDA device."""
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")


def check_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, int_args: Sequence[torch.Tensor], *,
                 max_group: int = MAX_DECODE_GROUP,
                 vec16: bool = False) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous CUDA tensor
    on q's device, q, k and v share a type the kernels take (f32 or bf16),
    k and v are (n, positions, K, dh) with q's head dim, the index
    arguments are int32, the group g = H / K is at most ``max_group`` and
    dh at most 128; with ``vec16`` (kernels that copy 16 bytes at a time)
    dh must be a multiple of 8 and q, k and v 16-byte aligned."""
    tensors = (q, k, v, *int_args)
    on_one_cuda_device(name, tensors)
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
    if vec16 and (dh % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"{name}: the kernel takes dh divisible by 8 and "
                         f"16-byte aligned tensors; got dh={dh}")
