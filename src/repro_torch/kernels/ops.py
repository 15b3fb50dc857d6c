"""Dispatch of the kernels (attention and the SSD scan) by where the
tensors lie.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor goes to the hand-written Hopper kernel, whose wrapper raises on
anything it does not take.  There is no fallback from the kernel to the
plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd


def _on_cuda(name: str, q: torch.Tensor) -> bool:
    if q.is_cuda:
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{q.device}")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Contiguous prefill attention: q (b, sq, H, dh) against k, v (b, skv,
    K, dh), causal on positions from 0, sliding window when window > 0.
    Differentiable: on CUDA through ``FlashAttentionFn`` (the backward
    kernel) when grad is enabled and an input requires it; on the CPU by
    autograd through the plain version."""
    if _on_cuda("flash_attention", q):
        if _needs_grad(q, k, v):
            return _fa.FlashAttentionFn.apply(q, k, v, causal, window,
                                              sm_scale)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   sm_scale=sm_scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    sm_scale=sm_scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     sm_scale: Optional[float] = None,
                     window: int = 0) -> torch.Tensor:
    """Contiguous flash-decode: q (b, H, dh) over caches (b, S, K, dh) for
    the first lengths[i] >= 1 positions of each row (lengths () or (b,)),
    the last ``window`` of them when window > 0."""
    if _on_cuda("decode_attention", q):
        return _dec.decode_attention(q, k_cache, v_cache, lengths,
                                     sm_scale=sm_scale, window=window)
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                     sm_scale=sm_scale, window=window)


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None,
                           window: int = 0) -> torch.Tensor:
    """Paged flash-decode: q (b, H, dh) over arenas (n_blocks, bs, K, dh)
    through block_tables (b, n_pages) for the first lengths[i] >= 1
    positions of each row, the last ``window`` of them when window > 0."""
    if _on_cuda("paged_decode_attention", q):
        return _paged.paged_decode_attention(q, k_arena, v_arena,
                                             block_tables, lengths,
                                             sm_scale=sm_scale,
                                             window=window)
    return _ref.paged_decode_attention_ref(q, k_arena, v_arena, block_tables,
                                           lengths, sm_scale=sm_scale,
                                           window=window)


def paged_prefill_attention(q: torch.Tensor, k_arena: torch.Tensor,
                            v_arena: torch.Tensor, table: torch.Tensor,
                            positions: torch.Tensor, *,
                            sm_scale: Optional[float] = None,
                            window: int = 0) -> torch.Tensor:
    """Paged chunked-prefill attention: q (C, H, dh) at absolute positions
    (C,) over the arenas through table (span,), causal, within ``window``
    positions when window > 0."""
    if _on_cuda("paged_prefill_attention", q):
        return _fa.paged_prefill_attention(q, k_arena, v_arena, table,
                                           positions, sm_scale=sm_scale,
                                           window=window)
    return _ref.paged_prefill_attention_ref(q, k_arena, v_arena, table,
                                            positions, sm_scale=sm_scale,
                                            window=window)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan: x (b, s, H, P), dt (b, s, H) f32, A (H,)
    f32, B, C (b, s, G, N), s a multiple of chunk -> (y (b, s, H, P) f32,
    final state (b, H, P, N) f32).  Differentiable: on CUDA through
    ``SsdChunkedFn`` (the backward kernels) when grad is enabled and an
    input requires it; on the CPU by autograd through the plain
    version."""
    if _on_cuda("ssd_chunked", x):
        if _needs_grad(x, dt, A, B, C):
            return _ssd.SsdChunkedFn.apply(x, dt, A, B, C, chunk)
        return _ssd.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    return _ref.ssd_chunked_ref(x, dt, A, B, C, chunk)
