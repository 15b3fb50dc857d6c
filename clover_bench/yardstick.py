"""The yardstick: the card's published peaks, and the operations and
bytes of the model's work and of the paged attention kernels, counted
from shapes and the window's own lengths (a token's projections are its
family's count, ``families/<family>.py``'s ``proj_flops``).

Peaks are NVIDIA's data sheet for the H100 SXM, dense rates, at its full
power limit of 700 W (the card's own limit is printed beside every
reading): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.  The
paged prefill kernel computes an f32 arena's products as three bf16
products (split bf16), so its operations bound is taken at 989 / 3.
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12
PEAK_F32_SPLIT = PEAK_BF16 / 3
HBM_BYTES_PER_S = 3.35e12


def attn_flops(model: Dict, n_layers: int, keys: float) -> float:
    """FLOPs of one query's attention over ``keys`` positions (q·k and
    p·v) in every layer."""
    return 4.0 * model["n_heads"] * model["d_head"] * keys * n_layers


def head_flops(model: Dict) -> float:
    """FLOPs of one row of logits over the published vocabulary."""
    return 2.0 * model["d_model"] * model["vocab_size"]


def decode_flops(model: Dict, n_layers: int, keys: float,
                 proj: float) -> float:
    """One decode token that attends over ``keys`` positions; ``proj`` is
    one token's FLOPs through the projections (the family's
    ``proj_flops``)."""
    return proj + attn_flops(model, n_layers, keys) + head_flops(model)


def causal_keys(n_past: int, n: int) -> float:
    """Σ over ``n`` queries at positions n_past .. n_past + n - 1 of the
    positions each sees: n·n_past + n(n + 1)/2."""
    return n * n_past + n * (n + 1) / 2.0


def prefill_flops(model: Dict, n_layers: int, n_past: int, n: int,
                  last: bool, proj: float) -> float:
    """A chunk of ``n`` prompt tokens after ``n_past`` cached ones; the
    chunk that ends the prompt adds one row of logits."""
    return proj * n \
        + attn_flops(model, n_layers, causal_keys(n_past, n)) \
        + (head_flops(model) if last else 0.0)


def paged_decode_bytes(model: Dict, keys_sum: float, rows: int,
                       kv_bytes: int) -> float:
    """Bytes one paged decode launch (one layer) needs: each row's K and V
    at its length (``keys_sum`` positions over the rows), its query read
    and its output written."""
    K, H, dh = model["n_kv_heads"], model["n_heads"], model["d_head"]
    return keys_sum * 2 * K * dh * kv_bytes + rows * 2 * H * dh * kv_bytes


def paged_prefill_bound_s(model: Dict, n_past: int, n: int,
                          kv_bytes: int) -> float:
    """The least time of one paged prefill launch (one layer) for ``n``
    queries after ``n_past`` positions: the larger of its operations at
    the split-bf16 peak (f32 K/V; bf16 K/V: the bf16 peak) and its bytes
    (K and V of every visible position, the queries read and the output
    written) at the HBM rate."""
    K, H, dh = model["n_kv_heads"], model["n_heads"], model["d_head"]
    ops = 4.0 * H * dh * causal_keys(n_past, n)
    byts = (n_past + n) * 2 * K * dh * kv_bytes + n * 2 * H * dh * kv_bytes
    peak = PEAK_F32_SPLIT if kv_bytes == 4 else PEAK_BF16
    return max(ops / peak, byts / HBM_BYTES_PER_S)
