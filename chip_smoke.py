#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result lines:

1. device and build — the card's name and power limit (``nvidia-smi``) and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels against their plain PyTorch versions on the card, at the shapes
   of the serving paths (8 KV heads, g = 2, dh = 128): paged decode at
   batch 1 and 8 with lengths up to 2048, at the serve's step (8 rows of
   300 positions over 128-page tables) and with rows of 1-40 positions
   (trailing splits empty), and chunked prefill of 32 tokens at n_past 0,
   224 and 992, ragged last chunks and a 256-token window (block 16), in
   f32 (the engine's arena) and bf16; contiguous decode at batch 1 and 8
   over a 2048-position cache, over S = 2040 (a ragged last page), with a
   row of length 0 and lengths above S, with one () length shared by
   every row, and with rows of 1-40 positions, f32 and bf16; contiguous
   causal prefill at 64, 128, 256, 1000 and 1024 tokens, and one with a
   sliding window, f32 and bf16; the two contiguous kernels at zamba2's
   shapes (32 heads of 80, g = 1: prefill of 4 x 4096 tokens, decode at
   batch 4 over 160 positions) and the prefill at zamba2 SMOKE's widths
   (4 heads of 16); and the SSD scan at mamba2's and zamba2's full
   widths, f32 and bf16, batch 1-4, 2048 and 4096 positions, and mamba2
   at 1 x 32768 (32-column P slices); and the dense family's shapes
   (``DENSE_ATTN``): both decodes at batch 8 over rows of 1-2048
   positions at gemma3-27b's widths (32 heads of 128 over 16 KV heads)
   with its window of 1024 and without, at glm4-9b's (32 over 2: a group
   of 16 rows, two row-chunks) with and without a window, at qwen2-0.5b's
   (14 heads of 64 over 2), and the paged prefill of a 128-token chunk at
   n_past 1280 and the contiguous flash over 1400 tokens at those widths,
   f32 and bf16; and the same four cases at the MoE family's widths
   (``MOE_ATTN``: qwen3-moe-30b-a3b's 32 heads of 128 over 4 KV heads,
   qwen2-moe-a2.7b's 16 over 16).  Each case prints its time, the
   plain version's, one ``scaled_dot_product_attention`` call as a
   yardstick (none computes the scan), and the least time the card could
   take (for f32 work multiplied as split bf16, also at the CUDA cores'
   f32 peak);
3. the paged engine serving 8 requests of 24 new tokens at the full width
   of qwen3-1.7b (28 layers, bf16 random weights from a seed), with both
   paged kernels counted; then the profiles of one fused 8-step decode dispatch and of
   one prefill chunk at n_past 992;
4. the slotted engine (the default layout) serving the same 8 requests at
   full width with f32 weights (the layout serves f32 models only), with
   both contiguous kernels counted; then the profiles of one decode step
   and of one 1024-token prefill;
5. Clover's real-mode control loop (``repro_torch.launch.serve --mode
   real``) on the card: annealing over configuration graphs of the SMOKE
   ladder on measured latencies;
6. the paged and the slotted engines at SMOKE size on the card against the
   same engines on the CPU (plain versions), slotted against paged on the
   card, and a paged engine with preemption on a small arena (swap-outs and
   partial swap-ins) against the CPU and against the unpreempted paged
   engine on the card: the greedy token streams must be equal;
7. mamba2-2.7b at full width (bf16) through ``registry.forward`` (4 x
   4096 and 1 x 32768 tokens, the scan counted) and greedy decode through
   ``make_cache`` / ``decode_step``, whose replayed prompt is held against
   the forward; then the same replay check with f32 weights at half the
   depth (``F32_REPLAY_LAYERS``);
8. zamba2-2.7b at full width the same way (the scan and the contiguous
   flash attention counted in the forward, the contiguous decode in each
   step);
9. a paged serve with preemption, telemetry and quality selection at the
   full width of qwen3-1.7b (bf16): the ladder x0.5 / x1, one paged
   instance each on an arena small enough that each swaps out twice, 16
   requests of two SLO classes routed by a static selector; routing,
   preemptions, partial swap-in, joules in the responses, the trace and the
   carbon feed are checked, and the swap staging pair round-trips pages
   bit for bit;
10. mamba2 and zamba2 at SMOKE size on the card against the CPU: forward
   logits and greedy tokens;
11. Clover's fleet and trace simulator: (a) ``run_fleet`` with the real
   backend at the full width of qwen3-1.7b (the ladder x0.25 / x0.5 / x1
   in bf16, two regions over 2 h traces, 12 windows each, paged engines
   under the carbon-forecast policy and the greedy quality selector),
   reconfigured warm by each region's controller onto mixed ladders and
   probed every window, with more than one rung served, the selector's
   dirty-grid downshift taken and both paged kernels counted; (b) the same fleet at the reference's
   defaults (SMOKE, slotted, f32, fifo; one region, 1 h) on the card
   against the CPU with the same weights: equal configurations and
   per-rid token streams; (c) ``repro_torch.launch.serve --mode sim
   --hours 6``;
12. the rest of the dense family at full width, bf16: gemma3-27b (62
   layers, 52 of them local with a window of 1024) through the paged
   engine serving 4 requests of 1040-1400 prompt tokens (a shared
   256-token prefix) and 16 new, both paged kernels counted with their
   windowed launches; the profiles of one fused decode dispatch and one
   128-token prefill chunk; the chunked paged prefill of a 1400-token
   prompt held to ``registry.forward`` (the contiguous flash) within
   ``DENSE_PREFILL_TOL``, and the same with the local layers' window
   dropped rejected by it; then a short paged serve of glm4-9b and of
   qwen2-0.5b;
13. the dense family's SMOKE configs (and glm4's with a group of 16) on
   the card against the CPU: both engines' greedy streams, the forward
   and ``decode_step``'s greedy tokens;
14. the MoE family at full width, bf16: (a) qwen3-moe-30b-a3b (48 layers,
   128 experts top-8, 30.5 B params) through the paged engine serving 6
   requests of 300-1400 prompt tokens (a shared 256-token prefix) and 16
   new, 4 rows at a time (decode drop-free, prefill chunks dropping pairs),
   with the phase 12 checks, its peak memory and the profiles of one fused
   decode dispatch and one prefill chunk (the MoE pieces' and attention's
   shares of the device time, beside the step's weight-bytes bound); (b)
   its chunked paged prefill of a 1400-token prompt held to
   ``registry.forward`` at a drop-free capacity within
   ``MOE_PREFILL_TOL``, the same with unnormalised gates rejected, and the
   reading at the config's own capacity printed; (c) qwen2-moe-a2.7b (64
   padded experts, 4 shared, g = 1) through the paged engine with decode
   groups of 8 rows (C = 4); (d) both SMOKE configs and qwen3-moe SMOKE
   with top-1 routing (decode rows compete) on the card against the CPU,
   strictly: both engines' streams, the forward's logits and aux, and
   ``decode_step``'s greedy tokens;
15. prefill/decode disaggregation (``RealEngine(kv_layout="paged",
   roles=(1, 1))``, ``serving.disagg``): (a) qwen3-1.7b at full width with
   f32 weights serving 16 requests of 200-1000 tokens (half sharing a
   256-token preamble) through one prefill and one decode worker, every
   stream equal to a monolithic paged engine's, 16 handoffs, the role
   joules conserved; (b) the same in bf16 on a starved arena, preempting
   on the decode worker after the handoffs; (c) the SMOKE config
   disaggregated on the card against the CPU, strictly;
16. the enc-dec family and the VL family's M-RoPE through the generic
   entry points: (a) the contiguous flash kernel full (not causal) at
   seamless-m4t-large-v2's widths (``ENCDEC_ATTN``: 16 heads of 64, g =
   1) — self-attention over 4 x 1000 and 4 x 1024 frames, cross-attention
   of 256 queries over 1000 keys and of 1000 over 37 — the contiguous
   decode there at one shared () length (S = 1000 and S = 97), the causal
   flash over 2 x 1024 tokens and both decodes over rows of 1-2048
   positions at qwen2-vl-7b's widths (``VL_ATTN``: 28 heads of 128 over 4,
   g = 7), f32 and bf16, in phase 2's style; (b) seamless at full width,
   bf16: ``registry.forward`` over 4 x (1000 source frames + 256 target
   tokens) with 72 flash launches, ``make_cache(src_embeds=)`` with 24,
   greedy decode (64 replayed + 16 new) with 48 decode launches a step,
   its replay held to the forward, and the f32 replay; (c) qwen2-vl at
   full width, bf16: ``forward_lm`` on merged patch embeddings (64 text
   tokens, a 24 x 24 image, 384 text tokens) at M-RoPE grid positions
   with 28 flash launches, greedy decode (a 128-token prompt with an 8 x
   8 grid, replayed with per-step positions, + 16 new) with 28 decode
   launches a step, its replay held to the forward, and the f32 replay
   (batch 1, 128 tokens); (d) both SMOKE configs on the card against the
   CPU: forward logits and greedy tokens;
17. training: (a) the flash kernel's forward with its log-sum-exp and its
   backward (``csrc/flash_backward.cu``) against autograd through the
   plain version, dQ / dK / dV in f32 and bf16, at the training paths'
   attention widths (``BWD_CASES``: qwen3-1.7b 4 x 1024, gemma3 with and
   without its window, glm4's g = 16, qwen2's g = 7, seamless full and
   cross, zamba2 1 x 4096, a ragged 1000), each timed beside the plain
   backward, one SDPA backward and its bound; then the SSD scan's forward
   with its chunk states and its backward (``csrc/ssd_backward.cu``)
   against autograd through the plain scan, dx / ddt / dA / dB / dC in
   f32 and bf16 (``SSD_BWD_CASES``: mamba2's and zamba2's training shape
   4 x 1024, mamba2 1 x 4096 with 32-column slices, a SMOKE shape, a G =
   2 case), two launches bit-equal, each timed beside the plain backward
   and its bound; (b) six
   SMOKE configs (dense, MoE, VL with M-RoPE positions, enc-dec, SSM,
   hybrid) trained on the card against the CPU from the same weights; (c)
   qwen3-1.7b at full width in f32, 2 steps of 4 x 1024 tokens (28
   backward and 56 forward flash launches a step, ms a step, tokens/s,
   peak memory, a profiled step), then a checkpoint resume at its widths
   cut to 2 layers; then mamba2-2.7b (64 backward and 128 forward scan
   launches a step) and zamba2-2.7b (54 and 108, and 9 and 18 flash) at
   full width in f32 the same way;
18. the append-buffer decode and ``mesh=`` on one rank: (a) after phase
   2, the contiguous decode kernel with its window end and its
   log-sum-exp (``SPLIT_ATTN``: glm4-9b's, gemma3-27b's with its window,
   qwen3-moe's and qwen2-vl's widths, f32 and bf16, batch 4, one shared
   length): the prefix segment of 2048 positions with the query at 2048
   and 2303, an empty prefix, and the suffix ring of 256 at slots 0, 100
   and 255, the output held to the plain version at ``TOL`` and the lse
   at ``LSE_TOL`` (-inf exactly where the plain version's is), each timed
   beside the plain version, one SDPA call and its bound; (b) inside
   phase 12, on its glm4-9b (full width, bf16), ``decode_step`` with
   ``get_optimized_config``'s ``decode_window=256`` against the regular
   decode: 4 rows, 64 replayed and 64 greedy tokens with the prefix empty,
   then 32 more with ``prefix_len = 128`` taken from the regular decode's
   cache; logits within ``SPLIT_TOL`` and greedy tokens equal, the decode
   kernel counted twice a layer a step; (c) inside phase 3,
   ``RealEngine(kv_layout="paged", mesh=make_mesh_for(1))`` on its family
   serving its 8 requests with streams equal to its engine's, both paged
   kernels counted, then the SMOKE config disaggregated on the (1, 1)
   mesh, card against CPU, strictly; and, after phase 12, (b) again with
   f32 weights at qwen2-0.5b's width, every greedy token equal to the
   regular decode's (``phase_split_decode_f32``);
19. serving across devices (``launch.ranks.spawn``: one process a rank,
   the ranks sharing the card over gloo; NCCL puts no two ranks on one
   device): (a) qwen3-1.7b at full width with f32 weights on a (1, 2)
   mesh of 2 ranks, 8 of the 16 query heads over 4 of the 8 KV heads a
   rank, half of every MLP and of the vocab, serving phase 3's 8 requests
   of 16 new tokens (128-token prefill chunks) through
   ``RealEngine(kv_layout="paged", mesh=...)``, every stream equal to a
   single-rank engine's on the same seeded weights (a differing token
   printed with its top-2 gap), both paged kernels launched on every
   rank, the collectives of the serve and of one decode step printed,
   each rank's card peak within its shard, its arena and
   ``TP_ACTIVATION_BYTES`` (the whole weights stay on the host); (b) the SMOKE config disaggregated on a (2,
   2) mesh of 4 ranks on the card against the CPU, strictly; (c) both
   paged kernels at a rank's shapes held to their plain versions and
   timed (``TP_ATTN``);
20. the ``kernels`` line: every ported kernel with its launches on the main
   paths that run it (phases 3, 9, 11a, 12, 14, 15 and 18c for the paged
   kernels, phases 4, 11b, 13, 14d, 16b-d and 18b for the contiguous
   decode and, with
   17b-c, the f32 contiguous prefill, whose record is the slotted serve's
   1024-token shape, phases 7 and 17b-c for the scan, phase 8's, phase
   12's, phase 14b's and phase 16's forwards for the bf16 contiguous
   prefill, whose record is phase 8's forward shape, phases 17b-c for the
   two backwards, whose records are the full-width training steps'
   shapes), and the two paged kernels at a rank's shapes with the ranks'
   launches in phase 19 (``paged_decode_attention_rank``,
   ``paged_prefill_attention_rank``).

Any failed check raises, and the script exits non-zero without printing a
result.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the operation
# rate of each input type — f32 on the CUDA cores, bf16 on the tensor
# cores, and f32 split into bf16 pairs on the tensor cores (hi.hi + hi.lo
# + lo.hi: three bf16 products for each f32 one), which is how the kernels
# in SPLIT_BF16 multiply f32 inputs, so the card can do their f32 work at
# that rate
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12,
              "float32 as split bf16": 989e12 / 3}
SPLIT_BF16 = ("paged_prefill_attention", "flash_attention", "ssd_chunked",
              "flash_attention_bwd", "ssd_chunked_bwd")
# (atol, rtol) of a kernel against its plain version: f32 differs in the
# order of its sums; both accumulate bf16 inputs in f32, so a bf16 output
# differs by about one bf16 rounding of the output (relative 2**-8); the
# tensor-core flash body also rounds P to bf16 before P.V, as the
# reference model path does, which stays inside the same limit
# (tests/test_torch_kernels.py emulates it against the Pallas kernel)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-3, 1e-2)}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls.
    The device first spins (``torch.cuda._sleep``) for longer than the host
    takes to enqueue the calls, so that they run back to back: a kernel
    shorter than its wrapper's host time is timed on the device, not at the
    host's enqueue rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second: above the H100's SM clock, so the spin outlasts
    # the enqueue
    torch.cuda._sleep(int(min(1.5 * reps * host_s + 1e-3, 1.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes: float, n_ops: float, dtype: str, name: str,
              rate: str = ""):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak for the kernel ``name``'s
    inputs of type ``dtype`` (or over ``PEAK_OPS_S[rate]``)."""
    split = dtype == "float32" and name in SPLIT_BF16
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[rate or ("float32 as split bf16" if split
                                        else dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# =============================================================================
# phase 1: device and build
# =============================================================================
def phase_device_build() -> str:
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    _build.extension(verbose=os.environ.get("CHIP_SMOKE_VERBOSE") == "1")
    print(f"build: {_build.build_seconds:.1f} s into {_build.BUILD_DIR}")
    return smi


# =============================================================================
# phase 2: kernels vs plain versions on the card
# =============================================================================
def _decode_case(b: int, dtype, seed: int, max_len: int = 2048,
                 bs: int = 16, K: int = 8, g: int = 2, dh: int = 128,
                 lengths=None):
    """Random paged-decode inputs over tables of ``max_len // bs`` pages:
    every row's pages are distinct arena blocks; lengths drawn up to
    max_len with one row at max_len, or the given ``lengths`` (one value
    for every row, or one per row)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    n_pages = max_len // bs
    if lengths is None:
        lengths = rng.integers(1, max_len + 1, size=b)
        lengths[0] = max_len
    lengths = np.broadcast_to(np.asarray(lengths), (b,)).astype(np.int32)
    nb = b * n_pages + 1
    perm = rng.permutation(np.arange(1, nb)).reshape(b, n_pages)
    tables = np.zeros((b, n_pages), np.int32)
    for i in range(b):
        used = -(-int(lengths[i]) // bs)
        tables[i, :used] = perm[i, :used]
    dev = "cuda"
    q = torch.randn(b, K * g, dh, device=dev).to(dtype)
    ka = torch.randn(nb, bs, K, dh, device=dev).to(dtype)
    va = torch.randn(nb, bs, K, dh, device=dev).to(dtype)
    return (q, ka, va, torch.as_tensor(tables, device=dev),
            torch.as_tensor(lengths, device=dev))


def _prefill_case(n_past: int, dtype, seed: int, C: int = 32,
                  true_c: int = 0, bs: int = 16, K: int = 8, g: int = 2,
                  dh: int = 128, nb: int = 257):
    """Random chunked-prefill inputs: a chunk of C queries at n_past.., the
    first ``true_c`` of them real (all with 0), the table sliced to the
    power-of-two page bucket the engine uses for them — so the padded
    queries of a ragged last chunk may lie past the table's span."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    need = -(-(n_past + (true_c or C)) // bs)
    span = 1
    while span < need:
        span *= 2
    table = np.zeros((span,), np.int32)
    table[:need] = rng.permutation(np.arange(1, nb))[:need]
    dev = "cuda"
    q = torch.randn(C, K * g, dh, device=dev).to(dtype)
    ka = torch.randn(nb, bs, K, dh, device=dev).to(dtype)
    va = torch.randn(nb, bs, K, dh, device=dev).to(dtype)
    pos = torch.arange(C, device=dev, dtype=torch.int32) + n_past
    return q, ka, va, torch.as_tensor(table, device=dev), pos


def _sdpa_decode(q, ka, va, tables, lengths, window: int = 0):
    """Yardstick: one scaled_dot_product_attention call on the gathered
    K/V (gather outside the timed call) with a per-row length (and
    window) mask."""
    from repro_torch.kernels.ref import gather_paged_kv
    kc, vc = gather_paged_kv(ka, va, tables)
    return _sdpa_contig_decode(q, kc, vc, lengths, window)


def _sdpa_prefill(q, ka, va, table, pos, window: int = 0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import gather_paged_kv
    kc, vc = gather_paged_kv(ka, va, table[None])
    kq = kc.transpose(1, 2).contiguous()              # (1, K, S, dh)
    vq = vc.transpose(1, 2).contiguous()
    qq = q.transpose(0, 1)[None]                       # (1, H, C, dh)
    diff = pos.long()[:, None] - torch.arange(kc.shape[1],
                                              device=q.device)[None, :]
    mask = diff >= 0
    if window > 0:
        mask &= diff < window
    return lambda: F.scaled_dot_product_attention(
        qq, kq, vq, attn_mask=mask[None, None], enable_gqa=True)


def _contig_decode_case(b: int, dtype, seed: int, S: int = 2048, K: int = 8,
                        g: int = 2, dh: int = 128, lengths=None):
    """Random slotted-decode inputs: one layer's (b, S, K, dh) caches with
    per-row lengths drawn up to S, one row at S; or the given ``lengths``:
    an int is one () length shared by every row (the generic decode step's
    scalar position), a tuple one length per row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    if lengths is None:
        lengths = rng.integers(1, S + 1, size=b)
        lengths[0] = S
    dev = "cuda"
    q = torch.randn(b, K * g, dh, device=dev).to(dtype)
    kc = torch.randn(b, S, K, dh, device=dev).to(dtype)
    vc = torch.randn(b, S, K, dh, device=dev).to(dtype)
    return q, kc, vc, torch.as_tensor(np.asarray(lengths, np.int32),
                                      device=dev)


def _flash_case(sq: int, dtype, seed: int, K: int = 8, g: int = 2,
                dh: int = 128, b: int = 1, skv: int = 0):
    """Random contiguous-prefill inputs: b prompts of sq tokens, against
    skv keys of another sequence when skv > 0 (cross-attention)."""
    import torch
    torch.manual_seed(seed)
    dev = "cuda"
    q = torch.randn(b, sq, K * g, dh, device=dev).to(dtype)
    k = torch.randn(b, skv or sq, K, dh, device=dev).to(dtype)
    v = torch.randn(b, skv or sq, K, dh, device=dev).to(dtype)
    return q, k, v


def _sdpa_contig_decode(q, kc, vc, lengths, window: int = 0):
    import torch
    import torch.nn.functional as F
    kq = kc.transpose(1, 2).contiguous()              # (b, K, S, dh)
    vq = vc.transpose(1, 2).contiguous()
    qq = q[:, :, None, :]                              # (b, H, 1, dh)
    pos = torch.arange(kc.shape[1], device=q.device)[None, :]
    ln = lengths.reshape(-1, 1)
    mask = pos < ln
    if window > 0:
        mask &= pos >= ln - window
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask,
                                                  enable_gqa=True)


def _sdpa_flash(q, k, v, window: int, causal: bool = True):
    import torch
    import torch.nn.functional as F
    qq, kq, vq = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qq, kq, vq, is_causal=causal, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < window)
    return lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask,
                                                  enable_gqa=True)


# zamba2's shared attention: 32 heads of 80 over 32 KV heads (g = 1); its
# decode step reads a cache of 128 prompt positions and its new ones at one
# shared length (lengths=160 in a case)
ZAMBA2_ATTN = dict(K=32, g=1, dh=80)
# zamba2 SMOKE's: 4 heads of 16 over 4 KV heads
ZAMBA2_SMOKE_ATTN = dict(K=4, g=1, dh=16)
# the dense family's attention: gemma3-27b 32 heads of 128 over 16 KV heads
# (window 1024 on its local layers), glm4-9b 32 over 2 (g = 16), qwen2-0.5b
# 14 heads of 64 over 2 (g = 7); decode rows shorter and longer than
# gemma3's window, one at the table's 2048
DENSE_ATTN = {"gemma3": dict(K=16, g=2, dh=128),
              "glm4": dict(K=2, g=16, dh=128),
              "qwen2": dict(K=2, g=7, dh=64)}
DENSE_LENGTHS = (2048, 1400, 1025, 1024, 1000, 300, 17, 1)
# the MoE family's attention: qwen3-moe-30b-a3b 32 heads of 128 over 4 KV
# heads (g = 8), qwen2-moe-a2.7b 16 over 16 (g = 1)
MOE_ATTN = {"qwen3-moe": dict(K=4, g=8, dh=128),
            "qwen2-moe": dict(K=16, g=1, dh=128)}


def phase_kernels() -> dict:
    """Hold every attention kernel against its plain version; returns
    per-kernel records measured at the headline shape of its main path
    (f32: paged decode b=8, paged prefill n_past=992, contiguous decode
    b=8, contiguous prefill of qwen3's 1024 tokens, the slotted serve's;
    bf16: contiguous prefill of 4 x 4096 tokens at zamba2's widths, the
    hybrid forward's).  The split-KV paged kernels also run at the serve's
    decode step, with empty splits and length 1, on ragged chunks and with
    a window, in both types.  The split-KV contiguous decode also runs
    over S = 2040 (a ragged last page), with a row of length 0 (held to
    zero, the wrapper's contract, where the plain version averages V), a
    length above S, one () length shared by every row, and rows of 1-40
    positions (empty trailing splits), in both types.  The contiguous
    kernels run at zamba2's shapes (``ZAMBA2_ATTN``) as the hybrid phase
    gives them: prefill of 4 prompts of 4096 tokens, decode at batch 4
    over 160 positions; the tensor-core prefill also at the slotted
    serve's other buckets (64, 256 tokens; f32), a ragged 1000 tokens,
    with a window, and at zamba2 SMOKE's head dim 16, in both types; and
    the dense and MoE families' attention shapes (``DENSE_ATTN``,
    ``MOE_ATTN``)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    cases = ([("decode", b, f32) for b in (1, 8)]
             + [("prefill", n, f32) for n in (0, 224, 992)]
             + [("decode", 8, bf16), ("prefill", 992, bf16)]
             + [("contig_decode", b, f32) for b in (1, 8)]
             + [("contig_decode", 8, bf16)]
             + [("flash", (sq, 0), f32) for sq in (128, 1024)]
             + [("flash", (1024, 256), f32), ("flash", (1024, 0), bf16)]
             + [("flash", (4096, 0), d, dict(ZAMBA2_ATTN, b=4))
                for d in (bf16, f32)]
             + [("flash", (1000, 0), bf16), ("flash", (1024, 256), bf16),
                ("flash", (200, 0), bf16, dict(ZAMBA2_SMOKE_ATTN, b=2))]
             + [("contig_decode", 4, d, dict(ZAMBA2_ATTN, S=160, lengths=160))
                for d in (bf16, f32)]
             # the split-KV contiguous decode: a ragged last page (S =
             # 2040), a row of length 0 and lengths above S, one () length
             # shared by every row (the serve's longest row), rows whose
             # trailing splits are empty (lengths 1-40)
             + [("contig_decode", 8, d, shape) for d in (f32, bf16)
                for shape in (dict(S=2040),
                              dict(S=2040, lengths=(0, 2041, 1000, 2040, 17,
                                                    4096, 1, 2039)),
                              dict(lengths=1055),
                              dict(lengths=(1, 40, 17, 2, 33, 16, 5, 24)))]
             # the f32 tensor-core prefill at the slotted serve's other
             # buckets, ragged, and at zamba2 SMOKE's head dim 16
             + [("flash", (sq, 0), f32) for sq in (64, 256, 1000)]
             + [("flash", (200, 0), f32, dict(ZAMBA2_SMOKE_ATTN, b=2))]
             # the split-KV paged kernels: the serve's decode step (300
             # positions a row over 128-page tables), rows whose trailing
             # splits are empty (lengths 1-40), bf16 at batch 1; prefill
             # in bf16 at n_past 0 and 224, ragged last chunks (the padded
             # queries of the first past the table's span), a window
             + [("decode", 8, d, dict(lengths=300)) for d in (f32, bf16)]
             + [("decode", 8, d, dict(lengths=(1, 40, 17, 2, 33, 16, 5, 24)))
                for d in (f32, bf16)]
             + [("decode", 1, bf16)]
             # a group of one query row (zamba2's widths): odd partials
             + [("decode", 4, f32, dict(ZAMBA2_ATTN, max_len=160))]
             + [("prefill", n, bf16) for n in (0, 224)]
             + [("prefill", n, d, dict(true_c=c)) for d in (f32, bf16)
                for n, c in ((0, 5), (992, 7))]
             + [("prefill", 992, d, dict(window=256)) for d in (f32, bf16)]
             # the dense family's shapes (DENSE_ATTN): gemma3's decodes at
             # batch 8 over rows of up to 2048 positions, shorter and
             # longer than its window of 1024 (local) and without it
             # (global); glm4's group of 16 rows (two row-chunks), with
             # and without a window; qwen2's group of 7 of dh 64; the paged
             # prefill of a 128-token chunk at n_past 1280 and the
             # contiguous flash over a 1400-token prompt at gemma3's
             # (window 1024 and none), glm4's and qwen2's widths
             + [(kind, 8, d, dict(DENSE_ATTN[m], window=w,
                                  lengths=DENSE_LENGTHS))
                for d in (f32, bf16)
                for kind in ("decode", "contig_decode")
                for m, w in (("gemma3", 1024), ("gemma3", 0),
                             ("glm4", 0), ("glm4", 1024), ("qwen2", 0))]
             + [("prefill", 1280, d, dict(DENSE_ATTN[m], C=128, nb=129,
                                          window=w))
                for d in (f32, bf16)
                for m, w in (("gemma3", 1024), ("gemma3", 0), ("glm4", 0),
                             ("qwen2", 0))]
             + [("flash", (1400, w), d, DENSE_ATTN[m]) for d in (f32, bf16)
                for m, w in (("gemma3", 1024), ("gemma3", 0), ("glm4", 0),
                             ("qwen2", 0))]
             # the MoE family's shapes (MOE_ATTN): both decodes at batch 8
             # over rows of 1-2048 positions, the paged prefill of a
             # 128-token chunk at n_past 1280 and the contiguous flash over
             # 1400 tokens, at qwen3-moe's and qwen2-moe's widths
             + [(kind, 8, d, dict(MOE_ATTN[m], lengths=DENSE_LENGTHS))
                for d in (f32, bf16) for kind in ("decode", "contig_decode")
                for m in MOE_ATTN]
             + [("prefill", 1280, d, dict(MOE_ATTN[m], C=128, nb=129))
                for d in (f32, bf16) for m in MOE_ATTN]
             + [("flash", (1400, 0), d, MOE_ATTN[m]) for d in (f32, bf16)
                for m in MOE_ATTN])
    # the case whose numbers each record of the kernels line carries
    headlines = {("decode", 8, "float32", ()): "paged_decode_attention",
                 ("prefill", 992, "float32", ()): "paged_prefill_attention",
                 ("contig_decode", 8, "float32", ()): "decode_attention",
                 ("flash", (4096, 0), "bfloat16",
                  tuple(sorted(dict(ZAMBA2_ATTN, b=4).items()))):
                     "flash_attention",
                 ("flash", (1024, 0), "float32", ()): "flash_attention_f32"}
    return _kernel_cases(cases, headlines)


def _kernel_cases(cases, headlines: dict) -> dict:
    """Run each case of ``cases`` ((kind, arg, dtype[, shape])): the kernel
    held to its plain version at ``TOL``, then timed beside the plain
    version, one SDPA call and its bound; returns the records of the cases
    that ``headlines`` names."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as REF
    records = {}
    for i, (kind, arg, dtype, *shape) in enumerate(cases):
        shape = dict(shape[0]) if shape else {}
        dname = str(dtype).replace("torch.", "")
        key = (kind, arg, dname, tuple(sorted(shape.items())))
        elt = torch.tensor([], dtype=dtype).element_size()
        if kind == "decode":
            window = shape.pop("window", 0)
            args = _decode_case(arg, dtype, seed=i, **shape)
            kern = lambda a=args, w=window: PA.paged_decode_attention(
                *a, window=w)
            plain = lambda a=args, w=window: REF.paged_decode_attention_ref(
                *a, window=w)
            lib = _sdpa_decode(*args, window)
            q, ka, va, tables, lengths = args
            H, dh = q.shape[1], q.shape[2]
            K, bs = ka.shape[2], ka.shape[1]
            ln = lengths.long().cpu()
            lo = (ln - window).clamp(min=0) if window > 0 else 0 * ln
            seen = int((ln - lo).sum())        # the visible positions
            pages = (-(-ln // bs) - lo // bs).sum().item()
            n_bytes = (2 * q.numel() * elt + 2 * seen * K * dh * elt
                       + 4 * (pages + len(ln)))
            n_ops = 4 * seen * H * dh
            name, label = "paged_decode_attention", f"b={arg}"
            if shape or window:
                label += (f" H={H} K={K} dh={dh} window={window} lengths "
                          f"{tuple(int(x) for x in ln)}")
        elif kind == "contig_decode":
            window = shape.pop("window", 0)
            args = _contig_decode_case(arg, dtype, seed=i, **shape)
            kern = lambda a=args, w=window: DA.decode_attention(*a, window=w)
            plain = lambda a=args, w=window: REF.decode_attention_ref(
                *a, window=w)
            lib = _sdpa_contig_decode(*args, window)
            q, kc, vc, lengths = args
            H, dh, K = q.shape[1], q.shape[2], kc.shape[2]
            ln = lengths.long().cpu().expand(arg)
            lo = (ln - window).clamp(min=0) if window > 0 else 0 * ln
            seen = int((ln.clamp(max=kc.shape[1]) - lo).clamp(min=0).sum())
            n_bytes = (2 * q.numel() * elt + 2 * seen * K * dh * elt
                       + lengths.numel() * 4)
            n_ops = 4 * seen * H * dh
            name, label = "decode_attention", f"b={arg}"
            if shape or window:
                given = tuple(int(x) for x in lengths.reshape(-1).cpu())
                label += (f" S={kc.shape[1]} H={H} K={K} dh={dh} window="
                          f"{window} lengths "
                          f"{'shared ' if lengths.dim() == 0 else ''}"
                          f"{given if lengths.dim() else given[0]}")
            if bool((ln == 0).any()):
                # a row of length 0 comes back zero (the wrapper's
                # contract); the plain version, like the reference's
                # -1e30 mask, averages V over the row
                zero = (ln == 0).to(q.device)
                plain = lambda a=args, z=zero: REF.decode_attention_ref(
                    *a).masked_fill(z[:, None, None], 0)
        elif kind == "flash":
            sq, window = arg
            causal = shape.pop("causal", True)
            args = _flash_case(sq, dtype, seed=i, **shape)
            kern = lambda a=args, w=window, c=causal: FA.flash_attention(
                *a, causal=c, window=w)
            plain = lambda a=args, w=window, c=causal: \
                REF.flash_attention_ref(*a, causal=c, window=w)
            lib = _sdpa_flash(*args, window, causal)
            q, k, v = args
            H, dh, K, skv = q.shape[2], q.shape[3], k.shape[2], k.shape[1]
            qpos = torch.arange(sq)
            if not causal:                   # every query sees every key
                visible = torch.full((sq,), skv)
            elif window <= 0:
                visible = qpos + 1
            else:
                visible = (qpos + 1).clamp(max=window)
            n_bytes = 2 * q.numel() * elt + 2 * k.numel() * elt
            n_ops = 4 * dh * H * int(visible.sum()) * q.shape[0]
            name, label = "flash_attention", f"sq={sq} window={window}"
            if shape or not causal:
                label += f" b={q.shape[0]} H={H} K={K} dh={dh}"
            if not causal:
                label += f" skv={skv} full"
        else:
            window = shape.pop("window", 0)
            args = _prefill_case(arg, dtype, seed=i, **shape)
            kern = lambda a=args, w=window: FA.paged_prefill_attention(
                *a, window=w)
            plain = lambda a=args, w=window: REF.paged_prefill_attention_ref(
                *a, window=w)
            lib = _sdpa_prefill(*args, window)
            q, ka, va, table, pos = args
            C, H, dh = q.shape
            K, bs = ka.shape[2], ka.shape[1]
            # keys each query sees: causal, inside the table's span and
            # the window; K/V read once from the first to the last seen
            kpos = torch.arange(table.shape[0] * bs, device=pos.device)
            diff = pos.long()[:, None] - kpos[None, :]
            seen = diff >= 0
            if window > 0:
                seen &= diff < window
            cols = seen.any(0).nonzero()
            first, last = int(cols.min()), int(cols.max())
            n_keys = last - first + 1
            pages = last // bs - first // bs + 1
            n_bytes = (2 * q.numel() * elt + 2 * n_keys * K * dh * elt
                       + 4 * (pages + C))
            n_ops = 4 * H * dh * int(seen.sum())
            name, label = "paged_prefill_attention", f"n_past={arg}"
            if shape or window:
                label += f" true_c={shape.get('true_c', C)} window={window}"
            if K != 8:
                label += f" C={C} H={H} K={K} dh={dh}"
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        atol, rtol = TOL[dname]
        ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
        _check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite")
        _check(ok, f"{name} {label} {dname}: max |err| {err:.3g} beyond "
                   f"atol {atol} rtol {rtol}")
        ms, plain_ms, lib_ms = _time_ms(kern), _time_ms(plain), _time_ms(lib)
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, dname, name)
        print(f"kernel {name} {label} {dname}: max_abs_err {err:.3g} "
              f"(atol {atol} rtol {rtol}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"sdpa_ms {lib_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
        if dname == "float32" and name in SPLIT_BF16:
            # the same work at the CUDA cores' f32 peak, the rate of a
            # kernel that multiplies f32 outside the tensor cores
            cc_ms, cc_by = _bound_ms(n_bytes, n_ops, dname, name, "float32")
            print(f"kernel {name} {label} {dname}: bound_ms at the CUDA "
                  f"cores' f32 peak {cc_ms:.5f} ({cc_by})")
        if key in headlines:
            records[headlines[key]] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
    return records


# the SSD scan at the full widths of the two SSM families the port serves
SSD_SHAPES = {"mamba2": dict(H=80, P=64, G=1, N=128, chunk=128),
              "zamba2": dict(H=80, P=64, G=1, N=64, chunk=128),
              "grouped": dict(H=80, P=64, G=8, N=64, chunk=128),
              "g2": dict(H=80, P=64, G=2, N=64, chunk=128),
              "smoke": dict(H=16, P=8, G=1, N=8, chunk=8)}
# (model, b, s, dtype name); the mamba2 bf16 case at 4 x 4096 is the shape
# of the SSM phase's forward, the headline of the kernels line
SSD_CASES = ([("mamba2", b, 2048, d) for d in ("float32", "bfloat16")
              for b in (1, 4)]
             + [("zamba2", 1, 2048, "bfloat16"), ("zamba2", 4, 2048,
                                                   "float32"),
                ("grouped", 2, 2048, "float32"),
                ("grouped", 2, 2048, "bfloat16"), ("smoke", 2, 64,
                                                   "float32"),
                ("zamba2", 4, 4096, "bfloat16"),
                ("mamba2", 4, 4096, "bfloat16"),
                ("mamba2", 1, 32768, "bfloat16")])
SSD_HEADLINE = ("mamba2", 4, 4096, "bfloat16")
# largest |error| of the scan's y and state against its plain version, as
# a fraction of max|plain|: the kernel multiplies f32 operands as split
# bf16 pairs (~16 bits kept) with f32 sums, the plain version in f32, and
# their sums run in other orders; on the H100 the largest sound reading
# over every case is 6.8e-5 (state, zamba2 bf16 4 x 4096; y at most
# 3.2e-5), so the limit sits ~3x above it, and 6-15x below the reading of
# y rounded to bf16 (up to 2^-9 of an element, 1.3e-3 to 3.0e-3 of
# max|y|), which every case computes and must reject
SSD_TOL = 2e-4


def _ssd_case(model: str, b: int, s: int, dtype, seed: int):
    """Random scan inputs at a model's widths: x, B, C ~ N(0, 1) in
    ``dtype``; dt = softplus(N(0, 1)) and A = -exp(log(linspace(1, 16)))
    (the models' init of A_log) in f32."""
    import torch
    import torch.nn.functional as F
    sh = SSD_SHAPES[model]
    H, P, G, N = sh["H"], sh["P"], sh["G"], sh["N"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)
    x = rnd(b, s, H, P).to(dtype)
    dt = F.softplus(rnd(b, s, H))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device=dev)))
    B = rnd(b, s, G, N).to(dtype)
    C = rnd(b, s, G, N).to(dtype)
    return x, dt, A, B, C


def phase_ssd_kernels() -> dict:
    """Hold the SSD scan against its plain version at mamba2's and
    zamba2's full widths (H = 80 heads of P = 64, chunk 128, N = 128 and
    64), a grouped case (G = 8, 10 heads per group) and a SMOKE-width one,
    in f32 and bf16, at batch 1, 2 and 4 over 2048 positions, and at the
    SSM phase's 4 x 4096 and 1 x 32768 (where the wrapper cuts P into
    32-column slices); returns the record of the headline case."""
    import torch
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels import ssd_scan as SSD
    records = {}
    for i, (model, b, s, dname) in enumerate(SSD_CASES):
        dtype = getattr(torch, dname)
        chunk = SSD_SHAPES[model]["chunk"]
        args = _ssd_case(model, b, s, dtype, seed=100 + i)
        kern = lambda a=args, c=chunk: SSD.ssd_chunked(*a, chunk=c)
        plain = lambda a=args, c=chunk: REF.ssd_chunked_ref(*a, c)
        y, st = kern()
        torch.cuda.synchronize()
        y_ref, st_ref = plain()
        label = f"{model} b={b} s={s} {dname}"
        errs = []
        for what, got, want in (("y", y, y_ref), ("state", st, st_ref)):
            _check(bool(torch.isfinite(got).all()),
                   f"ssd_chunked {label}: non-finite {what}")
            atol = SSD_TOL * want.abs().max().item()
            err = (got - want).abs().max().item()
            _check(err <= atol, f"ssd_chunked {label}: {what} max |err| "
                                f"{err:.3g} beyond {atol:.3g}")
            errs.append((err, atol))
        # the check must reject a y that lost f32 precision
        faulted = (y_ref.bfloat16().float() - y_ref).abs().max().item()
        _check(faulted > errs[0][1], f"ssd_chunked {label}: y rounded to "
                                     f"bf16 ({faulted:.3g}) passes the check")
        x, dt, A, B, C = args
        H, P, N = x.shape[2], x.shape[3], B.shape[3]
        nc = s // chunk
        # the within-chunk products need only the c (c + 1) / 2 pairs j <= i
        n_ops = b * H * nc * (chunk * (chunk + 1) * (N + P)
                              + 4 * chunk * N * P)
        n_bytes = ((x.numel() + B.numel() + C.numel()) * x.element_size()
                   + 4 * (dt.numel() + A.numel() + y.numel() + st.numel()))
        reps = 20 if b * s <= 4096 else 5
        ms, plain_ms = _time_ms(kern, reps=reps), _time_ms(plain, reps=reps)
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, dname, "ssd_chunked")
        print(f"kernel ssd_chunked {label}: max_abs_err y {errs[0][0]:.3g} "
              f"(atol {errs[0][1]:.3g}; y rounded to bf16 {faulted:.3g}) "
              f"state {errs[1][0]:.3g} (atol {errs[1][1]:.3g}) ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
        if (model, b, s, dname) == SSD_HEADLINE:
            records["ssd_chunked"] = {
                "max_abs_err": max(e for e, _ in errs), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
        del args, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
    return records


def _device_profile(fn, steps: int, t_wall: float, parts: dict,
                    ranges: dict = None) -> str:
    """Device time per step of ``fn`` (which runs ``steps`` decode steps,
    or one forward) from torch.profiler: the sum over device events
    (kernels, copies, fills), each counted once — the CPU op that launched
    a kernel carries its time too, so CPU events are left out — with the
    time of the kernels each predicate of ``parts`` picks (by label), the
    number of device events, the idle share against the wall time
    ``t_wall`` of ``fn``, and the five largest events by name.  ``ranges``
    maps a label to (module, function name): while profiling, each such
    function runs inside a ``record_function`` range of that label, and
    the device time of the kernels launched inside it is reported too."""
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(label, fn_):
        def call(*args, **kw):
            with record_function(label):
                return fn_(*args, **kw)
        return call

    ranges = ranges or {}
    with contextlib.ExitStack() as undo:
        for label, (mod, name) in ranges.items():
            orig = getattr(mod, name)
            setattr(mod, name, ranged(label, orig))
            undo.callback(setattr, mod, name, orig)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        return "device busy not measured (the profiler saw no device time)"
    def part_ms(pick) -> float:
        return sum(e.self_device_time_total for e in dev
                   if pick(e.key)) / steps / 1e3

    part_s = ", ".join(f"{label} {part_ms(pick):.3f} ms = "
                       f"{part_ms(pick) * steps * 1e3 / busy_us:.3f} of busy"
                       for label, pick in parts.items())
    if ranges:
        events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        for label in ranges:
            us = sum(e.device_time_total for e in events if e.name == label)
            part_s += (f", {label} {us / steps / 1e3:.3f} ms = "
                       f"{us / busy_us:.3f} of busy")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    top_s = "; ".join(f"{e.key[:48]} {e.self_device_time_total / steps / 1e3:.3f}"
                      f" ms in {e.count / steps:g}" for e in top)
    return (f"device busy {busy_us / steps / 1e3:.3f} ms in "
            f"{sum(e.count for e in dev) / steps:g} device events "
            f"({part_s}), device idle share "
            f"{1 - busy_us / 1e6 / t_wall:.3f}; largest per step: {top_s}")


# =============================================================================
# phase 3: full-width serve through the paged engine
# =============================================================================
def _serve_prompts(vocab: int, seed: int = 0):
    """8 prompts of 64-1024 tokens; those of 384 tokens and more share a
    256-token prefix (a common system prompt)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=256).astype(np.int32)
    prompts = []
    for n in (64, 1024, 128, 768, 256, 640, 384, 512):
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if n >= 384:
            p[:256] = shared
        prompts.append(p)
    return prompts


def phase_serve() -> dict:
    """qwen3-1.7b at full width (28 layers, d=2048, 16 heads over 8 KV
    heads, bf16 weights, f32 arena) serving 8 requests of 24 new tokens,
    then phase 18c on the same family; returns each kernel's launches
    during the serve."""
    import numpy as np
    import torch
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import registry as R
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    cfg = qwen3_1_7b.FULL
    t0 = time.perf_counter()
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0)
    eng = ENG.RealEngine(family, max_len=2048, kv_layout="paged",
                         block_size=16, n_blocks=160, max_seqs=8)
    t_cfg = eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
    torch.cuda.synchronize()
    print(f"serve: family + arena {time.perf_counter() - t0 - t_cfg:.1f} s, "
          f"configure (warmup) {t_cfg:.1f} s, "
          f"{family[0].variant.params_m:.1f} M params")
    prompts = _serve_prompts(cfg.vocab_size)
    n_new = 24
    PA.paged_decode_attention.launches = 0
    FA.paged_prefill_attention.launches = 0
    m = serve_prompts(eng, prompts, n_new=n_new)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": PA.paged_decode_attention.launches,
                "paged_prefill_attention":
                    FA.paged_prefill_attention.launches}
    resps = eng.last_responses
    _check(m["served"] == len(prompts) == len(resps),
           f"served {m['served']} of {len(prompts)}")
    for r in resps:
        _check(len(r.tokens) == n_new, f"rid {r.rid}: {len(r.tokens)} tokens")
        _check(bool(((r.tokens >= 0) & (r.tokens < cfg.padded_vocab)).all()),
               f"rid {r.rid}: token ids out of range")
    _check(m["prefix_hit_tokens"] > 0, "no prefix-cache hit")
    total_j = sum(r.energy_j for r in resps)
    _check(abs(total_j - m["energy_j"]) <= 1e-9 * m["energy_j"],
           f"per-request joules {total_j} != session {m['energy_j']}")
    _check(all(n > 0 for n in launches.values()),
           f"a kernel was not launched on the main path: {launches}")
    _check(m["host_syncs"] == 0, f"{m['host_syncs']} blocking host syncs")
    _check(m["compile_retraces"] == 0, "shape missed by warmup")
    steps_per_dispatch = m["decode_steps"] / max(m["decode_dispatches"], 1)
    print(f"serve: {m['served']} requests, {m['tokens']} tokens in "
          f"{m['wall_s']:.2f} s = {m['tokens_per_s']:.1f} tok/s; "
          f"TTFT p50 {m['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{m['ttft_p95_s'] * 1e3:.1f} ms; latency p50 "
          f"{m['p50_s']:.2f} s; decode steps {m['decode_steps']} in "
          f"{m['decode_dispatches']} dispatches "
          f"({steps_per_dispatch:.2f} steps/dispatch); prefill chunks "
          f"{m['prefill_chunks']}; prefix hits {m['prefix_hit_tokens']} "
          f"tokens; host_syncs {m['host_syncs']}; h2d {m['h2d_transfers']}; "
          f"{m['j_per_token']:.3f} J/token (reference power model)")
    print(f"serve: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _add_launches(phase_mesh_serve(family, prompts, dict(eng.last_outputs),
                                   n_new))
    # one fused 8-step decode dispatch at the full batch, 300 tokens of
    # context per row (inactive rows: every write goes to the junk block):
    # it must not synchronise with the host; then its wall time per step
    # against the device time its kernels take (torch.profiler)
    inst = eng.instances[0]
    B, ctx = inst.max_seqs, 300
    pages = -(-ctx // inst.block_size)
    tables = np.zeros((B, inst.n_pages), np.int32)
    tables[:, :pages] = np.arange(1, 1 + B * pages).reshape(B, pages)
    args = [torch.as_tensor(a, device=inst.device) for a in
            (inst._next[:B], tables, np.full((B,), ctx, np.int32),
             np.zeros((B,), bool))]

    def dispatch():
        return R.decode_paged_multi(inst.params, inst.arena,
                                    {"tokens": args[0]}, *args[1:], 8)[0]

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _check(tuple(toks.shape) == (8, B), "fused decode shape")
    print("serve: a fused 8-step dispatch ran with no host synchronisation")
    t = time.perf_counter()
    dispatch()
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t
    device = _device_profile(dispatch, 8, t_wall, {
        "attention kernel (split and merge)":
            lambda key: "decode_split_kernel" in key and "PagedKV" in key})
    print(f"decode step (batch {B}, {ctx} tokens of context): wall "
          f"{t_wall / 8 * 1e3:.2f} ms, host enqueue "
          f"{t_enqueue / 8 * 1e3:.2f} ms, {device}")
    # the logits themselves: finite, of the padded vocab's width
    arena = R.make_block_arena(cfg, 3, 16, dtype=torch.float32,
                               device=inst.device)
    chunk = torch.as_tensor(prompts[0][None, :32], device=inst.device)
    lg = R.prefill_paged(inst.params, {"tokens": chunk}, arena,
                         torch.tensor([1, 2], dtype=torch.int32,
                                      device=inst.device), 0, 32)
    _check(tuple(lg.shape) == (1, 32, cfg.padded_vocab), "logits shape")
    _check(bool(torch.isfinite(lg).all()), "non-finite logits")
    # one prefill chunk of 32 tokens at n_past 992 (a 64-page table over
    # random K/V): wall, host enqueue, device busy and the share of the
    # prefill attention kernels (the split kernel and its merge)
    n_past, span = 992, 64
    arena = R.make_block_arena(cfg, span + 1, 16, dtype=torch.float32,
                               device=inst.device)
    for t in arena.values():
        t.normal_()
    table = torch.arange(1, span + 1, dtype=torch.int32, device=inst.device)
    chunk = torch.as_tensor(prompts[1][None, n_past:n_past + 32],
                            device=inst.device)

    def prefill_chunk():
        return R.prefill_paged(inst.params, {"tokens": chunk}, arena, table,
                               n_past, 32)

    prefill_chunk()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg = prefill_chunk()
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t
    _check(bool(torch.isfinite(lg).all()), "non-finite prefill logits")
    device = _device_profile(prefill_chunk, 1, t_wall, {
        "prefill attention kernels (split and merge)":
            lambda key: "paged_prefill" in key})
    print(f"prefill chunk (32 tokens at n_past {n_past}): wall "
          f"{t_wall * 1e3:.2f} ms, host enqueue {t_enqueue * 1e3:.2f} ms, "
          f"{device}")
    del eng, family, inst, arena
    torch.cuda.empty_cache()
    return launches


# =============================================================================
# phase 4: full-width serve through the slotted engine
# =============================================================================
def phase_slotted_serve() -> dict:
    """qwen3-1.7b at full width with f32 weights through the slotted engine
    (8 slots of 2048 positions) serving the 8 requests of phase 3, 24 new
    tokens each; returns each contiguous kernel's launches during the
    serve."""
    import torch
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry as R
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    cfg = qwen3_1_7b.FULL.with_(dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0)
    eng = ENG.RealEngine(family, n_slots=8, max_len=2048,
                         kv_layout="slotted")
    t_cfg = eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
    torch.cuda.synchronize()
    print(f"slotted: family + cache {time.perf_counter() - t0 - t_cfg:.1f} "
          f"s, configure (warmup of {len(ENG.serve_buckets(2048))} prefill "
          f"buckets + 1 decode step) {t_cfg:.1f} s, "
          f"{family[0].variant.params_m:.1f} M f32 params")
    prompts = _serve_prompts(cfg.vocab_size)
    n_new = 24
    DA.decode_attention.launches = 0
    FA.flash_attention.launches = 0
    m = serve_prompts(eng, prompts, n_new=n_new)
    torch.cuda.synchronize()
    launches = {"decode_attention": DA.decode_attention.launches,
                "flash_attention": FA.flash_attention.launches}
    resps = eng.last_responses
    _check(m["served"] == len(prompts) == len(resps),
           f"slotted: served {m['served']} of {len(prompts)}")
    for r in resps:
        _check(len(r.tokens) == n_new,
               f"slotted: rid {r.rid}: {len(r.tokens)} tokens")
        _check(bool(((r.tokens >= 0) & (r.tokens < cfg.padded_vocab)).all()),
               f"slotted: rid {r.rid}: token ids out of range")
    _check(all(n > 0 for n in launches.values()),
           f"slotted: a kernel was not launched on the main path: "
           f"{launches}")
    L = cfg.n_layers
    _check(launches["flash_attention"] == L * len(prompts),
           f"slotted: {launches['flash_attention']} prefill launches for "
           f"{len(prompts)} admissions of {L} layers")
    _check(launches["decode_attention"] == L * m["decode_steps"],
           f"slotted: {launches['decode_attention']} decode launches for "
           f"{m['decode_steps']} steps of {L} layers")
    _check(m["compile_retraces"] == 0, "slotted: shape missed by warmup")
    _check(m["host_syncs"] == len(prompts) + m["decode_steps"],
           f"slotted: {m['host_syncs']} host syncs for {len(prompts)} "
           f"admissions and {m['decode_steps']} decode steps")
    total_j = sum(r.energy_j for r in resps)
    _check(abs(total_j - m["energy_j"]) <= 1e-9 * m["energy_j"],
           f"slotted: per-request joules {total_j} != session "
           f"{m['energy_j']}")
    print(f"slotted: {m['served']} requests, {m['tokens']} tokens in "
          f"{m['wall_s']:.2f} s = {m['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{m['ttft_p50_s'] * 1e3:.1f} ms p95 {m['ttft_p95_s'] * 1e3:.1f} "
          f"ms; latency p50 {m['p50_s']:.2f} s; decode steps "
          f"{m['decode_steps']}; host_syncs {m['host_syncs']}; h2d "
          f"{m['h2d_transfers']}; {m['j_per_token']:.3f} J/token "
          f"(reference power model)")
    print(f"slotted: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # one decode step at 8 occupied slots, the serve's cache contents: its
    # wall time against the device time its kernels take (torch.profiler)
    inst = eng.instances[0]
    nxt = torch.zeros((inst.n_slots, 1), dtype=torch.int32,
                      device=inst.device)
    act = torch.zeros((inst.n_slots,), dtype=torch.bool, device=inst.device)

    def step():
        return R.decode_slots(inst.params, inst.cache, {"tokens": nxt},
                              act)[0]

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    step()
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t
    device = _device_profile(step, 1, t_wall, {
        "attention kernel (split and merge)":
            lambda key: "decode_split_kernel" in key and "ContigKV" in key})
    ctx = int(inst.cache["lengths"].max())
    print(f"slotted decode step (8 slots, up to {ctx} positions): wall "
          f"{t_wall * 1e3:.2f} ms, host enqueue {t_enqueue * 1e3:.2f} ms, "
          f"{device}")
    # one admission's prefill of the serve's longest prompt (1024 tokens,
    # the largest bucket): wall, host enqueue, device busy and the share
    # of the f32 tensor-core flash kernel
    tokens = torch.as_tensor(prompts[1][None], device=inst.device)

    def prefill():
        return R.prefill_kv(inst.params, {"tokens": tokens})[0]

    prefill()
    torch.cuda.synchronize()
    t = time.perf_counter()
    prefill()
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t
    device = _device_profile(prefill, 1, t_wall, {
        "flash kernel": lambda key: "flash_tc_kernel" in key})
    print(f"slotted prefill ({tokens.shape[1]} tokens): wall "
          f"{t_wall * 1e3:.2f} ms, host enqueue {t_enqueue * 1e3:.2f} ms, "
          f"{device}")
    # the logits themselves: finite, of the padded vocab's width
    tokens = torch.as_tensor(prompts[0][None, :32], device=inst.device)
    lg, k_all, _ = R.prefill_kv(inst.params, {"tokens": tokens})
    _check(tuple(lg.shape) == (1, 32, cfg.padded_vocab), "logits shape")
    _check(tuple(k_all.shape) == (L, 1, 32, cfg.n_kv_heads, cfg.d_head),
           "prefill K shape")
    _check(bool(torch.isfinite(lg).all()), "non-finite logits")
    del eng, family, inst, lg, k_all
    torch.cuda.empty_cache()
    return launches


# =============================================================================
# phase 5: Clover's real-mode control loop on the card
# =============================================================================
def phase_clover() -> None:
    """``repro_torch.launch.serve --mode real`` at the reference's settings
    (SMOKE widths, 8 layers, f32, 16 requests): annealing over the ladder's
    configuration graphs on measured latencies, through the slotted engine
    and its kernels."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.launch import serve as SERVE
    n0 = DA.decode_attention.launches
    rc = SERVE.main(["--mode", "real"])
    _check(rc == 0, f"clover: run_real returned {rc}")
    _check(DA.decode_attention.launches > n0,
           "clover: the loop did not decode through the kernel")


# =============================================================================
# phase 6: the engines on the card against the engines on the CPU
# =============================================================================
def _mixed_prompts(vocab: int, seed: int = 3):
    """Mixed-length prompts, the longer ones sharing a 16-token prefix."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    prompts = []
    for n in (4, 10, 24, 40, 4, 24, 33, 17):
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if n >= 24:
            p[:16] = shared
        prompts.append(p)
    return prompts


def _greedy_logits(model, prompt, n_steps: int):
    """Logits of every greedy step of one request, served alone through
    chunked prefill and single decode steps on the model's device."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    bs, C = 8, 16
    n = len(prompt)
    device = next(model.parameters()).device
    arena = R.make_block_arena(model.cfg, 16, bs, dtype=torch.float32,
                               device=device)
    table = torch.arange(1, 16, dtype=torch.int32, device=device)
    for start in range(0, n, C):
        true_c = min(C, n - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :true_c] = prompt[start:start + true_c]
        lg = R.prefill_paged(model, {"tokens": torch.as_tensor(
            chunk, device=device)}, arena, table, start, true_c)
    out = [lg[0, true_c - 1].float().cpu()]
    tok = out[-1].argmax()
    for i in range(n_steps - 1):
        lg = R.decode_paged(
            model, arena, {"tokens": tok.view(1, 1).to(torch.int32).to(
                device)}, table[None], torch.tensor([n + i], dtype=torch.int32,
                                                    device=device),
            torch.tensor([True], device=device))
        out.append(lg[0].float().cpu())
        tok = out[-1].argmax()
    return out


def _equal_streams(what: str, a: dict, b: dict, model, prompts) -> int:
    """Check two engines' greedy streams equal; returns the number of
    divergences that are near-ties.  A differing token is a fault unless
    the CPU logits at that step are a near-tie (top-2 gap within the f32
    tolerance)."""
    import torch
    _check(set(a) == set(b) == set(range(len(prompts))),
           f"{what}: request sets differ")
    ties = 0
    for rid in sorted(b):
        if (a[rid] == b[rid]).all():
            continue
        step = int((a[rid] != b[rid]).argmax())
        lg_c = _greedy_logits(model, prompts[rid], step + 1)[step]
        top = torch.topk(lg_c, 2).values
        gap = float(top[0] - top[1])
        _check(gap <= 1e-4 * max(1.0, float(top[0].abs())),
               f"{what}: rid {rid} differs at step {step} with a top-2 "
               f"logit gap of {gap:.3g} — not a near-tie")
        ties += 1
    return ties


# arena of phase 6's preempted paged engine (block 8): small enough that
# its 8 requests swap out and resume partially (on the CPU: 4 preemptions,
# 3 pages saved; block counts depend on lengths only, not on the device)
PARITY_PREEMPT_BLOCKS = 16


def phase_parity() -> None:
    """SMOKE-size engines on the card (kernels) and on the CPU (plain
    versions), same weights, same prompts: the paged engine on the card
    against the paged engine on the CPU, the slotted engine on the card
    against the slotted engine on the CPU and against the paged engine on
    the card, and a paged engine with preemption on an arena of
    ``PARITY_PREEMPT_BLOCKS`` (swap-outs, partial swap-ins: decode over
    restored pages and prefix pages re-acquired from the radix tree) on
    the card against the same engine on the CPU and against the paged
    engine without preemption on the card — the greedy streams must be
    equal."""
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    cfg = qwen3_1_7b.SMOKE
    fam_cpu = ENG.build_engine_family(cfg, fracs=(1.0,), seed=3,
                                      device="cpu")
    fam_gpu = ENG.build_engine_family(cfg, fracs=(1.0,), seed=3)
    fam_gpu[0].params.load_state_dict(fam_cpu[0].params.state_dict())
    prompts = _mixed_prompts(cfg.vocab_size)
    n_new = 12
    outs, stats = {}, {}
    engines = {"paged": dict(kv_layout="paged"),
               "slotted": dict(kv_layout="slotted"),
               "preempt": dict(kv_layout="paged", preemption=True,
                               n_blocks=PARITY_PREEMPT_BLOCKS)}
    for layout, kw in engines.items():
        for fam, dev in ((fam_gpu, None), (fam_cpu, "cpu")):
            eng = ENG.RealEngine(fam, n_slots=2, max_len=64, block_size=8,
                                 max_seqs=6, device=dev, **kw)
            eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
            key = (layout, dev or "cuda")
            stats[key] = serve_prompts(eng, prompts, n_new=n_new)
            outs[key] = dict(eng.last_outputs)
    model = fam_cpu[0].params
    ties = _equal_streams("parity paged", outs["paged", "cuda"],
                          outs["paged", "cpu"], model, prompts)
    for key in ("prefix_hit_tokens", "prefill_chunks", "decode_steps"):
        _check(stats["paged", "cuda"][key] == stats["paged", "cpu"][key]
               or ties, f"parity: {key} {stats['paged', 'cuda'][key]} vs "
               f"{stats['paged', 'cpu'][key]}")
    ties_s = _equal_streams("parity slotted", outs["slotted", "cuda"],
                            outs["slotted", "cpu"], model, prompts)
    for key in ("decode_steps", "host_syncs", "h2d_transfers"):
        _check(stats["slotted", "cuda"][key] == stats["slotted", "cpu"][key]
               or ties_s, f"parity slotted: {key} "
               f"{stats['slotted', 'cuda'][key]} vs "
               f"{stats['slotted', 'cpu'][key]}")
    ties_sp = _equal_streams("parity slotted/paged", outs["slotted", "cuda"],
                             outs["paged", "cuda"], model, prompts)
    ties_p = _equal_streams("parity preempted", outs["preempt", "cuda"],
                            outs["preempt", "cpu"], model, prompts)
    ties_pp = _equal_streams("parity preempted/paged", outs["preempt", "cuda"],
                             outs["paged", "cuda"], model, prompts)
    m_pre = stats["preempt", "cuda"]
    _check(m_pre["preemptions"] >= 1 and m_pre["partial_swapin_pages_saved"]
           >= 1, f"parity preempted: {m_pre['preemptions']} preemptions, "
           f"{m_pre['partial_swapin_pages_saved']} pages saved")
    for key in ("preemptions", "swapin_pages_copied",
                "partial_swapin_pages_saved", "prefill_chunks"):
        _check(m_pre[key] == stats["preempt", "cpu"][key] or ties_p,
               f"parity preempted: {key} {m_pre[key]} vs "
               f"{stats['preempt', 'cpu'][key]}")
    print(f"parity: on {len(prompts)} requests x {n_new} tokens the SMOKE "
          f"paged engine on the card equals the CPU's ({ties} near-tie "
          f"divergences; prefix hits "
          f"{stats['paged', 'cuda']['prefix_hit_tokens']}), the slotted "
          f"engine on the card equals the CPU's ({ties_s}) and the paged "
          f"engine on the card ({ties_sp}); with preemption on "
          f"{PARITY_PREEMPT_BLOCKS} blocks ({m_pre['preemptions']} "
          f"preemptions, {m_pre['swapin_pages_copied']} pages copied, "
          f"{m_pre['partial_swapin_pages_saved']} saved) the card equals "
          f"the CPU ({ties_p}) and the unpreempted paged engine ({ties_pp})")


# =============================================================================
# phases 7-8: the SSM and hybrid families at full width
# =============================================================================
# largest rms difference allowed between a decode replay's logits at the
# last prompt position and the forward's, as a fraction of the rms of what
# the layers add to the forward's logits (the forward's logits less those
# of the embedding alone, so that neither mamba2's tied self logit nor the
# embedding's share of the logits hides a fault of the layers).
# Readings on the H100 from scripts/replay_sensitivity.py, which puts the
# plain scan or a faulted one in the forward (the decode has no scan):
# bf16: 0.040 (mamba2) and 0.028 (zamba2), and as much with the plain scan
# (0.040, 0.028), which moves the forward itself by 0.038 / 0.027 (so does
# a y 0.02% low): a bf16 rounding that flips anywhere grows through the
# residual stream of 54-64 random layers to ~3-4%, the floor of a bf16
# comparison.  The limit sits 1.5x above that floor; it rejects a scan
# whose y is zero (0.59, 0.41) or, in mamba2, 10% low (0.069), but not a
# 2% error, which the f32 check catches.
# f32 (2 prompts of 256 tokens, at full depth): 4.8e-6 and 3.5e-6, with
# the plain scan 4.7e-6 and 3.7e-6; the limit sits ~20x above them and
# rejects a scan whose y is 0.2% low (7.6e-4, 1.1e-3)
REPLAY_TOL = {"bfloat16": 6e-2, "float32": 1e-4}
# the depth of phases 7-8's f32 replays (their bf16 runs keep the full
# 64 and 54 layers): 256 decode steps a model at full depth took 64 s of
# the script on a slow host; zamba2's 24 layers keep 4 visits of its
# shared block.  scripts/replay_sensitivity.py reads the f32 check at
# these depths
F32_REPLAY_LAYERS = {"mamba2-2.7b": 32, "zamba2-2.7b": 24}


def _counters() -> dict:
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    return {"ssd_chunked": SSD.ssd_chunked,
            "ssd_chunked_bwd": SSD.ssd_chunked_bwd,
            "flash_attention": FA.flash_attention,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "decode_attention": DA.decode_attention}


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _forward_run(tag: str, model, b: int, s: int, per_forward: dict,
                 seed: int, extra: dict = None, fwd=None) -> dict:
    """``registry.forward`` over b random prompts of s tokens (with the
    batch entries ``extra``: an enc-dec's ``src_embeds``, a VLM's
    positions), or the call ``fwd`` (its logits over b x s positions): one
    warm-up call, then one timed call whose kernel launches are counted
    (each kernel of ``per_forward`` exactly that often), then one profiled
    call; returns the timed call's launches."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    cfg = model.cfg
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32), device="cuda")
    if fwd is None:
        def fwd():
            return R.forward(model, {"tokens": tokens, **(extra or {})},
                             cfg)[0]

    fwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t = time.perf_counter()
    lg = fwd()
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check(tuple(lg.shape) == (b, s, cfg.padded_vocab),
           f"{tag}: logits shape {tuple(lg.shape)}")
    _check(bool(torch.isfinite(lg).all()), f"{tag}: non-finite logits")
    for name, n in per_forward.items():
        _check(counts[name] == n, f"{tag}: {counts[name]} {name} launches "
                                  f"in one forward, expected {n}")
    del lg
    device = _device_profile(fwd, 1, t_wall, {
        "ssd kernel": lambda key: "ssd_kernel" in key,
        "flash kernel": lambda key: "flash_tc_kernel" in key})
    print(f"{tag} forward {b} x {s}: {b * s / t_wall:.1f} tokens/s, wall "
          f"{t_wall * 1e3:.1f} ms, host enqueue {t_enqueue * 1e3:.1f} ms, "
          f"peak device memory {peak:.2f} GiB; launches {counts}; {device}")
    return counts


def _step_batch(tokens, positions, i: int) -> dict:
    """A decode step's batch: the token column, and a VLM's (3, b, 1)
    M-RoPE positions of step ``i`` when ``positions`` are given."""
    if positions is None:
        return {"tokens": tokens}
    return {"tokens": tokens, "mrope_positions": positions[:, :, i:i + 1]}


def _replay(model, prompts, cache, positions=None):
    """Feed ``prompts`` (b, n) through ``decode_step`` one position at a
    time (the forward returns no SSM state), with a VLM's M-RoPE
    ``positions`` (3, b, >= n) when given; returns the last position's
    logits and the cache."""
    from repro_torch.models import registry as R
    for i in range(prompts.shape[1]):
        lg, cache = R.decode_step(
            model, cache, _step_batch(prompts[:, i:i + 1], positions, i),
            model.cfg)
    return lg, cache


def _replay_vs_forward(tag: str, model, prompts, lg,
                       extra: dict = None) -> str:
    """Hold a replay's logits ``lg`` at the last prompt position against
    ``registry.forward``'s over the same prompts (and batch entries
    ``extra``: an enc-dec's ``src_embeds``, a VLM's positions), relative
    to what the layers add to them (``REPLAY_TOL`` of the model's type):
    the logits of the last token's embedding alone, through the final norm
    and the head, which an enc-dec model has as well; returns the
    reading."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    cfg = model.cfg
    ref = R.forward(model, {"tokens": prompts, **(extra or {})},
                    cfg)[0][:, -1].float()
    with torch.no_grad():     # the logits of the embedding alone
        base = model.logits(L.embedding_apply(
            model.embed, prompts[:, -1:]))[:, 0].float()
    got = lg.float()
    rel = ((got - ref).norm() / (ref - base).norm()).item()
    share = ((ref - base).norm() / ref.norm()).item()
    err = (got - ref).abs().max().item()
    agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
    tol = REPLAY_TOL[str(cfg.dtype).replace("torch.", "")]
    _check(bool(torch.isfinite(got).all()), f"{tag}: non-finite decode")
    _check(rel <= tol,
           f"{tag}: replayed logits differ from the forward's by {rel:.4g} "
           f"of the layers' part (rms), beyond {tol}")
    return (f"last prompt position against the forward: rms diff {rel:.4g} "
            f"of the layers' part of the logits (tol {tol}; that part is "
            f"{share:.4g} of the logits' rms), max |diff| {err:.4g}, argmax "
            f"agrees on {agree}/{len(got)}")


def _greedy_run(tag: str, model, n_prompt: int, n_new: int, per_step: dict,
                seed: int, b: int = 4, src_embeds=None,
                positions=None) -> dict:
    """Greedy generation through ``make_cache`` and ``decode_step`` (bf16
    cache, the default): b random prompts of n_prompt tokens replayed
    token by token, then n_new tokens — with an enc-dec's ``src_embeds``
    in ``make_cache``, or a VLM's M-RoPE ``positions`` (3, b, n_prompt +
    n_new + 1) one column a step.  The replay is held against the forward
    (``_replay_vs_forward``); every decode step launches each kernel of
    ``per_step`` exactly that often.  Returns the replay's launches."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    cfg = model.cfg
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, n_prompt)).astype(np.int32),
        device="cuda")
    cache = R.make_cache(model, cfg, b, n_prompt + n_new + 1,
                         src_embeds=src_embeds)
    extra = ({"src_embeds": src_embeds} if src_embeds is not None else
             {"mrope_positions": positions[:, :, :n_prompt]}
             if positions is not None else {})
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    lg, cache = _replay(model, prompts, cache, positions)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t
    counts = _counts()            # the replay's
    for name, n in per_step.items():
        _check(counts[name] == n * n_prompt,
               f"{tag}: {counts[name]} {name} launches in {n_prompt} decode "
               f"steps, expected {n} per step")
    reading = _replay_vs_forward(tag, model, prompts, lg, extra)
    tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    out = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for j in range(n_new):
        out.append(tok)
        lg, cache = R.decode_step(
            model, cache, _step_batch(tok, positions, n_prompt + j), cfg)
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t
    gen = torch.cat(out, dim=1)
    _check(tuple(gen.shape) == (b, n_new), f"{tag}: generated shape")
    _check(bool(((gen >= 0) & (gen < cfg.padded_vocab)).all()),
           f"{tag}: token ids out of range")
    _check(int(cache["pos"]) == n_prompt + n_new, f"{tag}: cache position")
    device = _device_profile(
        lambda: R.decode_step(model, cache, _step_batch(
            tok, positions, n_prompt + n_new), cfg), 1,
        t_wall / n_new, {
            "attention kernel (split and merge)":
                lambda key: "decode_split_kernel" in key
                and "ContigKV" in key})
    print(f"{tag} decode (batch {b}): replay of {n_prompt} prompt tokens "
          f"{t_replay / n_prompt * 1e3:.2f} ms/step; {reading}; {n_new} new "
          f"tokens: wall {t_wall / n_new * 1e3:.2f} ms/step, host enqueue "
          f"{t_enqueue / n_new * 1e3:.2f} ms/step, {device}")
    return counts


def _f32_replay_run(tag: str, cfg, seed: int, b: int = 2,
                    n_prompt: int = 256, src_len: int = 0,
                    positions=None) -> None:
    """The model at full width in f32 (weights from the same seed as the
    bf16 one): b prompts of n_prompt tokens — two chunks, so the scan
    carries its state across a chunk boundary — replayed through
    ``decode_step`` with an f32 cache and held against the forward; an
    enc-dec model over ``src_len`` seeded frames, a VLM at M-RoPE
    ``positions`` (3, b, n_prompt) when given."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    cfg = cfg.with_(dtype=torch.float32)
    model = R.init_params(cfg, seed=0)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(b, n_prompt)).astype(np.int32),
        device="cuda")
    src = (torch.as_tensor(rng.standard_normal(
        (b, src_len, cfg.d_model), np.float32), device="cuda")
        if src_len else None)
    cache = R.make_cache(model, cfg, b, n_prompt + 1, src_embeds=src,
                         dtype=torch.float32)
    t = time.perf_counter()
    lg, cache = _replay(model, prompts, cache, positions)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t
    extra = ({"src_embeds": src} if src is not None else
             {"mrope_positions": positions} if positions is not None
             else {})
    reading = _replay_vs_forward(f"{tag} f32", model, prompts, lg, extra)
    print(f"{tag} f32 replay ({cfg.n_layers} layers, batch {b}, {n_prompt} "
          f"tokens, {t_replay / n_prompt * 1e3:.2f} ms/step): {reading}")
    del model, cache
    torch.cuda.empty_cache()


def phase_ssm() -> dict:
    """mamba2-2.7b at full width (64 Mamba2 layers, d_model 2560, d_inner
    5120 = 80 heads of 64, N 128, vocab 50280 padded to 50688, tied), bf16
    weights from the port's seeded init: ``registry.forward`` over 4 x
    4096 and 1 x 32768 tokens (64 ``ssd_chunked`` launches each), and
    greedy generation for 4 prompts of 128 tokens (replayed) plus 8 new
    through ``make_cache`` and ``decode_step``; then the f32 replay check
    (``_f32_replay_run``) at ``F32_REPLAY_LAYERS``' depth; returns the scan's launches over the two timed
    forwards."""
    import torch
    from repro_torch.configs import mamba2_2_7b
    from repro_torch.models import registry as R
    cfg = mamba2_2_7b.FULL
    t0 = time.perf_counter()
    model = R.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ssm: {cfg.name} init {time.perf_counter() - t0:.1f} s, "
          f"{n_params / 1e6:.1f} M params ({cfg.dtype})")
    L = cfg.n_layers
    total = 0
    for b, s in ((4, 4096), (1, 32768)):
        total += _forward_run("ssm", model, b, s, {
            "ssd_chunked": L, "flash_attention": 0}, seed=b)["ssd_chunked"]
    _greedy_run("ssm", model, 128, 8, {"ssd_chunked": 0,
                                        "decode_attention": 0}, seed=7)
    del model
    torch.cuda.empty_cache()
    _f32_replay_run("ssm", cfg.with_(n_layers=F32_REPLAY_LAYERS[cfg.name]),
                    seed=8)
    return {"ssd_chunked": total}


def phase_hybrid() -> dict:
    """zamba2-2.7b at full width (54 Mamba2 layers, N 64, and one shared
    attention + MLP block of 32 heads of 80, d_ff 10240, after every 6;
    vocab 32000, untied), bf16 weights from the port's seeded init:
    ``registry.forward`` over 4 x 4096 tokens (54 ``ssd_chunked`` and 9
    ``flash_attention`` launches) and greedy generation for 4 prompts of
    128 tokens plus 8 new (9 ``decode_attention`` launches a step); then
    the f32 replay check at ``F32_REPLAY_LAYERS``' depth; returns the
    timed forward's launches."""
    import torch
    from repro_torch.configs import zamba2_2_7b
    from repro_torch.models import registry as R
    cfg = zamba2_2_7b.FULL
    t0 = time.perf_counter()
    model = R.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"hybrid: {cfg.name} init {time.perf_counter() - t0:.1f} s, "
          f"{n_params / 1e6:.1f} M params ({cfg.dtype})")
    G = cfg.n_layers // cfg.attn_every
    counts = _forward_run("hybrid", model, 4, 4096, {
        "ssd_chunked": cfg.n_layers, "flash_attention": G}, seed=11)
    _greedy_run("hybrid", model, 128, 8, {"ssd_chunked": 0,
                                           "decode_attention": G}, seed=13)
    del model
    torch.cuda.empty_cache()
    _f32_replay_run("hybrid",
                    cfg.with_(n_layers=F32_REPLAY_LAYERS[cfg.name]), seed=14)
    return counts


# =============================================================================
# phase 9: paged serve with preemption, telemetry and quality selection
# =============================================================================
# arena of each phase-9 instance (block 16): small enough that each rung
# swaps out twice and resumes partially.  Block counts depend only on the
# prompts' lengths, n_new, the block size and the arena, so the value was
# found on the CPU with the SMOKE family at phase 3's lengths: 78 blocks give
# 2 preemptions a rung, 57 pages saved and 15 copied on each; 77 and 79-88
# give fewer than 2 preemptions a rung
PREEMPT_BLOCKS = 78


def _mixed_quality_requests(prompts, n_new: int):
    """Phase 3's prompts twice, interleaved: rid 2k is prompt k as an
    interactive request, rid 2k + 1 the same prompt as a deferrable one."""
    from repro_torch.serving.api import DEFERRABLE, INTERACTIVE, \
        InferenceRequest
    return [InferenceRequest(rid=2 * k + j, prompt=p, max_new_tokens=n_new,
                             slo=slo)
            for k, p in enumerate(prompts)
            for j, slo in enumerate((INTERACTIVE, DEFERRABLE))]


def _timed_serve(eng, requests):
    """Submit ``requests`` and drain the engine, timing each scheduler step
    (``RealEngine.step``) on the host clock; returns (responses, seconds
    of each step)."""
    seconds = []
    step = eng.step

    def timed():
        t = time.perf_counter()
        out = step()
        seconds.append(time.perf_counter() - t)
        return out
    eng.step = timed
    try:
        for req in requests:
            eng.submit(req)
        return eng.drain(), seconds
    finally:
        del eng.step


def _round_trip(inst) -> str:
    """The swap staging pair on the instance's arena, outside the serve:
    gather 5 pages (padded to a bucket of 8 with junk block 0) into pinned
    host memory, scatter them into 5 other blocks (the 3 padded slots write
    zero pages into block 0); the moved pages must equal the originals bit
    for bit."""
    import numpy as np
    import torch
    src, dst = [1, 3, 5, 7, 9], [70, 71, 72, 73, 74]
    idx = np.zeros((8,), np.int64)
    idx[:5] = src
    img_k, img_v = inst._gather_pages(idx)
    hk, hv = img_k.wait(), img_v.wait()
    _check(hk.is_pinned() and hv.is_pinned(), "round trip: image not pinned")
    ar = inst.arena
    _check(bool(ar["k"][:, src].abs().sum() > 0), "round trip: empty pages")
    idx[:5] = dst
    inst._restore_pages(idx, hk[:, :5], hv[:, :5])
    torch.cuda.synchronize()
    for name in ("k", "v"):
        _check(torch.equal(ar[name][:, src], ar[name][:, dst]),
               f"round trip: {name} pages differ after gather and scatter")
        _check(not bool(ar[name][:, 0].any()),
               "round trip: block 0 holds more than the zero padding")
    return (f"5 pages of {tuple(hk.shape[2:])} x {hk.shape[0]} layers "
            f"gathered into pinned memory and scattered into other blocks: "
            f"bit-identical")


def _preempt_engine():
    """Phase 9's engine, configured (warm-up included): qwen3-1.7b at full
    width with bf16 weights from seed 0 on the ladder x0.5 / x1, one paged
    instance a rung with an f32 arena of ``PREEMPT_BLOCKS`` blocks of 16,
    preemption and prefix caching on, a static selector pinning deferrable
    work to x0.5.  Returns (engine, its graph, the selector)."""
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.quality import make_selector
    cfg = qwen3_1_7b.FULL
    family = ENG.build_engine_family(cfg, fracs=(0.5, 1.0), seed=0)
    sel = make_selector("static", pins={"deferrable": "x0.5"})
    eng = ENG.RealEngine(family, max_len=2048, kv_layout="paged",
                         block_size=16, n_blocks=PREEMPT_BLOCKS, max_seqs=8,
                         preemption=True, prefix_caching=True,
                         quality_selector=sel, ci_g_per_kwh=300.0)
    graph = ConfigGraph.from_dict(cfg.name, {("x0.5", 1): 1, ("x1", 1): 1})
    eng.configure(graph)
    return eng, graph, sel


def phase_preempt_serve() -> dict:
    """qwen3-1.7b at full width (bf16 weights) on the ladder x0.5 (14
    layers) and x1 (28), one paged instance each with an f32 arena of
    ``PREEMPT_BLOCKS`` blocks, preemption and prefix caching on, a static
    quality selector pinning deferrable work to x0.5: 16 requests (phase
    3's prompts as interactive and again as deferrable), 48 new tokens
    each.  The serve runs twice on the same instances: without telemetry,
    then with a bundle (trace and carbon feed), whose launches are counted;
    the second must route every request as decided, preempt each rung at
    least twice with a partial swap-in, conserve joules in the responses,
    the trace and the feed, and launch both paged kernels.  Then the swap
    staging pair round-trips pages on x1's arena (``_round_trip``).
    Returns the paged kernels' launches during the telemetry serve."""
    import torch
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.obs import CarbonFeed, Telemetry, TraceRecorder, \
        validate_trace
    from repro_torch.serving.scheduler import latency_percentile
    cfg = qwen3_1_7b.FULL
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, graph, sel = _preempt_engine()
    t_cfg = eng.last_reconfig_s
    torch.cuda.synchronize()
    arena_b = {inst.ev.variant.name: sum(a.numel() * a.element_size()
                                         for a in inst.arena.values())
               for inst in eng.instances}
    print(f"preempt: family + arenas {time.perf_counter() - t0 - t_cfg:.1f} "
          f"s, configure (warmup) {t_cfg:.1f} s; {PREEMPT_BLOCKS} blocks of "
          f"16 an instance, f32: "
          + ", ".join(f"{v} {b / PREEMPT_BLOCKS / 1e6:.3f} MB a block, "
                      f"{b / 1e6:.1f} MB" for v, b in arena_b.items()))
    prompts = _serve_prompts(cfg.vocab_size)
    n_new = 48
    _, steps_plain = _timed_serve(eng, _mixed_quality_requests(prompts,
                                                                n_new))
    m_plain = eng.stats()
    plain_out = dict(eng.last_outputs)
    tel = Telemetry(tracer=TraceRecorder("real-paged"),
                    feed=CarbonFeed(300.0, interval_s=1e9, region="h100"),
                    backend="real-paged")
    eng.telemetry = tel
    eng.configure(graph)                 # fresh allocators and prefix trees
    pre0 = {inst.ev.variant.name: inst.preemptions for inst in eng.instances}
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    FA.paged_prefill_attention.launches = 0
    resps, steps = _timed_serve(eng, _mixed_quality_requests(prompts, n_new))
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": PA.paged_decode_attention.launches,
                "paged_prefill_attention":
                    FA.paged_prefill_attention.launches}
    m = eng.stats()
    n_req = 2 * len(prompts)
    _check(m["served"] == n_req == len(resps),
           f"preempt: served {m['served']} of {n_req}")
    decided = {d.rid: d.variant for d in sel.decisions}
    for r in resps:
        _check(len(r.tokens) == n_new,
               f"preempt: rid {r.rid}: {len(r.tokens)} tokens")
        _check(bool(((r.tokens >= 0) & (r.tokens < cfg.padded_vocab)).all()),
               f"preempt: rid {r.rid}: token ids out of range")
        _check(r.variant == decided[r.rid] == ("x1" if r.slo == "interactive"
                                               else "x0.5"),
               f"preempt: rid {r.rid} ({r.slo}) served on {r.variant}, "
               f"decided {decided[r.rid]}")
    per_rung = {inst.ev.variant.name: inst.preemptions
                - pre0[inst.ev.variant.name] for inst in eng.instances}
    _check(min(per_rung.values()) >= 2 and sum(per_rung.values())
           == m["preemptions"], f"preempt: preemptions per rung {per_rung}, "
           f"session {m['preemptions']}")
    _check(m["partial_swapin_pages_saved"] >= 1,
           "preempt: no page saved by a partial swap-in")
    total_j = sum(r.energy_j for r in resps)
    _check(abs(total_j - m["energy_j"]) <= 1e-9 * m["energy_j"],
           f"preempt: per-request joules {total_j} != session "
           f"{m['energy_j']}")
    summary = validate_trace(tel.tracer, expect_energy_j=m["energy_j"],
                             expect_requests=n_req)
    for name in ("swap_out", "swap_in"):
        n = len(tel.tracer.instants(name))
        _check(n == m["preemptions"],
               f"preempt: {n} {name} instants for {m['preemptions']} "
               f"preemptions")
    tel.feed.flush(eng._feed_clock)
    _check(abs(tel.feed.energy_j_total - m["energy_j"])
           <= 1e-12 * m["energy_j"],
           f"preempt: feed {tel.feed.energy_j_total} J != session "
           f"{m['energy_j']} J")
    _check(all(n > 0 for n in launches.values()),
           f"preempt: a paged kernel was not launched: {launches}")
    _check(m["compile_retraces"] == 0, "preempt: shape missed by warmup")
    same = sum(bool((plain_out[rid] == eng.last_outputs[rid]).all())
               for rid in plain_out)
    reg = eng.last_registry
    swap_ms = {d["phase"]: h.percentile(50.0) * 1e3 for _, d, h in
               reg.labeled_series("phase_latency_s")
               if d["phase"] in ("swap_d2h", "swap_h2d")}
    for slo in ("interactive", "deferrable"):
        rs = [r for r in resps if r.slo == slo]
        ttft = [r.ttft_s for r in rs]
        print(f"preempt: {slo}: {len(rs)} requests on "
              f"{rs[0].variant}, {sum(r.n_tokens for r in rs) / m['wall_s']:.1f}"
              f" tok/s of the session's wall, TTFT p50 "
              f"{latency_percentile(ttft, 50.0) * 1e3:.1f} ms p95 "
              f"{latency_percentile(ttft, 95.0) * 1e3:.1f} ms")
    print(f"preempt: {m['served']} requests, {m['tokens']} tokens in "
          f"{m['wall_s']:.2f} s = {m['tokens_per_s']:.1f} tok/s; "
          f"preemptions {m['preemptions']} (per rung {per_rung}); swap-in "
          f"pages copied "
          f"{m['swapin_pages_copied']}, saved by partial swap-in "
          f"{m['partial_swapin_pages_saved']}; swap p50 D2H "
          f"{swap_ms.get('swap_d2h', float('nan')):.3f} ms H2D "
          f"{swap_ms.get('swap_h2d', float('nan')):.3f} ms (host enqueue); "
          f"decode steps {m['decode_steps']} in {m['decode_dispatches']} "
          f"dispatches; host_syncs {m['host_syncs']}; h2d "
          f"{m['h2d_transfers']}; blocks peak {m['blocks_peak']}; "
          f"{m['j_per_token']:.3f} J/token (reference power model)")
    print(f"preempt: trace {summary['records']} records, "
          f"{summary['spans']} spans, {summary['requests']} request spans "
          f"summing to the session's {summary['energy_j']:.3f} J; feed "
          f"{tel.feed.energy_j_total:.3f} J in {len(tel.feed.snapshots)} "
          f"snapshot(s); streams equal to the serve without telemetry: "
          f"{same}/{len(plain_out)}")
    # the telemetry's host cost: both serves run the same schedule (the
    # same steps, ticks and decode steps), so their steps pair up
    _check(len(steps) == len(steps_plain)
           and m["decode_steps"] == m_plain["decode_steps"],
           f"preempt: {len(steps)} / {len(steps_plain)} steps with and "
           f"without telemetry")
    ratio = sorted(a / b for a, b in zip(steps, steps_plain))
    print(f"preempt: telemetry: {len(steps)} scheduler steps, median "
          f"{sorted(steps)[len(steps) // 2] * 1e3:.2f} ms against "
          f"{sorted(steps_plain)[len(steps) // 2] * 1e3:.2f} ms without a "
          f"bundle, median paired ratio {ratio[len(ratio) // 2]:.4f}; wall "
          f"{m['wall_s']:.3f} s against {m_plain['wall_s']:.3f} s "
          f"({m['wall_s'] / m_plain['wall_s'] - 1:+.3f})")
    print(f"preempt: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"preempt: round trip on x1's arena: "
          f"{_round_trip(eng.instances[-1])}")
    del eng, resps
    torch.cuda.empty_cache()
    return launches


# =============================================================================
# phase 10: the SSM and hybrid families on the card against the CPU
# =============================================================================
# f32 logits of a SMOKE model on the card against the CPU: sums in another
# order (cuBLAS, the SSD kernel), so the port's tolerance against the
# reference
SMOKE_TOL = 2e-4


def _replay_greedy(model, prompt, n_new: int, src_embeds=None,
                   positions=None):
    """Greedy tokens and every step's logits (on the host) of ``prompt``
    (b, n) replayed through ``decode_step`` and continued n_new tokens, on
    the model's device with an f32 cache (an enc-dec's over the frames
    ``src_embeds``, a VLM's at M-RoPE ``positions`` (3, b, n + n_new),
    both host arrays)."""
    import torch
    from repro_torch.models import registry as R
    cfg = model.cfg
    dev = next(model.parameters()).device
    b, n = prompt.shape
    cache = R.make_cache(
        model, cfg, b, n + n_new, dtype=torch.float32, device=dev,
        src_embeds=(None if src_embeds is None
                    else torch.as_tensor(src_embeds, device=dev)))
    pos = None if positions is None else torch.as_tensor(positions,
                                                         device=dev)
    toks = torch.as_tensor(prompt, device=dev)
    lg, cache = _replay(model, toks, cache, pos)
    out, logits = [], []
    for j in range(n_new):
        logits.append(lg.float().cpu())
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok.cpu())
        lg, cache = R.decode_step(model, cache, _step_batch(tok, pos, n + j),
                                  cfg)
    return torch.cat(out, dim=1), logits


def phase_ssm_parity() -> None:
    """mamba2 and zamba2 at SMOKE size (f32), the same weights on the card
    (the SSD and attention kernels) and on the CPU (plain versions): the
    forward logits agree within ``SMOKE_TOL`` and the greedy tokens of a
    replayed 8-token prompt plus 12 new ones are equal (a differing token
    must be a near-tie of the CPU's logits)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry as R
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = get_smoke_config(arch)
        m_cpu = R.init_params(cfg, seed=5, device="cpu")
        m_gpu = R.init_params(cfg, seed=5)
        m_gpu.load_state_dict(m_cpu.state_dict())
        toks = np.random.default_rng(9).integers(
            0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
        _zero_counts()
        lg_g = R.forward(m_gpu, {"tokens": torch.as_tensor(
            toks, device="cuda")}, cfg)[0].float().cpu()
        n_scan = _counts()["ssd_chunked"]
        _check(n_scan == cfg.n_layers,
               f"parity {arch}: {n_scan} scan launches for {cfg.n_layers} "
               f"layers")
        lg_c = R.forward(m_cpu, {"tokens": torch.as_tensor(toks)}, cfg)[0]
        err = (lg_g - lg_c).abs().max().item()
        _check(torch.allclose(lg_g, lg_c, atol=SMOKE_TOL, rtol=SMOKE_TOL),
               f"parity {arch}: forward logits differ by {err:.3g}")
        gen_g, _ = _replay_greedy(m_gpu, toks[:, :8], 12)
        gen_c, lg_steps = _replay_greedy(m_cpu, toks[:, :8], 12)
        ties = 0
        for row in range(gen_c.shape[0]):
            diff = (gen_g[row] != gen_c[row]).nonzero()
            if len(diff) == 0:
                continue
            step = int(diff[0])
            top = torch.topk(lg_steps[step][row], 2).values
            gap = float(top[0] - top[1])
            _check(gap <= 1e-4 * max(1.0, float(top[0].abs())),
                   f"parity {arch}: row {row} differs at step {step} with "
                   f"a top-2 logit gap of {gap:.3g} — not a near-tie")
            ties += 1
        print(f"parity {arch}: SMOKE forward on the card against the CPU "
              f"max |diff| {err:.3g} (tol {SMOKE_TOL}); greedy tokens of 2 "
              f"rows x 12 equal ({ties} near-tie divergences)")


# =============================================================================
# phase 11: Clover's fleet and trace simulator on the port
# =============================================================================
FLEET_REGIONS = ("CISO-March", "ESO-March")
# the full-width fleet's engines: 2 slots of 160 positions give each paged
# instance an arena of 2 x 160 / 16 + 1 = 21 blocks of 16 (20 usable), so a
# window's 4 probes of 64 + 16 tokens (5 pages each) fit on one instance
FLEET_SLOTS, FLEET_MAX_LEN = 2, 160


class _ProbeLog:
    """Records, for every ``RealWindowServer`` of a fleet run, each
    configuration it applies (in order) and each probe window: region
    (its trace's name), window time, chips, served, tokens, and the
    per-rid greedy tokens, rungs, selector reasons and policy holds (the
    seconds a held probe waited).  Installed around one run; the methods
    are restored on exit."""

    def __init__(self, BK):
        self.cls = BK.RealWindowServer
        self.configs, self.probes = [], []

    def __enter__(self):
        apply, probe = self.cls.apply_config, self.cls.probe_window
        log = self

        def apply_logged(server, g):
            if server._configured_edges != g.edges:
                log.configs.append((server.acct.trace.name, g.edges))
            return apply(server, g)

        def probe_logged(server, g, t=0.0):
            m = probe(server, g, t)
            entry = {"region": server.acct.trace.name, "t": t,
                     "chips": g.total_chips}
            if m is not None:
                eng = server.engine
                entry.update(
                    served=int(m["served"]), tokens=int(m["tokens"]),
                    outputs={rid: [int(x) for x in v]
                             for rid, v in eng.last_outputs.items()},
                    variants={r.rid: r.variant for r in eng.last_responses},
                    reasons={rid: why for rid, _, why in
                             (eng.quality_selector.decision_sequence()
                              if eng.quality_selector is not None else ())},
                    held={r.rid: r.held_s for r in eng.last_responses
                          if r.release_reason is not None})
            log.probes.append(entry)
            return m
        self.saved = apply, probe
        self.cls.apply_config, self.cls.probe_window = apply_logged, \
            probe_logged
        return self

    def __exit__(self, *exc):
        self.cls.apply_config, self.cls.probe_window = self.saved
        return False

    def served(self, region: str) -> list:
        return [p for p in self.probes if p["region"] == region
                and "served" in p]


def _fleet_config(**kw):
    """The full-width fleet's configuration: one block a region, 10-minute
    windows, the paged engine under the carbon-forecast policy with the
    greedy quality selector, half of each window's 4 probes deferrable,
    probes of 64 prompt + 16 new tokens.  ``lam=1.0`` weighs carbon enough
    that the controllers mix all three rungs (at the default 0.1 they keep
    x1 everywhere); the 200 g clean-grid threshold lies between the two
    traces (CISO-March ~285-305 g, ESO-March ~130-170 g), so the selector
    downshifts CISO-March's deferrable probes and leaves ESO-March's on
    the best rung configured.  Both outcomes depend only on the traces
    and the variants' records, not on timing (found on the CPU with these
    records over SMOKE models)."""
    from repro_torch.fleet import fleet_sim as FS
    return FS.FleetConfig(
        n_blocks=1, window_s=600.0, backend="real",
        engine_kv_layout="paged", engine_policy="carbon_forecast",
        engine_quality_selector="greedy", probe_deferrable_frac=0.5,
        deferrable_frac=0.1, n_jobs=2, min_slack_s=1800.0,
        max_slack_s=3600.0, probe_prompt_len=64, probe_new_tokens=16,
        engine_slots=FLEET_SLOTS, engine_max_len=FLEET_MAX_LEN, lam=1.0,
        engine_ci_threshold_g=200.0, **kw)


def _fleet_run(family, cfg, traces):
    """``run_fleet`` over ``traces`` with ``family`` as every region's
    ladder, logged; returns (report, log, seconds)."""
    from repro_torch.fleet import fleet_sim as FS
    from repro_torch.serving import backends as BK
    with _ProbeLog(BK) as log:
        t0 = time.perf_counter()
        rep = FS.run_fleet("efficientnet", traces, cfg,
                           engine_family=family)
        if next(family[0].params.parameters()).is_cuda:
            import torch
            torch.cuda.synchronize()
        return rep, log, time.perf_counter() - t0


def _check_fleet(tag: str, rep, log, cfg, n_windows: int) -> None:
    """What every real-backend fleet run must show: every region probed
    once a window, ``real_served`` = probes x windows not suspended, the
    jobs' deadlines met, >= 2 warm reconfigurations, measured joules in
    every region that served, and the rollup conserving energy and carbon
    bit for bit."""
    for name, r in rep.regions.items():
        calls = [p for p in log.probes if p["region"] == name]
        active = log.served(name)
        _check(len(calls) == n_windows,
               f"{tag}: {name} probed {len(calls)} times in {n_windows} "
               f"windows")
        _check(len(active) == sum(p["chips"] > 0 for p in calls),
               f"{tag}: {name}: a window with chips served nothing")
        _check(r.real_served == cfg.probe_requests * len(active)
               == sum(p["served"] for p in active),
               f"{tag}: {name} served {r.real_served} probes in "
               f"{len(active)} windows of {cfg.probe_requests}")
        for p in active:
            _check(all(len(v) == cfg.probe_new_tokens
                       for v in p["outputs"].values()),
                   f"{tag}: {name} at {p['t']}: short token stream")
        if r.real_served:
            _check(r.real_energy_j > 0.0 and r.real_p95_s > 0.0,
                   f"{tag}: {name} served without joules or latency")
    _check(rep.deadlines_met, f"{tag}: deadline misses "
           f"{rep.deadline_misses}")
    n_reconf = sum(r.real_reconfigs for r in rep.regions.values())
    _check(n_reconf >= 2 and n_reconf == len(log.configs),
           f"{tag}: {n_reconf} real reconfigurations, {len(log.configs)} "
           f"logged")
    totals = rep.rollup.conservation()
    _check(totals["energy_j"] == sum(r.energy_j
                                     for r in rep.regions.values()),
           f"{tag}: rollup energy {totals['energy_j']}")


def phase_fleet() -> dict:
    """Clover's carbon-aware fleet (``fleet.fleet_sim.run_fleet``) with the
    real backend on the card at the full width of qwen3-1.7b: the ladder
    x0.25 / x0.5 / x1 (7, 14, 28 layers) in bf16 from seed 0, shared by two
    regions (CISO-March, ESO-March; 2 h traces, seed 3, 12 windows of 10
    minutes), each with its own controller (CLOVER, reconfiguring its
    paged ``RealEngine`` warm through ``Controller.maybe_reoptimize``), the
    carbon-forecast scheduling policy and the greedy quality selector over
    the region's forecaster.  Checks (``_check_fleet``), that probes were
    served on more than one rung and at least one was downshifted by the
    selector, and the launches of both paged kernels; returns those
    launches.  The carbon policy's holds are counted, not checked: a 2 h
    trace gives the forecaster too little history to forecast a valley in
    the windows served, so it releases every probe at once."""
    import torch
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core import carbon as CB
    from repro_torch.core import catalog as CAT
    from repro_torch.core import slices as SL
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving import engine as ENG
    full = qwen3_1_7b.FULL
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    family = ENG.build_engine_family(full, fracs=(1.0, 0.5, 0.25), seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    # the reference's slice model prices memory at 4 bytes a parameter:
    # every rung must still fit a 1-chip slice, or the optimizer could
    # never partition the block
    for ev in family:
        _check(1 in CAT.feasible_slices(ev.variant),
               f"fleet: {ev.variant.name} ({ev.variant.mem_gb:.2f} GB) "
               f"fits no 1-chip slice")
    cfg = _fleet_config()
    # arena budget: every instance has its own f32 arena on the one card;
    # at most 3 blocks x 16 one-chip instances a region
    n_blocks = -(-FLEET_SLOTS * FLEET_MAX_LEN // 16) + 1
    block_b = {ev.variant.name: 2 * 16 * full.n_kv_heads * full.d_head * 4
               * ev.cfg.n_layers for ev in family}
    worst = (len(FLEET_REGIONS) * cfg.resolved_max_blocks()
             * SL.BLOCK_CHIPS * n_blocks * max(block_b.values()))
    weights_b = sum(p.numel() * p.element_size() for ev in family
                    for p in ev.params.parameters())
    print(f"fleet: ladder "
          + ", ".join(f"{ev.variant.name} {ev.cfg.n_layers} layers "
                      f"{ev.variant.params_m:.0f} M params "
                      f"({ev.variant.mem_gb:.2f} GB priced, slices "
                      f"{CAT.feasible_slices(ev.variant)})"
                      for ev in family)
          + f"; built in {t_build:.1f} s, {weights_b / 2**30:.2f} GiB bf16; "
          f"arena {n_blocks} blocks of 16 an instance ("
          + ", ".join(f"{v} {n_blocks * b / 2**20:.1f} MiB"
                      for v, b in block_b.items())
          + f"), at most {worst / 2**30:.2f} GiB for "
          f"{len(FLEET_REGIONS)} regions x {cfg.resolved_max_blocks()} "
          f"blocks x {SL.BLOCK_CHIPS} x1 instances")
    traces = {r: CB.make_trace(r, hours=2.0, seed=3) for r in FLEET_REGIONS}
    n_windows = int(round(2.0 * 3600.0 / cfg.window_s))
    PA.paged_decode_attention.launches = 0
    FA.paged_prefill_attention.launches = 0
    rep, log, secs = _fleet_run(family, cfg, traces)
    launches = {"paged_decode_attention": PA.paged_decode_attention.launches,
                "paged_prefill_attention":
                    FA.paged_prefill_attention.launches}
    _check_fleet("fleet", rep, log, cfg, n_windows)
    _check(all(n > 0 for n in launches.values()),
           f"fleet: a paged kernel was not launched: {launches}")
    served = [p for p in log.probes if "served" in p]
    _check(len({v for p in served for v in p["variants"].values()}) >= 2,
           "fleet: every probe was served on one rung")
    n_down = sum(why == "downshift" for p in served
                 for why in p["reasons"].values())
    _check(n_down >= 1, "fleet: the selector downshifted no probe")
    for name, r in rep.regions.items():
        toks = sum(p["tokens"] for p in log.served(name))
        rungs = {}
        for p in log.served(name):
            for v in p["variants"].values():
                rungs[v] = rungs.get(v, 0) + 1
        why = {}
        for p in log.served(name):
            for w in p["reasons"].values():
                why[w] = why.get(w, 0) + 1
        held = [h for p in log.served(name) for h in p["held"].values()]
        print(f"fleet: {name}: {r.real_served} probes served in "
              f"{len(log.served(name))} of {n_windows} windows, by rung "
              f"{dict(sorted(rungs.items()))}, selector {why}, "
              f"{sum(h > 0 for h in held)} held "
              f"({max(held, default=0.0):.3f} s at most), "
              f"real p95 {r.real_p95_s * 1e3:.1f} ms, "
              f"{r.real_energy_j / max(toks, 1):.3f} J/token (reference "
              f"power model), {r.real_reconfigs} warm reconfigurations in "
              f"{r.real_reconfig_s:.2f} s, {r.n_invocations} invocations "
              f"({r.n_predictive} predictive), final blocks "
              f"{r.final_blocks}; fluid carbon {r.carbon_g:.1f} g, p95 "
              f"{r.p95_s * 1e3:.2f} ms")
    print(f"fleet: configurations applied: "
          + "; ".join(f"{reg} {dict(e)}" for reg, e in log.configs))
    print(f"fleet: {rep.real_served} probes, real p95 "
          f"{rep.real_p95_s * 1e3:.1f} ms, deadlines met "
          f"{rep.deadlines_met} ({rep.jobs_total} jobs), rollup "
          f"conserved; launches {launches}; run {secs:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del family, rep, log
    torch.cuda.empty_cache()
    return launches


def _stream_ties(tag: str, a: dict, b: dict, variants: dict, models: dict,
                 prompts: dict) -> int:
    """Two runs' per-rid greedy streams must be equal; a differing token is
    allowed only at a near-tie of the CPU logits (as ``_equal_streams``).
    Returns the number of near-tie divergences."""
    import torch
    _check(set(a) == set(b), f"{tag}: request sets differ")
    ties = 0
    for rid in sorted(b):
        if a[rid] == b[rid]:
            continue
        step = next(i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                    if x != y)
        lg = _greedy_logits(models[variants[rid]], prompts[rid],
                            step + 1)[step]
        top = torch.topk(lg, 2).values
        gap = float(top[0] - top[1])
        _check(gap <= 1e-4 * max(1.0, float(top[0].abs())),
               f"{tag}: rid {rid} differs at step {step} with a top-2 "
               f"logit gap of {gap:.3g} — not a near-tie")
        ties += 1
    return ties


def phase_fleet_parity() -> dict:
    """The fleet at the reference's real-backend defaults (SMOKE widths, 2
    layers, f32, slotted engines, ``fifo``) for one region (CISO-March, 1
    h, 6 windows), once with the ladder on the card (the contiguous
    kernels) and once with the same weights on the CPU (plain versions):
    the configurations applied, in order, must be equal, and so must the
    per-rid greedy token streams, ``real_served``, the tokens and every
    fluid field of the report.  Returns the contiguous kernels' launches
    on the card."""
    import numpy as np
    from repro_torch.core import carbon as CB
    from repro_torch.fleet import fleet_sim as FS
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving import backends as BK
    cfg = FS.FleetConfig(n_blocks=1, window_s=600.0, backend="real",
                         deferrable_frac=0.1, n_jobs=2, min_slack_s=1800.0,
                         max_slack_s=3600.0)
    fam_cpu = BK.build_real_family(cfg.engine_arch, cfg.engine_layers,
                                   seed=cfg.seed, device="cpu")
    fam_gpu = BK.build_real_family(cfg.engine_arch, cfg.engine_layers,
                                   seed=cfg.seed)
    for g, c in zip(fam_gpu, fam_cpu):
        g.params.load_state_dict(c.params.state_dict())
    runs = {}
    for dev, fam in (("cuda", fam_gpu), ("cpu", fam_cpu)):
        traces = {"CISO-March": CB.make_trace("CISO-March", hours=1.0,
                                              seed=3)}
        if dev == "cuda":
            DA.decode_attention.launches = 0
            FA.flash_attention.launches = 0
        runs[dev] = _fleet_run(fam, cfg, traces)
        if dev == "cuda":
            launches = {"decode_attention": DA.decode_attention.launches,
                        "flash_attention_f32": FA.flash_attention.launches}
        _check_fleet(f"fleet parity ({dev})", runs[dev][0], runs[dev][1],
                     cfg, 6)
    (rg, lg, sg), (rc, lc, sc) = runs["cuda"], runs["cpu"]
    _check(lg.configs == lc.configs,
           "fleet parity: configurations differ between card and CPU")
    pg, pc = lg.served("CISO-March"), lc.served("CISO-March")
    _check([(p["t"], p["served"], p["tokens"]) for p in pg]
           == [(p["t"], p["served"], p["tokens"]) for p in pc],
           "fleet parity: served or tokens differ between card and CPU")
    vocab = fam_cpu[0].cfg.vocab_size
    rng = np.random.default_rng(cfg.seed)
    prompts = {rid: rng.integers(0, vocab, size=(cfg.probe_prompt_len,))
               .astype(np.int32)
               for rid in range(cfg.probe_requests * len(pc))}
    models = {ev.variant.name: ev.params for ev in fam_cpu}
    ties = 0
    for a, b in zip(pg, pc):
        _check(a["variants"] == b["variants"],
               f"fleet parity: rungs differ at {a['t']}")
        ties += _stream_ties(f"fleet parity at {a['t']}", a["outputs"],
                             b["outputs"], b["variants"], models, prompts)
    for f in ("carbon_g", "served_interactive", "served_deferrable",
              "accuracy", "p95_s", "deadline_misses", "real_served"):
        _check(getattr(rg, f) == getattr(rc, f),
               f"fleet parity: {f} {getattr(rg, f)} vs {getattr(rc, f)}")
    _check(all(n > 0 for n in launches.values()),
           f"fleet parity: a contiguous kernel was not launched: {launches}")
    print(f"fleet parity: SMOKE fleet (slotted, f32, fifo) on the card "
          f"equals the CPU's: {len(lg.configs)} configurations in order, "
          f"{rg.real_served} probes in {len(pg)} windows, "
          f"{sum(p['tokens'] for p in pg)} tokens, per-rid streams equal "
          f"({ties} near-tie divergences); card {sg:.1f} s, CPU {sc:.1f} s, "
          f"real p95 card {rg.real_p95_s * 1e3:.1f} ms, CPU "
          f"{rc.real_p95_s * 1e3:.1f} ms; launches {launches}")
    return launches


def phase_sim() -> None:
    """``python -m repro_torch.launch.serve --mode sim --hours 6``: Clover
    against BASE over a 6 h trace in the fluid simulator (no device); its
    JSON must parse, with finite numbers and at least one invocation."""
    import math
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "sim",
         "--hours", "6"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    _check(out.returncode == 0, f"sim: exit {out.returncode}: "
           f"{out.stderr[-2000:]}")
    res = json.loads(out.stdout)
    nums = [v for v in res.values() if isinstance(v, float)]
    _check(len(nums) == 4 and all(math.isfinite(v) for v in nums)
           and res["invocations"] >= 1, f"sim: {res}")
    print(f"sim: --mode sim --hours 6 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(res)}")


# =============================================================================
# phase 12: the rest of the dense family (gemma3-27b, glm4-9b, qwen2-0.5b)
# =============================================================================
# arena of the gemma3 serve: 400 blocks of 16 positions (6.5 GB in f32 at
# gemma3's 62 layers x 16 KV heads x 128): the 4 requests' 4,836 positions
# (303 blocks without the shared prefix) with headroom
DENSE_BLOCKS = 400
# largest rms difference allowed between the chunked paged prefill's
# logits and registry.forward's over the last 200 positions of a
# 1400-token prompt (1200..1399, where gemma3's window of 1024 hides the
# first 176-375 keys from a local layer), as a fraction of the rms of what
# the layers add to the forward's logits (as REPLAY_TOL reads it).
# Readings on the H100 (two calls, the same to four digits): 0.0346, the
# floor of a bf16 comparison through 62 random layers (the forward's K/V
# are bf16, the chunked prefill's arena f32); with the local layers'
# window dropped from the chunked prefill 0.0790 (0.0723 over 1024..1399,
# 0.0824 at the last position alone).  The limit sits 1.45x above the
# floor and 1.58x below the dropped window's reading.
DENSE_PREFILL_TOL = 5e-2
DENSE_CHECK_FROM = 1200


def _dense_prompts(vocab: int, seed: int = 7,
                   lengths=(1040, 1400, 1200, 1100)):
    """Prompts of ``lengths`` tokens (by default 4 of 1040-1400, all past
    gemma3's window of 1024), those longer than 256 sharing a 256-token
    prefix."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=256).astype(np.int32)
    prompts = []
    for n in lengths:
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if n > 256:
            p[:256] = shared
        prompts.append(p)
    return prompts


def _paged_counts() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    return {"paged_decode_attention": PA.paged_decode_attention,
            "paged_prefill_attention": FA.paged_prefill_attention}


def _dense_serve(tag: str, cfg, prompts, n_new: int, max_seqs: int,
                 **engine_kw):
    """One paged engine of ``cfg`` at full width (bf16 weights from seed 0,
    f32 arena) serving ``prompts``, ``max_seqs`` rows at a time (fewer
    than the prompts: a later one reuses the first ones' shared prefix
    from the prefix cache): the phase 3 checks, and both paged kernels'
    launches (all, and with a window) during the serve.  Returns (engine,
    stats, launches, windowed launches)."""
    import torch
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    t0 = time.perf_counter()
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0)
    eng = ENG.RealEngine(family, max_len=2048, kv_layout="paged",
                         block_size=16, max_seqs=max_seqs, **engine_kw)
    t_cfg = eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
    torch.cuda.synchronize()
    print(f"{tag}: family + arena {time.perf_counter() - t0 - t_cfg:.1f} s, "
          f"configure (warmup) {t_cfg:.1f} s, "
          f"{family[0].variant.params_m:.1f} M params")
    for fn in _paged_counts().values():
        fn.launches = fn.windowed_launches = 0
    m = serve_prompts(eng, prompts, n_new=n_new)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in _paged_counts().items()}
    windowed = {k: fn.windowed_launches for k, fn in _paged_counts().items()}
    resps = eng.last_responses
    _check(m["served"] == len(prompts) == len(resps),
           f"{tag}: served {m['served']} of {len(prompts)}")
    for r in resps:
        _check(len(r.tokens) == n_new,
               f"{tag}: rid {r.rid}: {len(r.tokens)} tokens")
        _check(bool(((r.tokens >= 0) & (r.tokens < cfg.padded_vocab)).all()),
               f"{tag}: rid {r.rid}: token ids out of range")
    _check(m["prefix_hit_tokens"] > 0, f"{tag}: no prefix-cache hit")
    total_j = sum(r.energy_j for r in resps)
    _check(abs(total_j - m["energy_j"]) <= 1e-9 * m["energy_j"],
           f"{tag}: per-request joules {total_j} != session {m['energy_j']}")
    _check(all(n > 0 for n in launches.values()),
           f"{tag}: a kernel was not launched on the main path: {launches}")
    _check(m["host_syncs"] == 0, f"{tag}: {m['host_syncs']} host syncs")
    _check(m["compile_retraces"] == 0, f"{tag}: shape missed by warmup")
    print(f"{tag}: {m['served']} requests, {m['tokens']} tokens in "
          f"{m['wall_s']:.2f} s = {m['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{m['ttft_p50_s'] * 1e3:.1f} ms p95 {m['ttft_p95_s'] * 1e3:.1f} "
          f"ms; decode steps {m['decode_steps']} in "
          f"{m['decode_dispatches']} dispatches; prefill chunks "
          f"{m['prefill_chunks']}; prefix hits {m['prefix_hit_tokens']} "
          f"tokens; host_syncs {m['host_syncs']}; {m['j_per_token']:.3f} "
          f"J/token (reference power model); launches {launches}, with a "
          f"window {windowed}")
    return eng, m, launches, windowed


def _chunked_prefill_logits(model, prompt, chunk: int):
    """Logits of every position of ``prompt`` through chunked paged prefill
    (``registry.prefill_paged``, chunks of ``chunk`` tokens) into an f32
    arena of its own, as the engine prefills."""
    import torch
    from repro_torch.models import registry as R
    n, bs = len(prompt), 16
    span = -(-n // bs)
    arena = R.make_block_arena(model.cfg, span + 1, bs, dtype=torch.float32)
    table = torch.arange(1, span + 1, dtype=torch.int32, device="cuda")
    toks = torch.as_tensor(prompt, device="cuda")
    out = []
    for start in range(0, n, chunk):
        true_c = min(chunk, n - start)
        piece = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
        piece[0, :true_c] = toks[start:start + true_c]
        out.append(R.prefill_paged(model, {"tokens": piece}, arena, table,
                                   start, true_c)[0, :true_c])
    del arena
    return torch.cat(out)


def _window_dropped():
    """The local layers' window dropped (their rotary base kept)."""
    import contextlib
    from repro_torch.models import transformer as T

    @contextlib.contextmanager
    def patch():
        pattern = T.layer_pattern
        T.layer_pattern = lambda c: (0 * pattern(c)[0], pattern(c)[1])
        try:
            yield
        finally:
            T.layer_pattern = pattern
    return patch()


def _prefill_vs_forward(model, prompt, chunk: int, variants: dict,
                        start: int) -> dict:
    """Hold the chunked paged prefill's logits at the positions from
    ``start`` against ``registry.forward``'s (contiguous flash) over the
    same prompt, relative to what the layers add to them, once under each
    context of ``variants`` (label -> a function returning a context
    manager in which the chunked prefill runs).  Returns the readings and
    the forward's flash launches (all, windowed)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    cfg = model.cfg
    toks = torch.as_tensor(prompt[None], device="cuda")
    FA.flash_attention.launches = FA.flash_attention.windowed_launches = 0
    ref = R.forward(model, {"tokens": toks}, cfg)[0][0, start:].float()
    n_flash = (FA.flash_attention.launches,
               FA.flash_attention.windowed_launches)
    with torch.no_grad():     # the logits of the embedding alone
        base = model.logits(L.embedding_apply(model.embed,
                                              toks[:, start:]))[0].float()
    layers = (ref - base).norm()

    def reading(got):
        return ((got[start:].float() - ref).norm() / layers).item()

    out = {"flash": n_flash}
    for label, variant in variants.items():
        with variant():
            out[label] = reading(_chunked_prefill_logits(model, prompt,
                                                         chunk))
    return out


def _paged_profiles(tag: str, eng, prompt, n_blocks: int,
                    ranges: dict = None) -> None:
    """Profiles of one fused 8-step decode dispatch (4 rows, 1400
    positions of context, inactive: every write goes to the junk block) and
    one 128-token prefill chunk at n_past 1280 of ``prompt`` on the first
    instance of the paged engine ``eng``: wall, host enqueue, device busy,
    the attention kernels' share (and ``_device_profile``'s ``ranges``),
    beside the step's weight-bytes bound (every parameter but the
    embedding table read once at 3.35 TB/s)."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    inst = eng.instances[0]
    model = inst.params
    w_bytes = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n != "embed")
    bound_ms = w_bytes / HBM_BYTES_S * 1e3
    B, ctx = 4, 1400
    pages = -(-ctx // inst.block_size)
    tables = np.zeros((B, inst.n_pages), np.int32)
    tables[:, :pages] = 1 + np.arange(B * pages).reshape(B, pages) % (
        n_blocks - 1)
    args = [torch.as_tensor(a, device=inst.device) for a in
            (np.zeros((B, 1), np.int32), tables,
             np.full((B,), ctx, np.int32), np.zeros((B,), bool))]

    def dispatch():
        return R.decode_paged_multi(model, inst.arena, {"tokens": args[0]},
                                    *args[1:], 8)[0]

    n_past, C = 1280, inst.chunk_tokens
    table = torch.as_tensor(1 + np.arange(128) % (n_blocks - 1),
                            dtype=torch.int32, device=inst.device)
    chunk = torch.as_tensor(prompt[None, n_past:n_past + C],
                            device=inst.device)

    def prefill_chunk():
        return R.prefill_paged(model, {"tokens": chunk}, inst.arena, table,
                               n_past, C)

    for what, fn, steps, kernel in (
            (f"decode step (batch {B}, {ctx} tokens of context)", dispatch,
             8, lambda key: "decode_split_kernel" in key and "PagedKV" in key),
            (f"prefill chunk ({C} tokens at n_past {n_past})", prefill_chunk,
             1, lambda key: "paged_prefill" in key)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        t_enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t
        if out.is_floating_point():
            _check(bool(torch.isfinite(out).all()), f"{tag}: non-finite "
                   f"logits of the {what}")
        device = _device_profile(fn, steps, t_wall,
                                 {"attention kernels": kernel}, ranges)
        print(f"{tag} {what}: wall {t_wall / steps * 1e3:.2f} ms, host "
              f"enqueue {t_enqueue / steps * 1e3:.2f} ms, weight-bytes "
              f"bound {bound_ms:.2f} ms ({w_bytes / 1e9:.2f} GB), {device}")


def phase_dense() -> dict:
    """The rest of the dense family at full width, bf16 weights: gemma3-27b
    (62 layers, d 5376, 32 heads over 16 KV heads, 52 local layers of
    window 1024 and 10 global) through the paged engine (``DENSE_BLOCKS``
    of f32 arena, chunks of 128 tokens) serving 4 requests of 1040-1400
    prompt tokens and 16 new; the profiles of one fused 8-step decode
    dispatch and one prefill chunk; the chunked prefill of a 1400-token
    prompt held to ``registry.forward`` (``DENSE_PREFILL_TOL``), and the
    same with the window dropped rejected; then a short paged serve of
    glm4-9b (g = 16) and of qwen2-0.5b.  Returns the paged kernels'
    launches over the three serves and the forward's flash launches."""
    import torch
    from repro_torch.configs import gemma3_27b, glm4_9b, qwen2_0_5b
    from repro_torch.models import transformer as T
    cfg = gemma3_27b.FULL
    n_local = int((T.layer_pattern(cfg)[0] > 0).sum())
    torch.cuda.reset_peak_memory_stats()
    prompts = _dense_prompts(cfg.vocab_size)
    eng, m, launches, windowed = _dense_serve(
        "dense gemma3-27b", cfg, prompts, 16, 3, n_blocks=DENSE_BLOCKS,
        chunk_blocks=8)
    L = cfg.n_layers
    for name in launches:
        _check(launches[name] % L == 0 and windowed[name] * L
               == launches[name] * n_local,
               f"dense gemma3-27b: {windowed[name]} of {launches[name]} "
               f"{name} launches with a window, expected {n_local} of "
               f"every {L}")
    print(f"dense gemma3-27b: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _paged_profiles("dense gemma3-27b", eng, prompts[1], DENSE_BLOCKS)
    model = eng.family["x1"].params
    del eng
    torch.cuda.empty_cache()
    t = time.perf_counter()
    r = _prefill_vs_forward(model, prompts[1], 128,
                            {"kept": contextlib.nullcontext,
                             "dropped": _window_dropped}, DENSE_CHECK_FROM)
    _check(r["flash"] == (L, n_local),
           f"dense: forward flash launches (all, windowed) {r['flash']}, "
           f"expected ({L}, {n_local})")
    _check(r["kept"] <= DENSE_PREFILL_TOL,
           f"dense: chunked paged prefill differs from the forward by "
           f"{r['kept']:.4g} of the layers' part (rms), beyond "
           f"{DENSE_PREFILL_TOL}")
    _check(r["dropped"] > DENSE_PREFILL_TOL,
           f"dense: with the local layers' window dropped the chunked "
           f"prefill still reads {r['dropped']:.4g}, inside "
           f"{DENSE_PREFILL_TOL}: the check does not see the window")
    print(f"dense gemma3-27b: chunked paged prefill of {len(prompts[1])} "
          f"tokens against registry.forward at positions "
          f"{DENSE_CHECK_FROM}..: rms diff {r['kept']:.4g} of the layers' "
          f"part (tol {DENSE_PREFILL_TOL}); with the window dropped "
          f"{r['dropped']:.4g} ({time.perf_counter() - t:.1f} s)")
    del model
    torch.cuda.empty_cache()
    launches["flash_attention"] = r["flash"][0]
    # glm4-9b (32 heads over 2 KV heads: two row-chunks a group) and
    # qwen2-0.5b (14 over 2, dh 64): a short paged serve each
    short = [_serve_prompts(glm4_9b.FULL.vocab_size)[i] for i in (1, 0, 2, 3)]
    for tag, c in (("dense glm4-9b", glm4_9b.FULL),
                   ("dense qwen2-0.5b", qwen2_0_5b.FULL)):
        torch.cuda.reset_peak_memory_stats()
        eng, _, more, _ = _dense_serve(tag, c, short, 16, 3, n_blocks=160,
                                       chunk_blocks=8)
        print(f"{tag}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if c is glm4_9b.FULL:        # phase 18b on this model
            _add_launches(phase_split_decode_full(eng.family["x1"].params))
        for name, n in more.items():
            launches[name] += n
        del eng
        torch.cuda.empty_cache()
    _add_launches(phase_split_decode_f32())     # phase 18b in f32
    return launches


# =============================================================================
# phase 13: the dense family's SMOKE configs on the card against the CPU
# =============================================================================
def phase_dense_parity() -> dict:
    """The dense family's SMOKE configs (gemma3, glm4, qwen2, and glm4 with
    16 query heads over one KV head: the decode kernels' two row-chunks)
    on the card against the CPU with the same weights: the paged and the
    slotted engines' greedy streams, and ``make_cache`` / ``decode_step``
    greedy tokens after a replayed prompt, equal (a differing token must
    be a near-tie of the CPU's logits), the forward's logits within
    ``SMOKE_TOL``.  Returns the contiguous kernels' launches on the card."""
    variants = [(a, a, {}) for a in ("gemma3-27b", "glm4-9b", "qwen2-0.5b")]
    variants.append(("glm4-9b g=16", "glm4-9b",
                     dict(n_heads=16, n_kv_heads=1, d_head=16)))
    return _smoke_parity("dense parity", variants, strict=False)


def _decode_ties(tag: str, gen_g, gen_c, lg_steps) -> int:
    """Rows whose greedy tokens on the card (``gen_g``) differ from the
    CPU's (``gen_c``), each at a near-tie of the CPU's logits at the first
    differing step (``lg_steps``, from ``_replay_greedy``); raises for a
    difference that is not one."""
    import torch
    ties = 0
    for row in range(gen_c.shape[0]):
        diff = (gen_g[row] != gen_c[row]).nonzero()
        if len(diff) == 0:
            continue
        step = int(diff[0])
        top = torch.topk(lg_steps[step][row], 2).values
        gap = float(top[0] - top[1])
        _check(gap <= 1e-4 * max(1.0, float(top[0].abs())),
               f"{tag}: decode_step row {row} differs at step {step} "
               f"with a top-2 logit gap of {gap:.3g} — not a near-tie")
        ties += 1
    return ties


def _smoke_parity(prefix: str, variants, strict: bool) -> dict:
    """SMOKE ``variants`` ((label, arch, overrides)) on the card against
    the CPU with the same weights: both engines' greedy streams equal, the
    forward's logits and aux within ``SMOKE_TOL``, and ``decode_step``'s
    greedy tokens of 2 rows x 12 after a 12-token replay equal (a differing
    token must be a near-tie of the CPU's logits at that step, which ran
    the same batch).  With ``strict`` an engine stream must be equal token
    for token: the near-tie oracle serves one request alone, which for an
    MoE model is another batch, so it would not say what the engine's
    logits were.  Returns the contiguous kernels' launches on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry as R
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    counts = {"decode_attention": 0, "flash_attention_f32": 0}
    for label, arch, kw in variants:
        cfg = get_smoke_config(arch).with_(**kw)
        tag = f"{prefix} {label}"
        fam_cpu = ENG.build_engine_family(cfg, fracs=(1.0,), seed=3,
                                          device="cpu")
        fam_gpu = ENG.build_engine_family(cfg, fracs=(1.0,), seed=3)
        fam_gpu[0].params.load_state_dict(fam_cpu[0].params.state_dict())
        prompts = _mixed_prompts(cfg.vocab_size)
        model = fam_cpu[0].params
        ties = {}
        for layout in ("paged", "slotted"):
            outs = {}
            for fam, dev in ((fam_gpu, None), (fam_cpu, "cpu")):
                eng = ENG.RealEngine(fam, n_slots=2, max_len=64, block_size=8,
                                     max_seqs=6, device=dev,
                                     kv_layout=layout)
                eng.configure(ConfigGraph.from_dict(cfg.name,
                                                    {("x1", 1): 1}))
                DA.decode_attention.launches = FA.flash_attention.launches = 0
                serve_prompts(eng, prompts, n_new=12)
                if dev is None:       # the card's serve, configure excluded
                    counts["decode_attention"] += DA.decode_attention.launches
                    counts["flash_attention_f32"] += (
                        FA.flash_attention.launches)
                outs[dev or "cuda"] = dict(eng.last_outputs)
            if strict:
                _check(set(outs["cuda"]) == set(outs["cpu"]),
                       f"{tag} {layout}: request sets differ")
                for rid, toks in outs["cpu"].items():
                    _check((outs["cuda"][rid] == toks).all(),
                           f"{tag} {layout}: rid {rid} differs: "
                           f"{outs['cuda'][rid]} on the card, {toks} on "
                           f"the CPU")
            else:
                ties[layout] = _equal_streams(f"{tag} {layout}",
                                              outs["cuda"], outs["cpu"],
                                              model, prompts)
        # the generic entry points: forward logits, then greedy decode
        toks = np.random.default_rng(9).integers(
            0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
        lg_g, aux_g = R.forward(fam_gpu[0].params, {"tokens": torch.as_tensor(
            toks, device="cuda")}, model.cfg)
        lg_g = lg_g.float().cpu()
        lg_c, aux_c = R.forward(model, {"tokens": torch.as_tensor(toks)},
                                model.cfg)
        err = (lg_g - lg_c).abs().max().item()
        _check(torch.allclose(lg_g, lg_c, atol=SMOKE_TOL, rtol=SMOKE_TOL),
               f"{tag}: forward logits differ by {err:.3g}")
        _check(abs(float(aux_g) - float(aux_c)) <= SMOKE_TOL * max(
            1.0, abs(float(aux_c))), f"{tag}: forward aux {float(aux_g)} "
               f"on the card, {float(aux_c)} on the CPU")
        DA.decode_attention.launches = 0
        gen_g, _ = _replay_greedy(fam_gpu[0].params, toks[:, :12], 12)
        counts["decode_attention"] += DA.decode_attention.launches
        gen_c, lg_steps = _replay_greedy(model, toks[:, :12], 12)
        ties["decode_step"] = _decode_ties(tag, gen_g, gen_c, lg_steps)
        print(f"{tag}: on {len(prompts)} requests x 12 tokens the paged and "
              f"slotted engines on the card equal the CPU's, and the "
              f"decode_step greedy tokens of 2 rows x 12 (near-tie "
              f"divergences {ties}); forward max |diff| {err:.3g} (tol "
              f"{SMOKE_TOL}), aux {float(aux_g):.6g} / {float(aux_c):.6g}")
    return counts


# =============================================================================
# phase 14: the MoE family (qwen3-moe-30b-a3b, qwen2-moe-a2.7b)
# =============================================================================
# qwen3-moe's serve: 6 prompts of 300-1400 tokens sharing a 256-token
# prefix, 4 rows at a time (decode groups of at most 4 rows: drop-free, C =
# gsz; prefill chunks of 128 tokens: C = 10 of 128, pairs drop); an f32
# arena of 400 blocks of 16 positions (1.26 GB at 48 layers x 4 KV heads x
# 128)
MOE_LENGTHS = (300, 1400, 700, 1000, 450, 1200)
MOE_BLOCKS = 400
# largest rms difference allowed between the chunked paged prefill's
# logits and registry.forward's over a 1400-token prompt (every position),
# both at a drop-free capacity, as a fraction of the rms of what the layers
# add to the forward's logits (as DENSE_PREFILL_TOL reads it).  Readings
# on the H100 (scripts/moe_prefill_sensitivity.py and two calls of this
# phase): 0.0902, the floor of a bf16 comparison through 48 random MoE
# layers, where a rounding moves a token's router off a near-tie and it
# takes another expert (0.07% of the tokens at the first layer, ~10% at
# the last; f32 at 2 layers reads 4.6e-6 with no token moved); with
# unnormalised gates 0.667; the chunked prefill at the config's own
# capacity, where chunk groups drop pairs, 0.236.  The limit sits 1.66x
# above the floor and 4.4x below the unnormalised gates.
MOE_PREFILL_TOL = 0.15
# qwen2-moe's serve: 10 prompts of 64-512 tokens, 8 rows at a time: a
# decode group of 8 rows has C = 4 of 8 (not drop-free)
MOE2_LENGTHS = (300, 64, 512, 128, 400, 256, 96, 480, 350, 200)
MOE2_BLOCKS = 240


def _moe_ranges() -> dict:
    """The MoE layer's pieces, for ``_device_profile``'s ranges."""
    from repro_torch.models import moe as M
    return {"moe (all)": (M, "moe_apply"), "router": (M, "_route"),
            "dispatch": (M, "_dispatch"), "expert products": (M, "_experts"),
            "combine": (M, "_combine")}


def _unnormalised_gates():
    """A wrong MoE: the top-k probabilities used as gates without their
    renormalisation."""
    from repro_torch.models import moe as M

    @contextlib.contextmanager
    def patch():
        route = M._route

        def wrong(p, x, cfg):
            probs, _, idx = route(p, x, cfg)
            return probs, probs.gather(-1, idx), idx
        M._route = wrong
        try:
            yield
        finally:
            M._route = route
    return patch()


def phase_moe() -> dict:
    """The MoE family at full width, bf16 weights from seed 0.  (a)
    qwen3-moe-30b-a3b (48 layers, 128 experts top-8, 32 heads over 4)
    through the paged engine (``MOE_BLOCKS`` of f32 arena, chunks of 128
    tokens, 4 rows) serving 6 requests of 300-1400 prompt tokens and 16
    new, with the ``_dense_serve`` checks; peak memory; the profiles of one
    fused decode dispatch and one prefill chunk.  (b) The chunked prefill
    of a 1400-token prompt held to ``registry.forward`` at a drop-free
    capacity (``MOE_PREFILL_TOL``), the same with unnormalised gates
    rejected, and the reading at the config's own capacity printed.  (c)
    qwen2-moe-a2.7b (60 routed experts padded to 64, 4 shared, g = 1)
    through the paged engine with 8 rows, whose decode groups drop.
    Returns the paged kernels' launches over the two serves and the
    forward's flash launches."""
    import torch
    from repro_torch.configs import qwen2_moe_a2_7b, qwen3_moe_30b_a3b
    from repro_torch.models import registry as R
    cfg = qwen3_moe_30b_a3b.FULL
    tag = "moe qwen3-moe-30b-a3b"
    torch.cuda.reset_peak_memory_stats()
    prompts = _dense_prompts(cfg.vocab_size, lengths=MOE_LENGTHS)
    eng, _, launches, _ = _dense_serve(tag, cfg, prompts, 16, 4,
                                       n_blocks=MOE_BLOCKS, chunk_blocks=8)
    print(f"{tag}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _paged_profiles(tag, eng, prompts[1], MOE_BLOCKS, _moe_ranges())
    model = eng.family["x1"].params
    del eng
    torch.cuda.empty_cache()

    # (b) the chunked prefill against the forward, both drop-free
    f = cfg.padded_experts / cfg.top_k
    free = cfg.with_(capacity_factor=f)

    @contextlib.contextmanager
    def own_capacity():
        model.cfg = cfg
        try:
            yield
        finally:
            model.cfg = free

    t = time.perf_counter()
    model.cfg = free
    try:
        r = _prefill_vs_forward(model, prompts[1], 128,
                                {"kept": contextlib.nullcontext,
                                 "unnormalised": _unnormalised_gates,
                                 "own capacity": own_capacity}, 0)
    finally:
        model.cfg = cfg
    print(f"{tag}: chunked paged prefill of {len(prompts[1])} tokens against "
          f"registry.forward, both at capacity_factor {f:g} (drop-free): rms "
          f"diff {r['kept']:.4g} of the layers' part (tol "
          f"{MOE_PREFILL_TOL}); with unnormalised gates "
          f"{r['unnormalised']:.4g}; the chunked prefill at the config's own "
          f"capacity (pairs drop) {r['own capacity']:.4g}, not checked "
          f"({time.perf_counter() - t:.1f} s)")
    _check(r["flash"] == (cfg.n_layers, 0),
           f"moe: forward flash launches (all, windowed) {r['flash']}")
    _check(r["kept"] <= MOE_PREFILL_TOL,
           f"moe: chunked paged prefill differs from the forward by "
           f"{r['kept']:.4g} of the layers' part (rms), beyond "
           f"{MOE_PREFILL_TOL}")
    _check(r["unnormalised"] > MOE_PREFILL_TOL,
           f"moe: with unnormalised gates the chunked prefill still reads "
           f"{r['unnormalised']:.4g}, inside {MOE_PREFILL_TOL}: the check "
           f"does not see the gates")
    del model
    torch.cuda.empty_cache()
    launches["flash_attention"] = r["flash"][0]

    # (c) qwen2-moe-a2.7b: 8 rows, decode groups of 8 with C = 4
    cfg2 = qwen2_moe_a2_7b.FULL
    tag = "moe qwen2-moe-a2.7b"
    torch.cuda.reset_peak_memory_stats()
    calls = []                   # (rows, active) of every fused dispatch
    multi = R.decode_paged_multi

    def counting(params, arena, batch, tables, lengths, active, n_steps):
        calls.append((batch["tokens"].shape[0], active))
        return multi(params, arena, batch, tables, lengths, active, n_steps)

    R.decode_paged_multi = counting
    try:
        eng, _, more, _ = _dense_serve(
            tag, cfg2, _dense_prompts(cfg2.vocab_size, lengths=MOE2_LENGTHS),
            16, 8, n_blocks=MOE2_BLOCKS, chunk_blocks=8)
    finally:
        R.decode_paged_multi = multi
    # the serve's dispatches (warmup's have no active row), by row bucket
    rows = [b for b, active in calls if bool(active.any())]
    by_rows = {b: rows.count(b) for b in sorted(set(rows))}
    _check(8 in by_rows, f"{tag}: no decode dispatch of 8 rows: {by_rows}")
    print(f"{tag}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the serve's "
          f"decode dispatches by rows {by_rows} (8 rows: C = 4)")
    for name, n in more.items():
        launches[name] += n
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_moe_parity() -> dict:
    """(d) The MoE family's SMOKE configs, and qwen3-moe SMOKE with top-1
    routing (a decode capacity of half the group: rows compete), on the
    card against the CPU with the same weights, strictly: both engines'
    streams equal token for token, the forward's logits and aux within
    ``SMOKE_TOL``, ``decode_step``'s greedy tokens equal.  Returns the
    contiguous kernels' launches on the card."""
    variants = [(a, a, {}) for a in ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")]
    variants.append(("qwen3-moe-30b-a3b top-1", "qwen3-moe-30b-a3b",
                     {"top_k": 1}))
    return _smoke_parity("moe parity", variants, strict=True)


# =============================================================================
# phase 15: prefill/decode disaggregation (serving.disagg)
# =============================================================================
# (a)'s traffic: 16 prompts of 200-1000 tokens, every other one (those of
# 550 tokens and more) opening with a shared 256-token preamble, 48 new
# tokens each
DISAGG_LENGTHS = (200, 1000, 250, 900, 300, 800, 350, 700, 400, 600, 450,
                  550, 500, 650, 220, 980)
# (b)'s arena (blocks of 16, for both workers; the prefill worker holds
# one 1024-token prompt): found on the CPU, since block counts depend on
# lengths only — phase 3's 8 prompts with 64 new tokens each swap out 3
# times on the decode worker (72 blocks: 1, 78: 2, 80: 2; at 66-68 the
# 1088-token sequence cannot fit beside its own growth and swaps itself
# out forever)
DISAGG_DECODE_BLOCKS = 75


def _disagg_prompts(vocab: int, seed: int = 11):
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=256).astype(np.int32)
    prompts = []
    for i, n in enumerate(DISAGG_LENGTHS):
        p = rng.integers(0, vocab, size=n).astype(np.int32)
        if i % 2:
            p[:256] = shared
        prompts.append(p)
    return prompts


def _disagg_checks(tag: str, eng, m, resps, n_req: int) -> None:
    """What every disaggregated serve must show: one handoff a request, the
    staged pages summed, the role joules conserving (the port's
    ``check_disagg_conservation``) and splitting each response's joules,
    handoffs outside the preemption counts, and every worker's arena
    whole and free after the drain."""
    from repro_torch.obs.validate import check_disagg_conservation
    _check(m["served"] == n_req == len(resps),
           f"{tag}: served {m['served']} of {n_req}")
    _check(m["handoffs"] == n_req, f"{tag}: {m['handoffs']} handoffs")
    staged = sum(i.handoff_pages for i in eng.instances
                 if i.role == "prefill")
    _check(m["handoff_pages"] == staged,
           f"{tag}: {m['handoff_pages']} handoff pages, {staged} staged")
    check_disagg_conservation(m)
    _check(m["both_energy_j"] == 0.0 and m["handoff_energy_j"] > 0.0,
           f"{tag}: role joules {m['both_energy_j']} / "
           f"{m['handoff_energy_j']}")
    for r in resps:
        _check(abs(sum(r.energy_by_role.values()) - r.energy_j)
               <= 1e-9 * r.energy_j, f"{tag}: rid {r.rid}: role joules "
               f"{r.energy_by_role} != {r.energy_j}")
    _check(sum(r.preemptions for r in resps) == m["preemptions"],
           f"{tag}: response preemptions != {m['preemptions']}")
    for inst in eng.instances:
        _check(all(s is None for s in inst.rows) and not inst._inflight,
               f"{tag}: {inst.role} worker not drained")
        if inst.prefix is not None:
            inst.prefix.clear()
        inst.alloc.check()
        _check(inst.alloc.num_free == inst.alloc.num_allocatable,
               f"{tag}: {inst.role} worker's blocks not all free")


def _disagg_summary(tag: str, eng, m, resps) -> str:
    """tok/s, TTFT, the handoffs' wall (their joules are charged at busy
    power, so J / (chips x P_BUSY_W) is their wall exactly) against the
    requests' latency, pages per handoff, and the four role joules."""
    from repro_torch.core import perf_model as PM
    chips = eng.instances[0].chips
    handoff_s = m["handoff_energy_j"] / (chips * PM.P_BUSY_W)
    mean_lat = sum(r.latency_s for r in resps) / len(resps)
    per_req = handoff_s / max(m["handoffs"], 1)
    return (f"{tag}: {m['served']} requests, {m['tokens']} tokens in "
            f"{m['wall_s']:.2f} s = {m['tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{m['ttft_p50_s'] * 1e3:.1f} ms p95 {m['ttft_p95_s'] * 1e3:.1f}"
            f" ms; handoffs {m['handoffs']}, {m['handoff_pages']} pages "
            f"({m['handoff_pages'] / max(m['handoffs'], 1):.1f} a handoff), "
            f"wall {per_req * 1e3:.3f} ms a request = "
            f"{per_req / mean_lat:.5f} of its mean latency "
            f"{mean_lat:.3f} s; preemptions {m['preemptions']}; pages "
            f"copied at placement {m['swapin_pages_copied']}, re-acquired "
            f"from the decode tree {m['partial_swapin_pages_saved']}; role "
            f"joules prefill {m['prefill_energy_j']:.3f} decode "
            f"{m['decode_energy_j']:.3f} handoff {m['handoff_energy_j']:.4f} "
            f"both {m['both_energy_j']:.1f} of {m['energy_j']:.3f} J "
            f"(reference power model)")


def _disagg_engine(family, cfg_name: str, **kw):
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.serving import engine as ENG
    eng = ENG.RealEngine(family, max_len=2048, kv_layout="paged",
                         block_size=16, max_seqs=8, chunk_blocks=8, **kw)
    eng.configure(ConfigGraph.from_dict(cfg_name, {("x1", 1): 1}))
    return eng


def phase_disagg() -> dict:
    """Prefill/decode disaggregation, ``RealEngine(kv_layout="paged",
    roles=(1, 1))``: one prefill and one decode worker on the card, the
    handoff staged through host memory on one stream.  (a) qwen3-1.7b at
    full width with f32 weights (TF32 off, f32 arenas of 600 blocks):
    16 requests (``_disagg_prompts``), 48 new tokens each; every stream
    equal to a monolithic paged engine's on the same weights, 16 handoffs,
    no preemption, some preamble pages re-acquired from the decode-side
    radix tree, both paged kernels launched.  (b) the same model in bf16
    on a starved arena (``DISAGG_DECODE_BLOCKS``) with preemption: phase
    3's 8 prompts, 64 new tokens each, at least 2 preemptions, all on the
    decode worker.  (c) the SMOKE config disaggregated on the card against
    the CPU with the same weights, strictly, roomy and on phase 6's starved
    arena.  Returns the paged kernels' launches in the disaggregated serves
    on the card."""
    import torch
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    from repro_torch.serving.disagg import DisaggEngine
    launches = {name: 0 for name in _paged_counts()}

    def serve(eng, prompts, n_new, count: bool):
        for fn in _paged_counts().values():
            fn.launches = 0
        m = serve_prompts(eng, prompts, n_new=n_new)
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        seen = {k: fn.launches for k, fn in _paged_counts().items()}
        if count:
            for k, n in seen.items():
                launches[k] += n
        return m, seen

    # (a) full width, f32: token identity with the monolithic engine
    cfg = qwen3_1_7b.FULL.with_(dtype=torch.float32)
    t0 = time.perf_counter()
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0)
    prompts = _disagg_prompts(cfg.vocab_size)
    mono = _disagg_engine(family, cfg.name, n_blocks=600)
    m_mono, _ = serve(mono, prompts, 48, count=False)
    out_mono = dict(mono.last_outputs)
    del mono
    eng = _disagg_engine(family, cfg.name, n_blocks=600, roles=(1, 1))
    _check(isinstance(eng, DisaggEngine), "roles= built no DisaggEngine")
    m, seen = serve(eng, prompts, 48, count=True)
    resps = eng.last_responses
    _check(set(eng.last_outputs) == set(out_mono), "disagg a: request sets")
    for rid, toks in out_mono.items():
        _check(len(toks) == 48 and (eng.last_outputs[rid] == toks).all(),
               f"disagg a: rid {rid} differs from the monolithic engine: "
               f"{eng.last_outputs[rid]} against {toks}")
    _check(m["preemptions"] == 0, f"disagg a: {m['preemptions']} preemptions")
    _check(m["partial_swapin_pages_saved"] > 0,
           "disagg a: no page re-acquired from the decode-side radix tree")
    _check(all(n > 0 for n in seen.values()),
           f"disagg a: a paged kernel was not launched: {seen}")
    _check(m["compile_retraces"] == 0, "disagg a: shape missed by warmup")
    _disagg_checks("disagg a", eng, m, resps, len(prompts))
    print(_disagg_summary("disagg a (f32)", eng, m, resps))
    print(f"disagg a: the {len(prompts)} streams equal the monolithic "
          f"engine's ({m_mono['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{m_mono['ttft_p50_s'] * 1e3:.1f} ms); launches {seen}; "
          f"{time.perf_counter() - t0:.1f} s")
    del eng, family, resps
    torch.cuda.empty_cache()

    # (b) full width, bf16: a starved decode arena preempts after handoff
    cfg = qwen3_1_7b.FULL
    t0 = time.perf_counter()
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0)
    eng = _disagg_engine(family, cfg.name, n_blocks=DISAGG_DECODE_BLOCKS,
                         preemption=True, roles=(1, 1))
    prompts = _serve_prompts(cfg.vocab_size)
    m, seen = serve(eng, prompts, 64, count=True)
    resps = eng.last_responses
    per_role = {i.role: i.preemptions for i in eng.instances}
    _check(m["preemptions"] >= 2 and per_role["decode"] == m["preemptions"]
           and per_role["prefill"] == 0,
           f"disagg b: preemptions {m['preemptions']}, by worker {per_role}")
    for r in resps:
        _check(len(r.tokens) == 64 and bool(((r.tokens >= 0) & (
            r.tokens < cfg.padded_vocab)).all()),
            f"disagg b: rid {r.rid}: {r.tokens}")
    _check(all(n > 0 for n in seen.values()),
           f"disagg b: a paged kernel was not launched: {seen}")
    _disagg_checks("disagg b", eng, m, resps, len(prompts))
    print(_disagg_summary("disagg b (bf16, starved decode arena)", eng, m,
                          resps))
    print(f"disagg b: {DISAGG_DECODE_BLOCKS} blocks a worker, preemptions "
          f"by worker {per_role}; launches {seen}; "
          f"{time.perf_counter() - t0:.1f} s")
    del eng, family, resps
    torch.cuda.empty_cache()

    # (c) SMOKE on the card against the CPU, strictly
    from repro_torch.core.config_graph import ConfigGraph
    cfg = qwen3_1_7b.SMOKE
    fam_cpu = ENG.build_engine_family(cfg, fracs=(1.0,), seed=3,
                                      device="cpu")
    fam_gpu = ENG.build_engine_family(cfg, fracs=(1.0,), seed=3)
    fam_gpu[0].params.load_state_dict(fam_cpu[0].params.state_dict())
    prompts = _mixed_prompts(cfg.vocab_size)
    for label, kw in (("roomy", {}),
                      ("starved", dict(preemption=True,
                                       n_blocks=PARITY_PREEMPT_BLOCKS))):
        outs, stats = {}, {}
        for fam, dev in ((fam_gpu, None), (fam_cpu, "cpu")):
            eng = ENG.RealEngine(fam, n_slots=2, max_len=64, block_size=8,
                                 max_seqs=6, kv_layout="paged", roles=(1, 1),
                                 device=dev, **kw)
            eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
            stats[dev], _ = serve(eng, prompts, 12, count=dev is None)
            _disagg_checks(f"disagg c {label}", eng, stats[dev],
                           eng.last_responses, len(prompts))
            outs[dev] = dict(eng.last_outputs)
        for rid, toks in outs["cpu"].items():
            _check((outs[None][rid] == toks).all(),
                   f"disagg c {label}: rid {rid} differs: {outs[None][rid]} "
                   f"on the card, {toks} on the CPU")
        for key in ("handoffs", "handoff_pages", "preemptions",
                    "swapin_pages_copied", "partial_swapin_pages_saved"):
            _check(stats[None][key] == stats["cpu"][key],
                   f"disagg c {label}: {key} {stats[None][key]} on the "
                   f"card, {stats['cpu'][key]} on the CPU")
        _check(label == "roomy" or stats[None]["preemptions"] >= 1,
               "disagg c starved: no preemption")
        print(f"disagg c {label}: SMOKE disaggregated on the card equals the "
              f"CPU on {len(prompts)} requests x 12 tokens: "
              f"{stats[None]['handoffs']} handoffs, "
              f"{stats[None]['handoff_pages']} pages, "
              f"{stats[None]['preemptions']} preemptions")
    print(f"disagg: launches in the disaggregated serves on the card "
          f"{launches}")
    return launches


# =============================================================================
# phase 16: the enc-dec family (seamless-m4t-large-v2) and the VL family's
# M-RoPE (qwen2-vl-7b) through the generic entry points
# =============================================================================
# seamless-m4t-large-v2's attention: 16 heads of 64 over 16 KV heads (g =
# 1); its forward runs 4 prompts of 1000 source frames and 256 target
# tokens
ENCDEC_ATTN = dict(K=16, g=1, dh=64)
ENCDEC_SRC, ENCDEC_TGT = 1000, 256
# qwen2-vl-7b's: 28 heads of 128 over 4 KV heads (g = 7)
VL_ATTN = dict(K=4, g=7, dh=128)


def _grid_positions(b: int, n0: int, gh: int, gw: int, n1: int):
    """qwen2-vl's M-RoPE positions of n0 text tokens, an image of gh x gw
    patches and n1 text tokens: text ``0 .. n0 - 1`` on all three streams,
    the patches at temporal ``n0``, height ``n0 + i``, width ``n0 + j``,
    the text after them from ``n0 + max(gh, gw)``.  Returns the (3, b, s)
    int32 positions and the (b, s) bool mask of the image's positions, as
    host arrays."""
    import numpy as np
    t = list(range(n0)) + [n0] * (gh * gw)
    h = list(range(n0)) + [n0 + i for i in range(gh) for _ in range(gw)]
    w = list(range(n0)) + [n0 + j for _ in range(gh) for j in range(gw)]
    rest = list(range(n0 + max(gh, gw), n0 + max(gh, gw) + n1))
    pos = np.array([t + rest, h + rest, w + rest], np.int32)
    mask = np.zeros(pos.shape[1], bool)
    mask[n0:n0 + gh * gw] = True
    return (np.broadcast_to(pos[:, None], (3, b, pos.shape[1])).copy(),
            np.broadcast_to(mask, (b, mask.size)).copy())


def phase_encdec_vl_kernels() -> None:
    """Phase 16a: the two contiguous kernels in the forms and at the
    widths the enc-dec and VL families give them, each held to its plain
    version at ``TOL`` and timed beside it, one SDPA call and its bound,
    in f32 and bf16: the flash kernel full (not causal) at seamless's
    widths (``ENCDEC_ATTN``) — encoder self-attention over 4 x 1000
    frames (a ragged last key block) and 4 x 1024, cross-attention of 256
    queries over 1000 keys and of 1000 queries over 37 keys; the
    contiguous decode at those widths, batch 4, over S = 1000 at one
    shared () length 1000 (cross-attention decode) and over S = 97 at 60;
    the causal flash over 2 x 1024 tokens at qwen2-vl's widths
    (``VL_ATTN``: g = 7, dh = 128), and both decodes there at batch 8 over
    rows of 1-2048 positions."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    full = dict(ENCDEC_ATTN, b=4, causal=False)
    cases = ([("flash", (1000, 0), d, full) for d in (f32, bf16)]
             + [("flash", (1024, 0), d, full) for d in (f32, bf16)]
             + [("flash", (256, 0), d, dict(full, skv=1000))
                for d in (f32, bf16)]
             + [("flash", (1000, 0), d, dict(full, skv=37))
                for d in (f32, bf16)]
             + [("contig_decode", 4, d, dict(ENCDEC_ATTN, S=S, lengths=n))
                for d in (f32, bf16) for S, n in ((1000, 1000), (97, 60))]
             + [("flash", (1024, 0), d, dict(VL_ATTN, b=2))
                for d in (f32, bf16)]
             + [(kind, 8, d, dict(VL_ATTN, lengths=DENSE_LENGTHS))
                for d in (f32, bf16)
                for kind in ("decode", "contig_decode")])
    _kernel_cases(cases, {})


def phase_encdec(smi: str) -> dict:
    """Phase 16b: seamless-m4t-large-v2 at full width (24 encoder and 24
    decoder layers, d_model 1024, GELU MLP of 8192, vocab 256206 padded to
    256512, untied), bf16 weights from the port's seeded init.
    ``registry.forward`` over 4 x (1000 seeded source frames + 256 target
    tokens): 72 flash launches (24 encoder, 24 decoder self, 24 cross);
    ``make_cache(src_embeds=)``: 24 (its encoder pass); greedy decode of 4
    prompts of 64 replayed tokens and 16 new: 48 decode launches a step (24
    self, 24 cross) and no flash, the replay held to the forward; then the
    f32 replay (batch 2, 64 tokens).  Returns the launches counted."""
    import numpy as np
    import torch
    from repro_torch.configs import seamless_m4t_large_v2
    from repro_torch.models import registry as R
    cfg = seamless_m4t_large_v2.FULL
    t0 = time.perf_counter()
    model = R.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"encdec: {cfg.name} init {time.perf_counter() - t0:.1f} s, "
          f"{n_params / 1e6:.1f} M params ({cfg.dtype}) on {smi}")
    L, b = cfg.n_layers, 4
    src = torch.as_tensor(np.random.default_rng(21).standard_normal(
        (b, ENCDEC_SRC, cfg.d_model), np.float32), device="cuda")
    tag = f"encdec [{smi}]"       # the card beside every number
    fwd = _forward_run(f"{tag} ({ENCDEC_SRC} source frames)", model, b,
                       ENCDEC_TGT, {"flash_attention": cfg.n_enc_layers
                                    + 2 * L, "decode_attention": 0},
                       seed=22, extra={"src_embeds": src})
    _zero_counts()
    t = time.perf_counter()
    cache = R.make_cache(model, cfg, b, 8, src_embeds=src)
    torch.cuda.synchronize()
    t_cache = time.perf_counter() - t
    enc = _counts()
    _check(enc["flash_attention"] == cfg.n_enc_layers
           and enc["decode_attention"] == 0,
           f"encdec make_cache: launches {enc}, expected "
           f"{cfg.n_enc_layers} flash")
    shape = (L, b, ENCDEC_SRC, cfg.n_kv_heads, cfg.d_head)
    _check(tuple(cache["xk"].shape) == shape
           and cache["xk"].dtype == torch.bfloat16
           and bool(torch.isfinite(cache["xk"]).all()
                    and torch.isfinite(cache["xv"]).all()),
           f"encdec make_cache: xk {tuple(cache['xk'].shape)} "
           f"{cache['xk'].dtype}")
    print(f"encdec make_cache: encoder pass and cross K/V of {L} layers "
          f"{t_cache * 1e3:.1f} ms; launches {enc}")
    del cache
    rep = _greedy_run(tag, model, 64, 16, {
        "decode_attention": 2 * L, "flash_attention": 0}, seed=23, b=b,
        src_embeds=src)
    del model, src
    torch.cuda.empty_cache()
    _f32_replay_run(tag, cfg, seed=24, b=2, n_prompt=64,
                    src_len=ENCDEC_SRC)
    return {"flash_attention": fwd["flash_attention"]
            + enc["flash_attention"],
            "decode_attention": rep["decode_attention"]}


def phase_vl(smi: str) -> dict:
    """Phase 16c: qwen2-vl-7b at full width (28 layers, d_model 3584, 28
    heads of 128 over 4 KV heads, QKV bias, M-RoPE sections (16, 24, 24),
    vocab 152064), bf16 weights from the port's seeded init.
    ``forward_lm`` on ``inputs_embeds = merge_patch_embeds(...)`` over 2 x
    1024 positions — 64 text tokens, a 24 x 24 grid of 576 seeded patch
    embeddings, 384 text tokens — at ``_grid_positions``: 28 flash
    launches.  Greedy decode of 4 prompts of 128 tokens (64 text and an
    8 x 8 grid of token ids at grid positions) replayed with each step's
    positions, then 16 new tokens whose positions continue from 72: 28
    decode launches a step, the replay held to ``registry.forward``
    on the same tokens and positions; then the f32 replay (batch 1, 64
    text tokens and an 8 x 8 grid).  Returns the launches counted."""
    import numpy as np
    import torch
    from repro_torch.configs import qwen2_vl_7b
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    cfg = qwen2_vl_7b.FULL
    t0 = time.perf_counter()
    model = R.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vl: {cfg.name} init {time.perf_counter() - t0:.1f} s, "
          f"{n_params / 1e6:.1f} M params ({cfg.dtype}) on {smi}")
    b, n0, grid, n1 = 2, 64, 24, 384
    pos, mask = (torch.as_tensor(a, device="cuda")
                 for a in _grid_positions(b, n0, grid, grid, n1))
    s = pos.shape[2]
    rng = np.random.default_rng(31)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, s))
                             .astype(np.int32), device="cuda")
    patches = torch.as_tensor(rng.standard_normal(
        (b, grid * grid, cfg.d_model), np.float32),
        device="cuda").to(cfg.dtype)

    def fwd():
        emb = T.merge_patch_embeds(L.embedding_apply(model.embed, tokens),
                                   patches, mask)
        return T.forward_lm(model, None, mrope_positions=pos,
                            inputs_embeds=emb)[0]

    tag = f"vl [{smi}]"           # the card beside every number
    counts = _forward_run(f"{tag} ({grid} x {grid} patches merged)", model,
                          b, s, {"flash_attention": cfg.n_layers,
                                 "decode_attention": 0}, seed=32, fwd=fwd)
    del pos, mask, tokens, patches
    n_prompt, n_new, b = 64 + 8 * 8, 16, 4
    steps = torch.as_tensor(_grid_positions(b, 64, 8, 8, n_new + 1)[0],
                            device="cuda")
    rep = _greedy_run(tag, model, n_prompt, n_new, {
        "decode_attention": cfg.n_layers, "flash_attention": 0}, seed=33,
        b=b, positions=steps)
    del model
    torch.cuda.empty_cache()
    _f32_replay_run(tag, cfg, seed=34, b=1, n_prompt=128,
                    positions=torch.as_tensor(
                        _grid_positions(1, 64, 8, 8, 0)[0], device="cuda"))
    return {"flash_attention": counts["flash_attention"],
            "decode_attention": rep["decode_attention"]}


def phase_encdec_vl_parity() -> dict:
    """Phase 16d: both SMOKE configs (f32) with the same weights on the
    card and on the CPU: ``registry.forward``'s logits within
    ``SMOKE_TOL`` and 16 greedy ``decode_step`` tokens of 2 rows after a
    12-token replay equal (a differing token must be a near-tie of the
    CPU's logits); seamless over 13 seeded frames, qwen2-vl at the
    positions of 4 text tokens, a 4 x 4 image and text.  Returns the
    card's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry as R
    counts = {"flash_attention_f32": 0, "decode_attention": 0}
    for arch in ("seamless-m4t-large-v2", "qwen2-vl-7b"):
        cfg = get_smoke_config(arch)
        cpu = R.init_params(cfg, seed=3, device="cpu")
        gpu = R.init_params(cfg, seed=3)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(41)
        toks = rng.integers(0, cfg.vocab_size, size=(2, 28)).astype(np.int32)
        src = pos = None
        if cfg.n_enc_layers:
            src = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
            extra = {"src_embeds": src}
        else:
            pos = _grid_positions(2, 4, 4, 4, 8)[0]
            extra = {"mrope_positions": pos}
        FA.flash_attention.launches = DA.decode_attention.launches = 0
        lg_g, _ = R.forward(gpu, {k: torch.as_tensor(v, device="cuda")
                                  for k, v in dict(extra,
                                                   tokens=toks).items()},
                            cfg)
        gen_g, _ = _replay_greedy(gpu, toks[:, :12], 16, src, pos)
        counts["flash_attention_f32"] += FA.flash_attention.launches
        counts["decode_attention"] += DA.decode_attention.launches
        lg_c, _ = R.forward(cpu, {k: torch.as_tensor(v) for k, v in
                                  dict(extra, tokens=toks).items()}, cfg)
        lg_g = lg_g.float().cpu()
        err = (lg_g - lg_c).abs().max().item()
        _check(torch.allclose(lg_g, lg_c, atol=SMOKE_TOL, rtol=SMOKE_TOL),
               f"encdec/vl parity {arch}: forward logits differ by "
               f"{err:.3g}")
        gen_c, lg_steps = _replay_greedy(cpu, toks[:, :12], 16, src, pos)
        ties = _decode_ties(f"encdec/vl parity {arch}", gen_g, gen_c,
                            lg_steps)
        print(f"encdec/vl parity {arch}: forward max |diff| {err:.3g} (tol "
              f"{SMOKE_TOL}); decode_step greedy tokens of 2 rows x 16 "
              f"after a 12-token replay equal the CPU's (near-tie "
              f"divergences {ties})")
    return counts


# =============================================================================
# phase 17: training — the flash and SSD backward kernels, train steps card
# against CPU, qwen3-1.7b, mamba2-2.7b and zamba2-2.7b at full width
# =============================================================================
# (attention shape, sq, skv, causal, window) of the backward's cases: the
# training paths' attention at each family's widths
TRAIN_ATTN = {"qwen3": dict(K=8, g=2, dh=128),
              "gemma3": DENSE_ATTN["gemma3"], "glm4": DENSE_ATTN["glm4"],
              "qwen2": DENSE_ATTN["qwen2"], "seamless": ENCDEC_ATTN,
              "zamba2": ZAMBA2_ATTN}
BWD_CASES = (("qwen3", 4, 1024, 0, True, 0),
             ("gemma3", 1, 1400, 0, True, 1024),
             ("gemma3", 1, 1400, 0, True, 0),
             ("glm4", 1, 1400, 0, True, 0),
             ("qwen2", 1, 1400, 0, True, 0),
             ("seamless", 4, 1000, 0, False, 0),
             ("seamless", 4, 256, 1000, False, 0),
             ("zamba2", 1, 4096, 0, True, 0),
             ("qwen3", 2, 1000, 0, True, 0))
# the backward against autograd through the plain version: the largest
# |difference| over the plain gradient's largest magnitude, per gradient.
# f32: orders of summation only.  bf16: both widen the bf16 inputs and sum
# in f32, but the kernel's delta reads the bf16-rounded output and every
# gradient is rounded to bf16 (relative 2**-8).  The limit is set by the
# plain version's own spread between bf16 inputs and the f32 inputs they
# were rounded from, which phase 17a prints beside each case: 3.9e-3 to
# 7.0e-3 at these shapes on the card, the kernel 0.4e-3 to 6.6e-3 from
# the plain version; the limit is about three times the largest spread
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the contiguous flash attention computes."""
    import torch
    q = torch.arange(sq)[:, None]
    k = torch.arange(skv)[None, :]
    seen = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        seen &= q >= k
    if window > 0:
        seen &= (q - k) < window
    return int(seen.sum())


def phase_train_kernels() -> dict:
    """Phase 17a: the flash kernel's forward with its log-sum-exp and its
    backward (``flash_attention_bwd``, ``csrc/flash_backward.cu``) against
    autograd through the plain version, dQ, dK and dV, f32 and bf16, at
    ``BWD_CASES``: each gradient within ``BWD_TOL`` of the plain one's
    largest magnitude, the lse within 1e-4 of ``flash_attention_lse_ref``.
    Two launches must give the same bits (no atomics; the dK/dV splits
    are summed in a fixed order).  Prints, for each case, its dK/dV split
    count (``bwd_split_plan``), the backward's time, the plain backward's,
    one SDPA backward (a yardstick, never called by the port) and the
    bound, and the same three for forward + backward.  The bound: ``10
    dh`` flops per visible (query head, key) pair over the peak for the
    input type (bf16 989 TFLOP/s; f32 as split bf16 pairs on the tensor
    cores, 989/3, with the CUDA cores' 67 TFLOP/s printed beside), or the
    bytes (q, k, v, o, dO, lse read, dq, dk, dv written) over 3.35 TB/s.
    First, the split planner's CTAs an SM (``BWD_CTAS_PER_SM``) against
    the occupancy calculator's count for the dK/dV kernel: equal at dh
    128, no more at the cases' other head dims.  Returns the record of the
    qwen3 4 x 1024 f32 case, the full-width training step's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as REF
    held = {}
    for dtype in (torch.float32, torch.bfloat16):
        plan = PA.BWD_CTAS_PER_SM[dtype]
        for dh in sorted({TRAIN_ATTN[c[0]]["dh"] for c in BWD_CASES}):
            n = _build.extension().flash_bwd_ctas_per_sm(
                dtype == torch.bfloat16, dh)
            _check(n == plan if dh == 128 else n >= plan,
                   f"flash_attention_bwd {dtype} dh={dh}: an SM holds {n} "
                   f"dK/dV CTAs, BWD_CTAS_PER_SM says {plan}")
            held[f"{str(dtype)[6:]} dh={dh}"] = n
    print(f"kernel flash_attention_bwd: dK/dV CTAs an SM {held} "
          f"(BWD_CTAS_PER_SM f32 {PA.BWD_CTAS_PER_SM[torch.float32]}, bf16 "
          f"{PA.BWD_CTAS_PER_SM[torch.bfloat16]})")
    records = {}
    for i, (model, b, sq, skv, causal, window) in enumerate(BWD_CASES):
        shape = TRAIN_ATTN[model]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            # f32 draws, rounded for bf16: the spread below reads the plain
            # version on the unrounded inputs
            x32 = _flash_case(sq, torch.float32, seed=100 + i, b=b, skv=skv,
                              **shape)
            torch.manual_seed(200 + i)
            x32 += (torch.randn_like(x32[0]),)
            q, k, v, do = (t.to(dtype) for t in x32)
            H, dh, skv = q.shape[2], q.shape[3], k.shape[1]
            label = (f"{model} b={b} sq={sq} skv={skv} H={H} K={k.shape[2]} "
                     f"dh={dh} {'causal' if causal else 'full'} "
                     f"window={window} {dname}")
            args = dict(causal=causal, window=window)
            out, lse = FA.flash_attention(q, k, v, return_lse=True, **args)
            grads = FA.flash_attention_bwd(q, k, v, out, lse, do, **args)
            again = FA.flash_attention_bwd(q, k, v, out, lse, do, **args)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, c) for a, c in zip(grads, again)),
                   f"flash_attention_bwd {label}: two launches differ")
            n_split = PA.bwd_split_plan(b, sq, skv, H, k.shape[2],
                                        _build.sm_count(q.device),
                                        PA.BWD_CTAS_PER_SM[dtype])
            del again
            lse_ref = REF.flash_attention_lse_ref(q, k, **args)
            lse_err = (lse - lse_ref).abs().max().item()
            _check(lse_err <= 1e-4 * max(1.0, lse_ref.abs().max().item()),
                   f"flash lse {label}: max |err| {lse_err:.3g}")

            def plain_grads(q, k, v, do):
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = REF.flash_attention_ref(*leaves, **args)
                return o, leaves, torch.autograd.grad(o, leaves, do,
                                                      retain_graph=True)
            o_ref, leaves, ref = plain_grads(q, k, v, do)
            errs, abs_err = [], 0.0
            for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
                scale = want.float().abs().max().item()
                diff = (got.float() - want.float()).abs().max().item()
                abs_err = max(abs_err, diff)
                err = diff / scale
                _check(bool(torch.isfinite(got).all()),
                       f"flash_attention_bwd {label}: non-finite {name}")
                _check(err <= BWD_TOL[dname],
                       f"flash_attention_bwd {label}: {name} off by {err:.3g}"
                       f" of its largest magnitude (limit {BWD_TOL[dname]})")
                errs.append(err)
            spread = ""
            if dtype == torch.bfloat16:
                ref32 = plain_grads(*x32)[2]
                spread = max((a.float() - w).abs().max().item()
                             / w.abs().max().item() for a, w in zip(ref, ref32))
                spread = f", plain bf16-vs-f32 spread {spread:.3g}"
                del ref32
            print(f"kernel flash_attention_bwd {label}: max err / max |plain| "
                  f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (limit "
                  f"{BWD_TOL[dname]}{spread}); max_abs_err {abs_err:.3g}; lse "
                  f"max |err| {lse_err:.3g}; n_split {n_split}; two launches "
                  f"bit-equal")
            # timings: the backward alone (graphs kept), and forward +
            # backward, for the kernel, the plain version and SDPA
            qq, kq, vq = (t.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            if window > 0:
                pos = torch.arange(sq, device=q.device)
                diff = pos[:, None] - pos[None, :]
                mask = (diff >= 0) & (diff < window)
                sdpa = lambda: F.scaled_dot_product_attention(
                    qq, kq, vq, attn_mask=mask, enable_gqa=True)
            else:
                sdpa = lambda: F.scaled_dot_product_attention(
                    qq, kq, vq, is_causal=causal, enable_gqa=True)
            o_lib = sdpa()
            do_lib = do.transpose(1, 2).contiguous()
            bwd_ms = _time_ms(lambda: FA.flash_attention_bwd(
                q, k, v, out, lse, do, **args), reps=10, warmup=2)
            plain_ms = _time_ms(lambda: torch.autograd.grad(
                o_ref, leaves, do, retain_graph=True), reps=3, warmup=1)
            lib_ms = _time_ms(lambda: torch.autograd.grad(
                o_lib, (qq, kq, vq), do_lib, retain_graph=True), reps=10,
                warmup=2)

            def fb_kernel():
                o, l = FA.flash_attention(q, k, v, return_lse=True, **args)
                return FA.flash_attention_bwd(q, k, v, o, l, do, **args)
            fb_ms = _time_ms(fb_kernel, reps=10, warmup=2)
            # the forward alone, as inference launches it and with the lse
            fwd_ms = _time_ms(lambda: FA.flash_attention(q, k, v, **args),
                              reps=10, warmup=2)
            fwd_lse_ms = _time_ms(lambda: FA.flash_attention(
                q, k, v, return_lse=True, **args), reps=10, warmup=2)
            fb_plain = _time_ms(lambda: plain_grads(q, k, v, do), reps=3,
                                warmup=1)
            fb_lib = _time_ms(lambda: torch.autograd.grad(
                sdpa(), (qq, kq, vq), do_lib), reps=10, warmup=2)
            del o_ref, leaves, ref, o_lib
            pairs = _visible_pairs(sq, skv, causal, window) * H * b
            elt = q.element_size()
            n_bytes = (4 * q.numel() + 4 * k.numel()) * elt + 4 * lse.numel()
            bound_ms, bound_by = _bound_ms(n_bytes, 10 * dh * pairs, dname,
                                           "flash_attention_bwd")
            cc_ms, _ = _bound_ms(n_bytes, 10 * dh * pairs, dname,
                                 "flash_attention_bwd", "float32")
            print(f"kernel flash_attention_bwd {label}: "
                  f"backward ms {bwd_ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms "
                  f"{lib_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; at the "
                  f"CUDA cores' f32 peak {cc_ms:.5f}); forward + backward ms "
                  f"{fb_ms:.4f} plain {fb_plain:.4f} sdpa {fb_lib:.4f}; "
                  f"forward ms {fwd_ms:.4f}, with the lse {fwd_lse_ms:.4f}")
            if i == 0 and dtype == torch.float32:
                records["flash_attention_bwd"] = {
                    "max_abs_err": abs_err, "ms": bwd_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms}
            del q, k, v, do, x32, out, lse, grads, qq, kq, vq
            torch.cuda.empty_cache()
    return records


# the SSD scan's gradient (model of SSD_SHAPES, b, s), each in f32 and
# bf16: mamba2's and zamba2's full-width training step (4 x 1024), mamba2
# 1 x 4096 (its forward cuts P into 32-column slices), a SMOKE shape (c 8)
# and a G = 2 case
SSD_BWD_CASES = (("mamba2", 4, 1024), ("zamba2", 4, 1024),
                 ("mamba2", 1, 4096), ("smoke", 2, 64), ("g2", 2, 1024))
# the scan's backward against autograd through the plain scan: the largest
# |difference| over the plain gradient's largest magnitude, per gradient.
# f32: BWD_TOL's 1e-4 (orders of summation; the kernel's split-bf16
# products; the plain version's f32 cumsum of dt A, whose rounding exp
# turns into relative error, where the kernel takes it in f64): on the
# H100 the readings reach 4.96e-5 (ddt; 4.5e-5 with the earlier f32
# CUDA-core kernel).
# bf16: both widen the bf16 inputs and sum in f32, and round dx, dB and
# dC to bf16 (relative 2**-8); the limit is set by the plain version's
# own spread between bf16 inputs and the f32 inputs they were rounded
# from, which phase 17a prints beside each case: 1.9e-3 to 6.1e-3 at
# these shapes on the card, the kernel up to 4.3e-3 from the plain
# version (the earlier f32 CUDA-core kernel 2.7e-3); the limit is about
# three times the largest spread
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _ssd_fwd_ops(b: int, s: int, H: int, P: int, N: int, c: int) -> float:
    """Flops of the scan's forward (phase 7's count: the within-chunk
    products on the c (c + 1) / 2 pairs j <= i, the state products)."""
    return b * H * (s // c) * (c * (c + 1) * (N + P) + 4 * c * N * P)


def _ssd_bwd_ops(b: int, s: int, H: int, G: int, P: int, N: int,
                 c: int) -> float:
    """Flops the scan's gradient needs: per (head, chunk) c (c + 1) / 2 2 P
    multiply-adds within the chunk (dy X^T and dX's (S o L)^T dy on the
    pairs j <= i) and 4 c P N for the states' (dy C^T, dy h0, X dh1, dh1 B);
    per (group, chunk) c (c + 1) / 2 3 N (S = C B^T, and dC = (sum_h M_h) B
    and dB = (sum_h M_h)^T C, as B and C are the group's)."""
    pairs = c * (c + 1) // 2
    return 2 * b * (s // c) * (H * (pairs * 2 * P + 4 * c * P * N)
                               + G * pairs * 3 * N)


def phase_train_ssd_kernels() -> dict:
    """Phase 17a, the scan: the SSD forward with its chunk states and its
    backward (``ssd_chunked_bwd``, ``csrc/ssd_backward.cu``) against
    autograd through ``ssd_chunked_ref`` at ``SSD_BWD_CASES``, f32 and
    bf16: the chunk states within ``SSD_TOL`` of the plain forward's, each
    of dx, ddt, dA, dB and dC within ``SSD_BWD_TOL`` of the plain one's
    largest magnitude, and two launches of the backward bit-equal (every
    sum in a fixed order).  Checks that an SM holds
    ``SSD_BWD_CTAS_PER_SM`` chunk-pass CTAs, the planner's assumption, and
    prints each case's head block (``ssd_bwd_plan``).  Prints, for each
    case, the backward's time, the plain backward's and the bound (no
    single PyTorch call computes the scan or its gradient, so there is no
    library time), and the forward's with and without the states.  The
    bound: ``_ssd_bwd_ops`` over the peak for the input type (f32: split
    bf16 on the tensor cores, 989/3 TFLOP/s, with the CUDA cores' 67
    printed beside it), or the bytes (x, B, C, dt, A, dy and the chunk
    states read, dx, ddt, dA, dB and dC written) over 3.35 TB/s.  Returns
    the record of mamba2's 4 x 1024 f32 case, the full-width training
    step's shape."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels import ssd_scan as SSD
    ext = _build.extension()
    for model in ("mamba2", "zamba2"):
        sh = SSD_SHAPES[model]
        held = [ext.ssd_bwd_ctas_per_sm(bf16, sh["chunk"], sh["N"], sh["P"])
                for bf16 in (False, True)]
        _check(held == [SSD.SSD_BWD_CTAS_PER_SM] * 2,
               f"ssd_chunked_bwd {model}: an SM holds {held} f32 / bf16 "
               f"chunk-pass CTAs, the planner takes "
               f"{SSD.SSD_BWD_CTAS_PER_SM}")
        print(f"kernel ssd_chunked_bwd {model}: chunk-pass CTAs an SM f32 "
              f"{held[0]} bf16 {held[1]} (SSD_BWD_CTAS_PER_SM "
              f"{SSD.SSD_BWD_CTAS_PER_SM})")
    records = {}
    for i, (model, b, s) in enumerate(SSD_BWD_CASES):
        chunk = SSD_SHAPES[model]["chunk"]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            # f32 draws, x, B and C rounded for bf16: the spread below reads
            # the plain version on the unrounded inputs
            x32 = _ssd_case(model, b, s, torch.float32, seed=300 + i)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(400 + i)
            dy = torch.randn(x32[0].shape, device="cuda", generator=gen)
            args = tuple(t.to(dtype) if j in (0, 3, 4) else t
                         for j, t in enumerate(x32))
            x, dt, A, B, C = args
            H, P, G, N = x.shape[2], x.shape[3], B.shape[2], B.shape[3]
            hb = SSD.ssd_bwd_plan(b, s, H, G, chunk,
                                  _build.sm_count(x.device))
            label = (f"{model} b={b} s={s} H={H} P={P} G={G} N={N} "
                     f"c={chunk} {dname}")
            _, _, states = SSD.ssd_chunked(*args, chunk=chunk,
                                           return_states=True)
            grads = SSD.ssd_chunked_bwd(*args, states, dy, chunk=chunk)
            again = SSD.ssd_chunked_bwd(*args, states, dy, chunk=chunk)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, c) for a, c in zip(grads, again)),
                   f"ssd_chunked_bwd {label}: two launches differ")
            del again
            _, _, states_ref = REF.ssd_chunked_ref(*args, chunk,
                                                   return_states=True)
            st_err = (states - states_ref).abs().max().item()
            st_lim = SSD_TOL * states_ref.abs().max().item()
            _check(st_err <= st_lim, f"ssd_chunked states {label}: max "
                                     f"|err| {st_err:.3g} beyond {st_lim:.3g}")
            # the backward on the plain forward's chunk states: what of its
            # error the tensor-core forward's states bring
            grads_ps = SSD.ssd_chunked_bwd(*args, states_ref, dy, chunk=chunk)
            del states_ref

            def plain_grads(args):
                leaves = [t.detach().requires_grad_() for t in args]
                y, _ = REF.ssd_chunked_ref(*leaves, chunk)
                return y, leaves, torch.autograd.grad(y, leaves, dy,
                                                      retain_graph=True)
            y_ref, leaves, ref = plain_grads(args)
            errs, abs_err = [], 0.0
            errs_ps = [(g.float() - w.float()).abs().max().item()
                       / w.float().abs().max().item()
                       for g, w in zip(grads_ps, ref)]
            del grads_ps
            for name, got, want in zip(SSD_GRADS, grads, ref):
                _check(got.dtype == want.dtype and got.shape == want.shape,
                       f"ssd_chunked_bwd {label}: {name} {got.dtype} "
                       f"{tuple(got.shape)}")
                _check(bool(torch.isfinite(got).all()),
                       f"ssd_chunked_bwd {label}: non-finite {name}")
                diff = (got.float() - want.float()).abs().max().item()
                err = diff / want.float().abs().max().item()
                abs_err = max(abs_err, diff)
                _check(err <= SSD_BWD_TOL[dname],
                       f"ssd_chunked_bwd {label}: {name} off by {err:.3g} of "
                       f"its largest magnitude (limit {SSD_BWD_TOL[dname]})")
                errs.append(err)
            spread = ""
            if dtype == torch.bfloat16:
                ref32 = plain_grads(x32)[2]
                spreads = [(a.float() - w).abs().max().item()
                           / w.abs().max().item() for a, w in zip(ref, ref32)]
                spread = (", plain bf16-vs-f32 spread " + " ".join(
                    f"{n} {v:.3g}" for n, v in zip(SSD_GRADS, spreads)))
                del ref32
            errs_s = " ".join(f"{n} {e:.3g}" for n, e in zip(SSD_GRADS, errs))
            ps_s = " ".join(f"{n} {e:.3g}" for n, e in zip(SSD_GRADS, errs_ps))
            print(f"kernel ssd_chunked_bwd {label}: max err / max |plain| "
                  f"{errs_s} (limit {SSD_BWD_TOL[dname]}{spread}; on the "
                  f"plain forward's chunk states {ps_s}); max_abs_err "
                  f"{abs_err:.3g}; chunk states max |err| {st_err:.3g} "
                  f"(limit {st_lim:.3g}); two launches bit-equal; heads a "
                  f"chunk-pass CTA {hb}")
            bwd_ms = _time_ms(lambda: SSD.ssd_chunked_bwd(
                *args, states, dy, chunk=chunk), reps=10, warmup=2)
            plain_ms = _time_ms(lambda: torch.autograd.grad(
                y_ref, leaves, dy, retain_graph=True), reps=3, warmup=1)
            fwd_ms = _time_ms(lambda: SSD.ssd_chunked(*args, chunk=chunk),
                              reps=10, warmup=2)
            fwd_st_ms = _time_ms(lambda: SSD.ssd_chunked(
                *args, chunk=chunk, return_states=True), reps=10, warmup=2)
            fwd_st_plain_ms = _time_ms(lambda: REF.ssd_chunked_ref(
                *args, chunk, return_states=True), reps=3, warmup=1)
            elt = x.element_size()
            # the forward with its chunk states: the inputs read, y, the
            # final state and the states written
            st_bytes = (elt * (x.numel() + B.numel() + C.numel())
                        + 4 * (dt.numel() + A.numel() + x.numel()
                               + states.numel() + b * H * P * N))
            st_bound_ms, st_bound_by = _bound_ms(
                st_bytes, _ssd_fwd_ops(b, s, H, P, N, chunk), dname,
                "ssd_chunked")
            n_bytes = (2 * elt * (x.numel() + B.numel() + C.numel())
                       + 4 * (2 * dt.numel() + 2 * A.numel() + dy.numel()
                              + states.numel()))
            n_ops = _ssd_bwd_ops(b, s, H, G, P, N, chunk)
            bound_ms, bound_by = _bound_ms(n_bytes, n_ops, dname,
                                           "ssd_chunked_bwd")
            cc_ms, _ = _bound_ms(n_bytes, n_ops, dname, "ssd_chunked_bwd",
                                 "float32")
            print(f"kernel ssd_chunked_bwd {label}: backward ms {bwd_ms:.4f} "
                  f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} "
                  f"({bound_by}; {n_ops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f}"
                  f" MB; at the CUDA cores' f32 peak {cc_ms:.5f}); no single "
                  f"PyTorch call computes it; forward ms {fwd_ms:.4f}, with "
                  f"the chunk states {fwd_st_ms:.4f} (plain_ms "
                  f"{fwd_st_plain_ms:.4f} bound_ms {st_bound_ms:.5f} "
                  f"({st_bound_by}))")
            if i == 0 and dtype == torch.float32:
                records["ssd_chunked_bwd"] = {
                    "max_abs_err": abs_err, "ms": bwd_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None}
            del x32, dy, args, x, B, C, states, grads, y_ref, leaves, ref
            torch.cuda.empty_cache()
    return records


# the SMOKE training on the card against the CPU (f32).  The first
# step's gradients: within GRAD_TOL of each leaf's largest magnitude (the
# sums run in another order).  After three steps and an accum-2 step:
# losses within 1e-5 relative, and the parameters within the CPU train
# tests' rtol 2e-4 / atol 2e-5 (tests/test_torch_train_steps.py) but for
# at most TRAIN_OFF of them, each within the 2 lr a step that two AdamW
# runs can part by: AdamW moves an element by about lr whatever its
# gradient's size, so an element whose gradient is near rounding noise
# takes a step of another size or sign, and momentum carries it (on the
# CPU alone, with only the attention in f64, 1-2 elements of each config
# leave the bound, up to 3.9e-5 apart; on the card, 1 of qwen3's 90496 up
# to 1.7e-4 and 31 of qwen2-moe's 165312 up to 1.6e-3)
GRAD_TOL = 1e-4
TRAIN_TOL = (2e-4, 2e-5)
TRAIN_OFF = 1e-3
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
TRAIN_SMOKE = ("qwen3-1.7b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
               "seamless-m4t-large-v2", "mamba2-2.7b", "zamba2-2.7b")
# phase 17c: qwen3-1.7b, mamba2-2.7b and zamba2-2.7b at full width in f32,
# 4 x 1024 tokens a step
TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, TRAIN_FULL_STEPS = 4, 1024, 2
# the SSM and hybrid steps' optimizer: zamba2 starts near the uniform loss
# (ln 32000 = 10.37), and at TRAIN_OPT's lr 1e-3 its first AdamW steps
# raise the loss; at 1e-4 both models' losses fall over the first steps
# (scripts/train_lr_sensitivity.py prints the losses at 1e-3 down to 3e-5)
TRAIN_SSM_OPT = dict(TRAIN_OPT, lr=1e-4)


def _train_batch(cfg, b: int, s: int, step: int, device) -> dict:
    """The synthetic stream's batch ``step`` (b x s tokens and labels) on
    ``device``, with a VLM's M-RoPE grid positions (4 text tokens, a 4 x 4
    image, text) and an enc-dec's 13 seeded source frames."""
    import numpy as np
    import torch
    from repro_torch.train import data as DATA
    batch = DATA.SyntheticLM(DATA.DataConfig(cfg.vocab_size, s, b)).batch_at(
        step)
    if cfg.mrope_sections:
        batch["mrope_positions"] = _grid_positions(b, 4, 4, 4, s - 20)[0]
    if cfg.n_enc_layers:
        batch["src_embeds"] = np.random.default_rng(step).standard_normal(
            (b, 13, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _train_run(cfg, model, device, steps: int = 3):
    """``steps`` make_train_step steps and one gradient-accumulation step
    (accum 2) on the synthetic stream: the losses, the final weights in
    the reference's layout."""
    from repro_torch.models import bridge
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL
    opt = O.AdamWConfig(**TRAIN_OPT)
    state = TL.make_train_state(model, opt)
    step = TL.make_train_step(cfg, opt)
    losses = []
    for i in range(steps):
        state, m = step(state, _train_batch(cfg, 4, 32, i, device))
        losses.append(m["loss"].item())
    state, m = TL.make_grad_accum_train_step(cfg, opt, 2)(
        state, _train_batch(cfg, 4, 32, steps, device))
    losses.append(m["loss"].item())
    return losses, bridge.export_reference(model)


def _first_grads(cfg, model, device) -> dict:
    """The loss's gradients at the model's weights on the synthetic
    stream's first batch, in the reference's layout."""
    from repro_torch.models import bridge
    from repro_torch.train import train_loop as TL
    model.requires_grad_(True)
    loss, _ = TL.lm_loss(model, _train_batch(cfg, 4, 32, 0, device), cfg)
    return bridge.to_reference(model, TL._grads(model, loss))


def phase_train_parity() -> dict:
    """Phase 17b: the SMOKE configs of ``TRAIN_SMOKE`` (dense, MoE, VL with
    M-RoPE positions, enc-dec, SSM, hybrid) in f32, from the same seeded
    weights on the card and on the CPU: the first step's gradients within
    ``GRAD_TOL``, then three train steps and one accum-2 step, every loss
    within 1e-5 relative and the parameters within ``TRAIN_TOL`` but for
    at most ``TRAIN_OFF`` of them, each within 2 ``lr`` a step; each
    config's attention (flash) and scan (ssd_chunked) forward and backward
    launched on the card.  Returns the card's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry as R
    counts = {"flash_attention_f32": 0, "flash_attention_bwd": 0,
              "ssd_chunked": 0, "ssd_chunked_bwd": 0}
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        cpu = R.init_params(cfg, seed=5, device="cpu")
        gpu = R.init_params(cfg, seed=5)
        gpu.load_state_dict(cpu.state_dict())
        _zero_counts()
        gg = _first_grads(cfg, gpu, "cuda")
        gc = _first_grads(cfg, cpu, "cpu")
        g_err = max(float(np.abs(gg[k] - w).max())
                    / max(float(np.abs(w).max()), 1e-30)
                    for k, w in gc.items())
        _check(g_err <= GRAD_TOL, f"train parity {arch}: gradients off by "
                                  f"{g_err:.3g} of a leaf's largest")
        lg, pg = _train_run(cfg, gpu, "cuda")
        n = _counts()
        kernels = ((("flash_attention", "flash_attention_bwd")
                    if cfg.n_heads else ())
                   + (("ssd_chunked", "ssd_chunked_bwd")
                      if cfg.ssm_state else ()))
        _check(all(n[k] > 0 for k in kernels),
               f"train parity {arch}: launches {n}, expected {kernels}")
        counts["flash_attention_f32"] += n["flash_attention"]
        for k in ("flash_attention_bwd", "ssd_chunked", "ssd_chunked_bwd"):
            counts[k] += n[k]
        lc, pc = _train_run(cfg, cpu, "cpu")
        _check(np.allclose(lg, lc, rtol=1e-5, atol=0),
               f"train parity {arch}: losses {lg} on the card, {lc} on the "
               f"CPU")
        rtol, atol = TRAIN_TOL
        worst, off, total = 0.0, 0, 0
        for k, want in pc.items():
            diff = np.abs(pg[k] - want)
            worst = max(worst, float(diff.max()))
            off += int((diff > atol + rtol * np.abs(want)).sum())
            total += diff.size
        _check(worst <= 2 * TRAIN_OPT["lr"] * len(lg)
               and off <= TRAIN_OFF * total,
               f"train parity {arch}: params max |diff| {worst:.3g}, "
               f"{off} of {total} outside rtol {rtol} atol {atol}")
        print(f"train parity {arch}: first gradients off by {g_err:.3g} of "
              f"a leaf's largest (limit {GRAD_TOL}); 3 steps + 1 accum-2 "
              f"step, losses {[round(x, 6) for x in lg]} on the card, max "
              f"|loss diff| {max(abs(a - b) for a, b in zip(lg, lc)):.3g}; "
              f"params max |diff| {worst:.3g}, {off} of {total} outside "
              f"rtol {rtol} atol {atol} (limit {TRAIN_OFF:g} of them, each "
              f"within 2 lr a step); launches {n}")
    return counts


def _train_full_steps(tag: str, cfg, opt_kw: dict, per_step: dict,
                      flops_fn, parts: dict):
    """``TRAIN_FULL_STEPS`` steps of ``cfg`` in f32 at full width, AdamW
    with ``opt_kw``, weights from the port's seeded init, full activation
    checkpointing, on
    ``TRAIN_FULL_BATCH`` x ``TRAIN_FULL_SEQ`` tokens of the synthetic
    stream: each loss finite and the last below the first, each kernel of
    ``per_step`` launched exactly that often a step; prints ms a step,
    tokens/s, the step's bound at the CUDA cores' f32 peak
    (``flops_fn(model)`` operations a step), peak memory and a profiled
    step's device time with the kernels ``parts`` picks.  Returns (the
    timed steps' launches, the model, the train state, the step)."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL
    t0 = time.perf_counter()
    model = R.init_params(cfg, seed=0)
    opt = O.AdamWConfig(**opt_kw)
    state = TL.make_train_state(model, opt)
    step = TL.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag}: {cfg.name} {n_params / 1e6:.1f} M params f32, remat "
          f"{cfg.remat_policy}, lr {opt.lr:g}, init "
          f"{time.perf_counter() - t0:.1f} s")
    b, s = TRAIN_FULL_BATCH, TRAIN_FULL_SEQ
    batches = [_train_batch(cfg, b, s, i, "cuda")
               for i in range(TRAIN_FULL_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, walls = [], []
    for i in range(TRAIN_FULL_STEPS):
        t = time.perf_counter()
        state, m = step(state, batches[i])
        losses.append(m["loss"].item())            # waits for the step
        walls.append(time.perf_counter() - t)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"{tag}: losses {losses}")
    for name, n in per_step.items():
        want = n * TRAIN_FULL_STEPS
        _check(counts[name] == want, f"{tag}: {counts[name]} {name} launches "
                                     f"in {TRAIN_FULL_STEPS} steps, expected "
                                     f"{want}")
    steady = walls[1:]
    ms = 1e3 * sum(steady) / len(steady)
    flops = flops_fn(model)
    bound_ms = flops / PEAK_OPS_S["float32"] * 1e3
    t = time.perf_counter()
    state, m = step(state, batches[-1])
    m["loss"].item()
    t_wall = time.perf_counter() - t
    device = _device_profile(lambda: step(state, batches[-1]), 1, t_wall,
                             parts)
    per = ", ".join(f"{n} {k}" for k, n in per_step.items())
    print(f"{tag}: {TRAIN_FULL_STEPS} steps of {b} x {s} tokens, losses "
          f"{[round(x, 4) for x in losses]}; steps {[round(w * 1e3, 1) for w in walls]} "
          f"ms (the first with the warm-up), {ms:.1f} ms a step, "
          f"{b * s / ms * 1e3:.1f} tokens/s ({flops / 1e12:.1f} TFLOP a "
          f"step: bound {bound_ms:.1f} ms at the f32 peak, "
          f"{bound_ms / ms:.3f} of it); peak device memory {peak:.2f} "
          f"GiB; launches {counts} ({per} a step); a profiled step "
          f"({t_wall * 1e3:.1f} ms wall): {device}")
    return counts, model, state, step


def phase_train_full(smi: str) -> dict:
    """Phase 17c: qwen3-1.7b at full width (28 layers, 1.72 B params) in
    f32, as ``launch/train`` casts it, weights from the port's seeded
    init, full activation checkpointing: ``TRAIN_FULL_STEPS`` steps of 4 x
    1024 tokens of the synthetic stream, each loss finite and the last
    below the first; per step exactly 28 backward and 56 forward flash
    launches (each layer's forward and its recompute); ms a step,
    tokens/s, peak memory, and a profiled step's device idle share and
    flash kernels' shares.  Then the resume check at its widths cut to 2
    layers: 4 steps straight against 2 steps, an ``AsyncCheckpointer``
    save, a restore into a fresh state and 2 more steps (in a temporary
    directory, removed after), every parameter equal.  Returns the timed
    steps' launches."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import bridge
    from repro_torch.models import registry as R
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL
    cfg = get_config("qwen3-1.7b").with_(dtype=torch.float32)
    b, s, L = TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, cfg.n_layers

    def flops(model):
        # every product of the forward, of its recompute and of the
        # backward (twice the forward's) — 8 flops a parameter a token for
        # the layers' products and the tied head — and the attention's 4
        # dh (forward, twice) + 10 dh (backward) a visible (query head,
        # key) pair; its bound at the CUDA cores' f32 peak (the f32
        # products do not use the tensor cores: TF32 is off)
        n_params = sum(p.numel() for p in model.parameters())
        pairs = b * cfg.n_heads * s * (s + 1) // 2
        return 8 * n_params * b * s + 18 * cfg.d_head * pairs * L
    counts, model, state, step = _train_full_steps(
        f"train full [{smi}]", cfg, TRAIN_OPT,
        {"flash_attention_bwd": L, "flash_attention": 2 * L}, flops, {
            "flash forward": lambda key: "flash_tc_kernel" in key,
            "flash backward": lambda key: "flash_bwd" in key})
    del state, step, model
    torch.cuda.empty_cache()
    opt = O.AdamWConfig(**TRAIN_OPT)

    # the resume check at qwen3-1.7b's widths cut to 2 layers
    small = cfg.with_(n_layers=2)

    def fresh(seed):
        return TL.make_train_state(R.init_params(small, seed=seed), opt)
    step = TL.make_train_step(small, opt)
    data = [_train_batch(small, 2, 256, i, "cuda") for i in range(4)]
    straight = fresh(1)
    for i in range(4):
        straight, _ = step(straight, data[i])
    resumed = fresh(1)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        for i in range(2):
            resumed, _ = step(resumed, data[i])
        ck = CKPT.AsyncCheckpointer(d, keep=1)
        ck.submit(resumed, 2)
        ck.wait()
        ck.close()
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs) / 2**30
        del resumed
        resumed = CKPT.restore(d, fresh(7))
        _check(CKPT.latest_step(d) == 2 and int(resumed["opt"]["step"]) == 2,
               "resume: checkpoint step")
    t_ckpt = time.perf_counter() - t
    for i in range(2, 4):
        resumed, _ = step(resumed, data[i])
    a = bridge.export_reference(straight["params"])
    r = bridge.export_reference(resumed["params"])
    diff = max(float(np.abs(a[k] - r[k]).max()) for k in a)
    bitwise = all(np.array_equal(a[k], r[k]) for k in a)
    _check(diff <= 1e-6, f"resume: params differ by {diff:.3g}")
    print(f"train resume [{smi}]: qwen3-1.7b widths, 2 layers: 4 steps "
          f"straight against 2 + checkpoint ({size:.2f} GiB on disk, save "
          f"and restore {t_ckpt:.1f} s) + 2: params "
          f"{'bitwise equal' if bitwise else f'within {diff:.3g}'} "
          f"(limit 1e-6)")
    del straight, resumed
    torch.cuda.empty_cache()
    return {"flash_attention_f32": counts["flash_attention"],
            "flash_attention_bwd": counts["flash_attention_bwd"]}


def phase_train_full_ssm(smi: str) -> dict:
    """Phase 17c, the scan: mamba2-2.7b (64 Mamba2 layers, 2.7 B params)
    and then zamba2-2.7b (54 Mamba2 layers and the shared attention + MLP
    block after every 6) at full width in f32, as ``launch/train`` casts
    them, ``TRAIN_FULL_STEPS`` steps of 4 x 1024 tokens with full
    activation checkpointing, as ``phase_train_full``: per step exactly one
    scan backward and two scan forwards a Mamba2 layer (the forward and its
    recompute), and for zamba2 one flash backward and two forwards a shared
    block application; ms a step, tokens/s, peak memory and a profiled
    step's idle share and the scan backward's share of busy time; AdamW
    at ``TRAIN_SSM_OPT``'s lr.  Returns the timed steps' launches."""
    import torch
    from repro_torch.configs import get_config
    b, s = TRAIN_FULL_BATCH, TRAIN_FULL_SEQ
    launches = {"ssd_chunked": 0, "ssd_chunked_bwd": 0,
                "flash_attention_f32": 0, "flash_attention_bwd": 0}
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        cfg = get_config(arch).with_(dtype=torch.float32)
        L, H, P, N, c = (cfg.n_layers, cfg.n_ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state, cfg.ssm_chunk)
        G = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        per_step = {"ssd_chunked_bwd": L, "ssd_chunked": 2 * L,
                    "flash_attention_bwd": G, "flash_attention": 2 * G}

        def flops(model, cfg=cfg, L=L, H=H, P=P, N=N, c=c, G=G):
            # 8 flops a parameter a token (the shared block's counted at
            # each of its G applications), the scan's forward twice and
            # its backward a layer, and the shared attention's 18 dh a
            # visible (query head, key) pair
            n_params = sum(p.numel() for p in model.parameters())
            if G:
                n_params += (G - 1) * sum(p.numel()
                                          for p in model.shared.parameters())
            pairs = b * cfg.n_heads * s * (s + 1) // 2
            return (8 * n_params * b * s
                    + L * (2 * _ssd_fwd_ops(b, s, H, P, N, c)
                           + _ssd_bwd_ops(b, s, H, cfg.ssm_groups, P,
                                          N, c))
                    + 18 * cfg.d_head * pairs * G)
        counts, model, state, step = _train_full_steps(
            f"train full [{smi}]", cfg, TRAIN_SSM_OPT, per_step, flops, {
                "ssd forward": lambda key: "ssd_kernel" in key,
                "ssd backward": lambda key: "ssd_bwd" in key,
                "flash forward": lambda key: "flash_tc_kernel" in key,
                "flash backward": lambda key: "flash_bwd" in key})
        launches["ssd_chunked"] += counts["ssd_chunked"]
        launches["ssd_chunked_bwd"] += counts["ssd_chunked_bwd"]
        launches["flash_attention_f32"] += counts["flash_attention"]
        launches["flash_attention_bwd"] += counts["flash_attention_bwd"]
        del state, step, model
        torch.cuda.empty_cache()
    return launches


# =============================================================================
# phase 18: the append-buffer decode and mesh= on one rank
# =============================================================================
# phase 18's wall seconds: its three parts run beside the phases whose
# models they reuse (18a after phase 2's kernels, 18b inside phase 12 on its
# glm4-9b, 18c inside phase 3 on its family)
SPLIT_SECONDS = {"a": 0.0, "b": 0.0, "c": 0.0}
# phase 18b-c's launches of each kernel on their main paths (the kernels
# line adds them)
SPLIT_LAUNCHES: dict = {}


def _add_launches(counts: dict) -> None:
    for name, n in counts.items():
        SPLIT_LAUNCHES[name] = SPLIT_LAUNCHES.get(name, 0) + n
# the append-buffer decode's kernel widths: glm4-9b (32 heads over 2: two
# row-chunks a group), gemma3-27b (32 over 16, its local layers' window of
# 1024), qwen3-moe-30b-a3b (32 over 4) and qwen2-vl-7b (28 over 4, g = 7)
SPLIT_ATTN = {"glm4": dict(K=2, g=16, dh=128, window=0),
              "gemma3": dict(K=16, g=2, dh=128, window=1024),
              "qwen3-moe": dict(K=4, g=8, dh=128, window=0),
              "qwen2-vl": dict(K=4, g=7, dh=128, window=0)}
SPLIT_PREFIX, SPLIT_RING = 2048, 256
# the log-sum-exp against the plain version's, absolute, in both types:
# the two score the same inputs in f32 and differ only in the order of
# their sums (the lse is ~10 here, so f32 rounding is ~1e-6), tighter than
# the output's bf16 limit
LSE_TOL = 1e-4


def _split_segments(shape: dict):
    """The cases of one width: the prefix segment of SPLIT_PREFIX positions
    with the query at 2048 and 2303 (its window ends past the prefix), an
    empty prefix (length 0: the reference's own flow), and the suffix ring
    of SPLIT_RING positions at slots 0, 100 and 255 (lengths slot + 1, the
    default window end)."""
    return ([(SPLIT_PREFIX, SPLIT_PREFIX, pos + 1) for pos in (2048, 2303)]
            + [(SPLIT_PREFIX, 0, 1)]
            + [(SPLIT_RING, slot + 1, None) for slot in (0, 100, 255)])


def phase_split_decode_kernels() -> dict:
    """Phase 18a: the contiguous decode kernel with its window end and its
    log-sum-exp (the append-buffer decode's two segments) at the widths of
    the four archs whose optimized configs set ``decode_window``
    (``SPLIT_ATTN``), batch 4 (the decode of 18b), one () length shared by
    every row as the generic decode step gives it, f32 and bf16: the
    output held to the plain version at ``TOL``, the lse at ``LSE_TOL``
    (-inf exactly where the plain version's is: a row that sees nothing),
    then timed beside the plain version, one SDPA call and its bound.
    Returns the phase's launches of the kernel (the checks' own)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref as REF
    n0 = DA.decode_attention.launches
    b = 4
    for model, shape in SPLIT_ATTN.items():
        K, g, dh, window = (shape[k] for k in ("K", "g", "dh", "window"))
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            elt = torch.tensor([], dtype=dtype).element_size()
            for i, (S, length, wend) in enumerate(_split_segments(shape)):
                torch.manual_seed(i)
                q = torch.randn(b, K * g, dh, device="cuda").to(dtype)
                kc = torch.randn(b, S, K, dh, device="cuda").to(dtype)
                vc = torch.randn(b, S, K, dh, device="cuda").to(dtype)
                i32 = dict(dtype=torch.int32, device="cuda")
                ln = torch.tensor(length, **i32)
                we = None if wend is None else torch.tensor(wend, **i32)
                kern = lambda: DA.decode_attention(
                    q, kc, vc, ln, window=window, window_end=we,
                    return_lse=True)
                plain = lambda: REF.decode_attention_ref(
                    q, kc, vc, ln, window=window, window_end=we,
                    return_lse=True)
                end = length if wend is None else wend
                lo = max(end - window, 0) if window > 0 else 0
                seen = max(min(length, S) - lo, 0)
                mask = torch.zeros(S, dtype=torch.bool, device="cuda")
                mask[lo:min(length, S)] = True
                kq, vq = (t.transpose(1, 2).contiguous() for t in (kc, vc))
                lib = lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kq, vq, attn_mask=mask[None, None, None],
                    enable_gqa=True)
                out, lse = kern()
                torch.cuda.synchronize()
                want, want_lse = plain()
                label = (f"{model} S={S} length {length} window {window} "
                         f"window_end {wend} {dname}")
                err = (out - want).abs().max().item()
                atol, rtol = TOL[dname]
                _check(bool(torch.isfinite(out).all()),
                       f"split decode {label}: non-finite output")
                _check(torch.allclose(out, want, atol=atol, rtol=rtol),
                       f"split decode {label}: max |err| {err:.3g} beyond "
                       f"atol {atol} rtol {rtol}")
                empty = torch.isneginf(want_lse)
                _check(torch.equal(torch.isneginf(lse), empty),
                       f"split decode {label}: lse -inf at other rows")
                lse_err = ((lse - want_lse)[~empty].abs().max().item()
                           if bool((~empty).any()) else 0.0)
                _check(lse_err <= LSE_TOL,
                       f"split decode {label}: lse |err| {lse_err:.3g} "
                       f"beyond {LSE_TOL}")
                _check(seen > 0 or (not out.any() and bool(empty.all())),
                       f"split decode {label}: an empty segment must give "
                       f"0 and lse -inf")
                ms, plain_ms, lib_ms = (_time_ms(kern), _time_ms(plain),
                                        _time_ms(lib))
                # q read, the visible K/V read, the f32 output and lse
                # written
                n_bytes = (q.numel() * elt + 2 * b * seen * K * dh * elt
                           + 4 * (q.numel() + b * K * g) + 8)
                bound_ms, bound_by = _bound_ms(
                    n_bytes, 4 * b * seen * K * g * dh, dname,
                    "decode_attention")
                print(f"kernel decode_attention (window end, lse) {label}: "
                      f"max_abs_err {err:.3g} lse_err {lse_err:.3g} ms "
                      f"{ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms "
                      f"{lib_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    return {"decode_attention": DA.decode_attention.launches - n0}


# glm4-9b's append-buffer decode against its regular decode at full width
# in bf16: the largest relative rms difference of a step's logits
# (rms(split - regular) / rms(regular)).  The two read the same K/V in
# another order and the split rounds its output once, from f32 (the
# regular decode from its own f32 accumulators); a bf16 rounding that flips
# anywhere grows through the residual stream of 40 random layers, the
# floor of a bf16 comparison that phases 7-8 read at ~3-4% of the layers'
# part (REPLAY_TOL).  The limit is REPLAY_TOL's bf16 value.
SPLIT_TOL = REPLAY_TOL["bfloat16"]
# the f32 run's logits tolerance (relative rms): qwen2-0.5b at full width
# with random f32 weights has logits up to ~760, and two f32 formulations
# of the same logits differ by a few 1e-4 after 24 layers — the run
# prints that floor as the forward's distance from the regular decode
# (on the CPU's plain versions 3.3e-4, and the split decode's 2.3e-4)
SPLIT_F32_TOL = 1e-3
SPLIT_ROWS, SPLIT_PROMPT, SPLIT_NEW, SPLIT_MORE = 4, 64, 64, 32


def _teacher_decode(model, cfg, cache, tokens, start: int):
    """Feed ``tokens[:, start:]`` (b, n) one column a step through
    ``decode_step`` with ``cfg``; returns each step's logits (f32, on the
    card) and the cache."""
    from repro_torch.models import registry as R
    model.cfg = cfg
    out = []
    for t in range(start, tokens.shape[1]):
        lg, cache = R.decode_step(model, cache, {"tokens": tokens[:, t:t + 1]},
                                  cfg)
        out.append(lg.float())
    return out, cache


def _split_vs_regular(tag: str, split, regular, tol: float = SPLIT_TOL,
                      strict: bool = False) -> tuple:
    """Hold the split decode's logits of each step to the regular decode's
    (``tol``) and their greedy tokens equal: where the argmax differs,
    the regular logits' top-2 gap must be within the step's max |diff|
    (a near-tie that the difference can flip) — unless ``strict``, where
    any differing token fails (printed with its gap).  Returns (the
    largest relative rms difference, the near-ties)."""
    import torch
    worst, ties = 0.0, 0
    for step, (a, r) in enumerate(zip(split, regular)):
        _check(bool(torch.isfinite(a).all()), f"{tag}: non-finite logits")
        rel = ((a - r).norm() / r.norm()).item()
        worst = max(worst, rel)
        _check(rel <= tol, f"{tag}: step {step} logits differ by "
                           f"{rel:.4g} (rms, relative), beyond {tol}")
        for row in (a.argmax(-1) != r.argmax(-1)).nonzero().flatten():
            top = torch.topk(r[row], 2).values
            gap = float(top[0] - top[1])
            diff = float((a[row] - r[row]).abs().max())
            _check(not strict, f"{tag}: step {step} row {int(row)} greedy "
                               f"token differs (top-2 gap {gap:.4g}, the "
                               f"logits' max |diff| {diff:.4g}): tokens must "
                               f"be equal here")
            _check(gap <= diff, f"{tag}: step {step} row {int(row)} greedy "
                                f"token differs with a top-2 gap of "
                                f"{gap:.4g} above the logits' max |diff| "
                                f"{diff:.4g}: not a near-tie")
            print(f"{tag}: step {step} row {int(row)}: a near-tie, top-2 "
                  f"gap {gap:.4g} within the step's max |diff| {diff:.4g}")
            ties += 1
    return worst, ties


def phase_split_decode_full(model) -> dict:
    """Phase 18b: glm4-9b at full width (40 layers, 32 heads over 2 KV
    heads, bf16 weights: phase 12's model) through ``make_cache`` /
    ``decode_step`` with ``get_optimized_config``'s ``decode_window=256``
    (the append-buffer decode: two contiguous-decode launches a layer, the
    prefix's and the ring's, merged by their lse) against the same model's
    regular decode.  4 rows of 64 prompt tokens, replayed token by token,
    then 64 greedy tokens (the regular decode's, fed to both: teacher
    forcing keeps the two contexts equal), with the prefix empty (the
    reference's own flow: the whole context in the ring); then the
    regular decode's next 32 tokens again with ``prefix_len = 128``, the
    prefix K/V taken from the regular decode's cache after 128 tokens and
    the rest in the ring.  Each step's logits are held to the regular
    decode's within ``SPLIT_TOL`` and its greedy tokens equal
    (``_split_vs_regular``).  Returns the split decodes' launches of the
    contiguous decode kernel."""
    from repro_torch.configs import get_optimized_config, glm4_9b
    t0 = time.perf_counter()
    cfg = model.cfg                   # the engine's rung: FULL, renamed
    _check(cfg.with_(name=glm4_9b.FULL.name) == glm4_9b.FULL,
           f"phase 12's glm4 model is not glm4-9b FULL: {cfg}")
    opt = get_optimized_config("glm4-9b")
    _check(opt == glm4_9b.FULL.with_(decode_window=256),
           f"glm4-9b's optimized config is not FULL with "
           f"decode_window=256: {opt}")
    launches = _split_decode_run("split decode glm4-9b", model,
                                 opt.decode_window, SPLIT_TOL, strict=False)
    SPLIT_SECONDS["b"] += time.perf_counter() - t0
    return launches


def phase_split_decode_f32() -> dict:
    """Phase 18b in f32: qwen2-0.5b at full width (24 layers, 14 heads of
    64 over 2 KV heads) with f32 weights from a seed, the same flow as
    :func:`phase_split_decode_full` with ``decode_window=256``, held
    strictly: logits within ``REPLAY_TOL["float32"]`` and every greedy
    token equal to the regular decode's (in bf16 a few near-ties flip;
    in f32 none may), with the f32 floor printed: the forward's distance
    from the regular decode at the prompt's last position."""
    import torch
    from repro_torch.configs import qwen2_0_5b
    from repro_torch.models import registry as R
    t0 = time.perf_counter()
    model = R.init_params(qwen2_0_5b.FULL.with_(dtype=torch.float32), seed=0)
    launches = _split_decode_run("split decode qwen2-0.5b f32", model, 256,
                                 SPLIT_F32_TOL, strict=True)
    del model
    torch.cuda.empty_cache()
    SPLIT_SECONDS["b"] += time.perf_counter() - t0
    return launches


def _split_decode_run(tag: str, model, window: int, tol: float,
                      strict: bool) -> dict:
    """The flow of phase 18b on ``model`` with ``decode_window=window``;
    returns the split decodes' contiguous-decode launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import registry as R
    t0 = time.perf_counter()
    cfg = model.cfg
    cfg_w = cfg.with_(decode_window=window)
    b, n0, n1, n2 = SPLIT_ROWS, SPLIT_PROMPT, SPLIT_NEW, SPLIT_MORE
    L, max_len = cfg.n_layers, n0 + n1 + n2
    rng = np.random.default_rng(13)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, n0))
                             .astype(np.int32), device="cuda")
    # the regular decode: the prompt replayed, then n1 + n2 greedy tokens
    cache = R.make_cache(model, cfg, b, max_len, device="cuda")
    lg, cache = _teacher_decode(model, cfg, cache, tokens, 0)
    regular = [lg[-1]]
    for _ in range(n1 + n2 - 1):
        tokens = torch.cat([tokens, regular[-1].argmax(-1)[:, None]
                            .to(torch.int32)], 1)
        lg, cache = _teacher_decode(model, cfg, cache, tokens,
                                    tokens.shape[1] - 1)
        regular.append(lg[0])
    prefix_k, prefix_v = cache["k"], cache["v"]     # positions < 128 read
    if strict:
        # the floor: another formulation of the same logits (the forward
        # over the prompt) against the regular decode's
        fw, _ = R.forward(model, {"tokens": tokens[:, :n0].long()}, cfg)
        fw = fw[:, -1].float()
        floor = ((fw - regular[0]).norm() / regular[0].norm()).item()
        print(f"{tag}: the forward's logits at the prompt's last position "
              f"differ from the regular decode's by {floor:.4g} (rms, "
              f"relative; the f32 floor), max |logit| "
              f"{float(regular[0].abs().max()):.4g}")
        _check(floor <= tol, f"{tag}: f32 floor {floor:.4g} above {tol}")
    # (i) the prefix empty: the whole context in the ring
    DA.decode_attention.launches = 0
    model.cfg = cfg_w
    cache_w = R.make_cache(model, cfg_w, b, max_len, device="cuda")
    split, _ = _teacher_decode(model, cfg_w, cache_w, tokens[:, :n0 + n1],
                               0)
    steps_a = n0 + n1
    launches = DA.decode_attention.launches
    _check(launches == 2 * L * steps_a,
           f"split decode (empty prefix): {launches} decode_attention "
           f"launches, expected {2 * L * steps_a}")
    worst_a, ties_a = _split_vs_regular(
        f"{tag} (empty prefix)", split[n0 - 1:], regular[:n1 + 1], tol,
        strict)
    # (ii) prefix_len = 128 from the regular decode's cache
    DA.decode_attention.launches = 0
    model.cfg = cfg_w
    cache_w = R.make_cache(model, cfg_w, b, max_len, device="cuda")
    cache_w["k"], cache_w["v"] = prefix_k, prefix_v
    n_pre = n0 + n1
    cache_w["prefix_len"] = torch.tensor(n_pre, dtype=torch.int32,
                                         device="cuda")
    cache_w["pos"] = torch.tensor(n_pre, dtype=torch.int32, device="cuda")
    split_b, cache_w = _teacher_decode(model, cfg_w, cache_w, tokens, n_pre)
    n_b = tokens.shape[1] - n_pre
    launches_b = DA.decode_attention.launches
    _check(launches_b == 2 * L * n_b,
           f"split decode (prefix 128): {launches_b} decode_attention "
           f"launches, expected {2 * L * n_b}")
    _check(int(cache_w["pos"]) == tokens.shape[1], "split decode: position")
    worst_b, ties_b = _split_vs_regular(
        f"{tag} (prefix 128)", split_b, regular[n1 + 1:], tol, strict)
    model.cfg = cfg
    dtype = str(cfg.dtype).replace("torch.", "")
    print(f"{tag} (decode_window {window}, {dtype}, {b} rows): "
          f"empty prefix, {n0} replayed + {n1} greedy tokens: logits within "
          f"{worst_a:.4g} of the regular decode's (rms, relative; tol "
          f"{tol}), greedy tokens equal ({ties_a} near-ties); prefix "
          f"128 + {n_b} tokens in the ring: within {worst_b:.4g} ({ties_b} "
          f"near-ties); {launches} + {launches_b} decode_attention launches "
          f"(2 a layer a step); {time.perf_counter() - t0:.1f} s")
    return {"decode_attention": launches + launches_b}


def phase_mesh_serve(family, prompts, streams: dict, n_new: int) -> dict:
    """Phase 18c: ``RealEngine(kv_layout="paged", mesh=make_mesh_for(1))``
    on phase 3's qwen3-1.7b family (full width, bf16) serving phase 3's 8
    requests: every stream equal to phase 3's engine without a mesh
    (``streams``), both paged kernels launched, the weights shared with
    the family (a (1, 1) mesh's shard is the whole tensor).  Then the
    SMOKE config disaggregated (``roles=(1, 1)``) on the (1, 1) mesh on
    the card against the same on the CPU, strictly: streams and handoffs.
    Returns the paged kernels' launches in the card's serves."""
    import torch
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    t0 = time.perf_counter()
    cfg = family[0].cfg
    mesh = make_mesh_for(1)
    eng = ENG.RealEngine(family, max_len=2048, kv_layout="paged",
                         block_size=16, n_blocks=160, max_seqs=8, mesh=mesh)
    eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
    PA.paged_decode_attention.launches = 0
    FA.paged_prefill_attention.launches = 0
    m = serve_prompts(eng, prompts, n_new=n_new)
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": PA.paged_decode_attention.launches,
                "paged_prefill_attention":
                    FA.paged_prefill_attention.launches}
    _check(all(n > 0 for n in launches.values()),
           f"mesh serve: a paged kernel was not launched: {launches}")
    _check(m["served"] == len(prompts), f"mesh serve: served {m['served']}")
    _check(eng.instances[0].params is family[0].params,
           "mesh serve: a (1, 1) mesh must keep the family's weights")
    for rid, toks in streams.items():
        _check(bool((eng.last_outputs[rid] == toks).all()),
               f"mesh serve: rid {rid} differs from the engine without a "
               f"mesh: {eng.last_outputs[rid]} against {toks}")
    print(f"mesh serve: qwen3-1.7b on {mesh}: {m['served']} requests, "
          f"streams equal to the engine without a mesh; {m['tokens']} "
          f"tokens in {m['wall_s']:.2f} s = {m['tokens_per_s']:.1f} tok/s; "
          f"launches {launches}")
    del eng
    torch.cuda.empty_cache()
    # the SMOKE config disaggregated on the (1, 1) mesh, card against CPU
    smoke = qwen3_1_7b.SMOKE
    fam_cpu = ENG.build_engine_family(smoke, fracs=(1.0,), seed=3,
                                      device="cpu")
    fam_gpu = ENG.build_engine_family(smoke, fracs=(1.0,), seed=3)
    fam_gpu[0].params.load_state_dict(fam_cpu[0].params.state_dict())
    mixed = _mixed_prompts(smoke.vocab_size)[:4]
    outs, handoffs = {}, {}
    for fam, dev in ((fam_gpu, None), (fam_cpu, "cpu")):
        eng = ENG.RealEngine(fam, n_slots=2, max_len=64, block_size=8,
                             max_seqs=6, kv_layout="paged", roles=(1, 1),
                             device=dev, mesh=make_mesh_for(1, device=dev))
        eng.configure(ConfigGraph.from_dict(smoke.name, {("x1", 1): 1}))
        PA.paged_decode_attention.launches = 0
        FA.paged_prefill_attention.launches = 0
        mm = serve_prompts(eng, mixed, n_new=8)
        if dev is None:              # the card's serve: its launches count
            launches["paged_decode_attention"] += \
                PA.paged_decode_attention.launches
            launches["paged_prefill_attention"] += \
                FA.paged_prefill_attention.launches
        outs[dev], handoffs[dev] = dict(eng.last_outputs), mm["handoffs"]
        del eng
    _check(handoffs[None] == handoffs["cpu"] == len(mixed),
           f"mesh disagg: handoffs {handoffs}")
    for rid, toks in outs["cpu"].items():
        _check(bool((outs[None][rid] == toks).all()),
               f"mesh disagg: rid {rid} differs: {outs[None][rid]} on the "
               f"card, {toks} on the CPU")
    SPLIT_SECONDS["c"] += time.perf_counter() - t0
    print(f"mesh disagg: SMOKE disaggregated on the (1, 1) mesh on the card "
          f"equals the CPU on {len(mixed)} requests x 8 tokens, "
          f"{handoffs[None]} handoffs; {time.perf_counter() - t0:.1f} s")
    return launches


# =============================================================================
# phase 19: serving across devices — the ranks of a mesh sharing the card
# =============================================================================
TP_NEW = 16
# qwen3-1.7b's attention on one rank of phase 19a's (1, 2) mesh: its 16
# query heads over 8 KV heads, cut over a model axis of 2
TP_ATTN = dict(K=4, g=2, dh=128)
# room a rank's device takes beyond its shard and arena during phase 19a's
# serve: the chunks' and decode steps' activations and logits (a vocab
# slice of 76032 x 128 tokens in f32 is 39 MB), the allocator's rounding
TP_ACTIVATION_BYTES = 512 * 2 ** 20


def _tp_setup():
    """(config with f32 weights, prompts, engine settings) of phase 19a:
    qwen3-1.7b at full width, phase 3's 8 prompts and arena, prefilled in
    chunks of 128 tokens (as phases 12, 14 and 15 prefill): every chunk
    costs a rank 57 collectives, which gloo stages through the host, so
    phase 3's 32-token chunks would take 4x as many."""
    import torch
    from repro_torch.configs import qwen3_1_7b
    return (qwen3_1_7b.FULL.with_(dtype=torch.float32),
            _serve_prompts(qwen3_1_7b.FULL.vocab_size),
            dict(max_len=2048, block_size=16, n_blocks=160, max_seqs=8,
                 chunk_blocks=8))


def _tp_engine(family, kw: dict, mesh, device):
    """A paged engine on ``family`` (f32 arena) on ``mesh`` (None: one
    device), configured (warm-up included)."""
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.serving import engine as ENG
    eng = ENG.RealEngine(family, kv_layout="paged", mesh=mesh, device=device,
                         **kw)
    eng.configure(ConfigGraph.from_dict(family[0].cfg.name, {("x1", 1): 1}))
    return eng


def _rank_threads(args) -> None:
    """A rank's settings: f32 products in full f32, as in ``main``, and
    the host's cores shared among the ranks."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world_size))


def _sync(device) -> None:
    import torch
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def _paged_launches() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    return {"paged_decode_attention": PA.paged_decode_attention.launches,
            "paged_prefill_attention": FA.paged_prefill_attention.launches}


def _zero_paged_launches() -> None:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    PA.paged_decode_attention.launches = 0
    FA.paged_prefill_attention.launches = 0


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _tp_serve_rank(args, n_new: int) -> dict:
    """Phase 19a on one rank of a (1, 2) mesh: the engine on this rank's
    shard serves the prompts; returns its streams, stats, the serve's
    paged kernel launches and collectives, the collectives of one decode
    step at the full batch, the rank's attention shapes and its device
    memory.  The whole weights are drawn from seed 0 on the card (the
    single rank's weights; the CPU draws a truncated normal of this size
    far more slowly), then moved to the host, where a checkpoint would be
    read; the device's peak is counted from the engine's construction on,
    when the rank's device holds only its shard and arena."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    from repro_torch.sharding import collectives as CL
    t = [time.perf_counter()]
    _rank_threads(args)
    cfg, prompts, kw = _tp_setup()
    mesh = make_mesh_for(2, model_parallel=2, device=args.device_type)
    t.append(time.perf_counter())
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0,
                                     device=args.device)
    family[0].params.to("cpu")
    whole = _param_bytes(family[0].params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t.append(time.perf_counter())
    eng = _tp_engine(family, kw, mesh, args.device)
    t.append(time.perf_counter())
    inst = eng.instances[0]
    attn = inst.params.layers[0].attn
    shapes = {"heads": attn.n_heads, "kv_heads": attn.n_kv_heads,
              "arena": tuple(inst.arena["k"].shape)}
    _sync(args.device)
    _zero_paged_launches()
    CL.reset()
    m = serve_prompts(eng, prompts, n_new=n_new)
    _sync(args.device)
    t.append(time.perf_counter())
    launches = _paged_launches()
    serve_coll = CL.totals()
    # one decode step at the full batch (every write to the junk block)
    B = inst.max_seqs
    dev = inst.device
    tables = np.zeros((B, inst.n_pages), np.int32)
    CL.reset()
    R.decode_paged_multi(
        inst.params, inst.arena,
        {"tokens": torch.zeros((B, 1), dtype=torch.int32, device=dev)},
        torch.as_tensor(tables, device=dev),
        torch.full((B,), 300, dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.bool, device=dev), 1)
    _sync(args.device)
    memory = {"whole_weights": whole, "shard_weights":
              _param_bytes(inst.params),
              "arena": sum(t.numel() * t.element_size()
                           for t in inst.arena.values()),
              "allocated": torch.cuda.memory_allocated(),
              "peak": torch.cuda.max_memory_allocated()}
    return {"coords": mesh.coords, "outputs": dict(eng.last_outputs),
            "stats": {k: m[k] for k in ("served", "tokens", "wall_s",
                                         "tokens_per_s", "prefix_hit_tokens",
                                         "decode_steps", "collective_calls",
                                         "collective_bytes")},
            "launches": launches, "serve_collectives": serve_coll,
            "step_collectives": CL.stats(), "shapes": shapes,
            "memory": memory, "seconds": [b - a for a, b in zip(t, t[1:])]}


def _top2_gap(model, prompt, stream, step: int) -> float:
    """The top-2 logit gap of the greedy pick at ``step`` of ``stream``
    (the forward over the prompt and the stream's first ``step``
    tokens)."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    toks = np.concatenate([prompt, np.asarray(stream[:step], np.int32)])
    dev = next(model.parameters()).device
    lg, _ = R.forward(model, {"tokens": torch.as_tensor(
        toks[None].astype(np.int64), device=dev)}, model.cfg)
    top = torch.topk(lg[0, -1].float(), 2).values
    return float(top[0] - top[1])


def _tp_disagg(device, mesh) -> dict:
    """Phase 19b's serve: the SMOKE config disaggregated (one prefill and
    one decode worker) on ``mesh`` (None: one device), its family drawn
    from seed 3 on the CPU (the ranks copy their shards from there)."""
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    smoke = qwen3_1_7b.SMOKE
    family = ENG.build_engine_family(smoke, fracs=(1.0,), seed=3,
                                     device="cpu")
    eng = ENG.RealEngine(family, n_slots=2, max_len=64,
                         block_size=8, max_seqs=6, kv_layout="paged",
                         roles=(1, 1), device=device, mesh=mesh)
    eng.configure(ConfigGraph.from_dict(smoke.name, {("x1", 1): 1}))
    _zero_paged_launches()
    m = serve_prompts(eng, _mixed_prompts(smoke.vocab_size)[:4], n_new=8)
    _sync(device)
    return {"outputs": dict(eng.last_outputs), "handoffs": m["handoffs"],
            "preemptions": m["preemptions"], "launches": _paged_launches()}


def _tp_disagg_rank(args) -> dict:
    """Phase 19b on one rank of a (2, 2) mesh."""
    from repro_torch.launch.mesh import make_mesh_for
    _rank_threads(args)
    mesh = make_mesh_for(4, model_parallel=2, device=args.device_type)
    return dict(_tp_disagg(args.device, mesh), coords=mesh.coords)


def phase_tp_serve() -> dict:
    """Phase 19: serving across devices, the ranks sharing the card over
    gloo (``launch.ranks.spawn``; NCCL puts no two ranks on one device, so
    no NCCL or NVLink time is measured here).  (a) qwen3-1.7b at full
    width with f32 weights and an f32 arena on a (1, 2) mesh of 2 ranks,
    each holding 8 of the 16 query heads over 4 of the 8 KV heads, half
    of each MLP and of the vocab, serving phase 3's 8 requests of
    ``TP_NEW`` new tokens through ``RealEngine(kv_layout="paged",
    mesh=...)``: every stream equal to a single-rank engine's on the same
    seeded weights, run here (a differing token is printed with its top-2
    gap, and fails), both paged kernels launched on every rank at its
    shapes, the collectives of one decode step printed, and each rank's
    device memory from its engine's construction to the serve's end
    checked to hold its shard, not the whole model.  (b) the SMOKE
    config disaggregated on a (2, 2) mesh of 4 ranks on the card against
    the same unsharded on the CPU, strictly: streams and handoffs.
    Returns the paged kernels' launches summed over the ranks of both."""
    import torch
    from repro_torch.launch import ranks
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts
    # the single rank's f32 products as the ranks' (``_rank_threads``)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, prompts, kw = _tp_setup()
    family = ENG.build_engine_family(cfg, fracs=(1.0,), seed=0)
    eng = _tp_engine(family, kw, None, None)
    m1 = serve_prompts(eng, prompts, n_new=TP_NEW)
    single, model = dict(eng.last_outputs), family[0].params
    del eng, family
    t1 = time.perf_counter()
    res = ranks.spawn(_tp_serve_rank, 2, None, args=(TP_NEW,), timeout=400)
    t2 = time.perf_counter()
    bad = []
    for r in res:
        for rid, toks in single.items():
            got = r["outputs"][rid]
            if (got == toks).all():
                continue
            step = int((got != toks).argmax())
            gap = _top2_gap(model, prompts[rid], toks, step)
            print(f"tp serve: rank {r['coords']} rid {rid} differs at step "
                  f"{step}: {got[step]} against {toks[step]}, the single "
                  f"rank's top-2 gap {gap:.4g}")
            bad.append((r["coords"], rid))
    _check(not bad, f"tp serve: streams differ from the single rank's: "
                    f"{bad}")
    launches = {name: 0 for name in _paged_launches()}
    for r in res:
        _check(all(n > 0 for n in r["launches"].values()),
               f"tp serve: rank {r['coords']} launched no paged kernel: "
               f"{r['launches']}")
        sh = r["shapes"]
        _check(sh["heads"] == cfg.n_heads // 2
               and sh["kv_heads"] == cfg.n_kv_heads // 2
               and sh["arena"][3] == cfg.n_kv_heads // 2,
               f"tp serve: rank {r['coords']} shapes {sh}")
        _check(r["stats"]["served"] == len(prompts)
               and r["stats"]["prefix_hit_tokens"]
               == m1["prefix_hit_tokens"] > 0,
               f"tp serve: rank {r['coords']} stats {r['stats']}, the "
               f"single rank's prefix hits {m1['prefix_hit_tokens']}")
        # the shard is half the whole weights (the norms whole), and the
        # device holds the shard, the arena and the serve's activations
        mem = r["memory"]
        _check(mem["shard_weights"] < 0.51 * mem["whole_weights"]
               and mem["peak"] < mem["shard_weights"] + mem["arena"]
               + TP_ACTIVATION_BYTES,
               f"tp serve: rank {r['coords']} device memory {mem}")
        for name, n in r["launches"].items():
            launches[name] += n
    st = res[0]["stats"]
    step = res[0]["step_collectives"]
    print(f"tp serve: {cfg.name} f32 on a (1, 2) mesh of 2 ranks on one "
          f"card (gloo): {len(single)} requests x {TP_NEW} tokens, every "
          f"stream equal to the single rank's; a rank holds "
          f"{res[0]['shapes']['heads']} query heads over "
          f"{res[0]['shapes']['kv_heads']} KV heads, arena "
          f"{res[0]['shapes']['arena']}; ranks {st['tokens_per_s']:.1f} "
          f"tok/s ({st['wall_s']:.2f} s) against the single rank's "
          f"{m1['tokens_per_s']:.1f} ({m1['wall_s']:.2f} s); prefix hits "
          f"{st['prefix_hit_tokens']}")
    print(f"tp serve: launches a rank "
          f"{[(r['coords'], r['launches']) for r in res]}")
    print(f"tp serve: collectives of the serve (rank 0) "
          f"{res[0]['serve_collectives']['calls']} calls, "
          f"{res[0]['serve_collectives']['bytes']} bytes; of one decode "
          f"step at batch 8: " + ", ".join(
              f"{k} {v['calls']} calls {v['bytes']} bytes"
              for k, v in step.items() if v["calls"]))
    gib = 2.0 ** 30
    print("tp serve: device memory a rank (GiB): " + "; ".join(
        f"{r['coords']} whole weights {r['memory']['whole_weights'] / gib:.3f}"
        f" on the host, shard {r['memory']['shard_weights'] / gib:.3f}, "
        f"arena {r['memory']['arena'] / gib:.3f}, peak "
        f"{r['memory']['peak'] / gib:.3f}, after the serve "
        f"{r['memory']['allocated'] / gib:.3f}" for r in res))
    sec = res[0]["seconds"]
    print(f"tp serve: single rank {t1 - t0:.1f} s, the ranks' spawn "
          f"{t2 - t1:.1f} s (rank 0: the mesh {sec[0]:.1f} s, the weights "
          f"drawn on the card and moved to the host {sec[1]:.1f} s, the "
          f"engine: shards copied, warm-up {sec[2]:.1f} s, the serve "
          f"{sec[3]:.1f} s)")
    del model
    torch.cuda.empty_cache()
    # (b) SMOKE disaggregated on (2, 2), the card against the CPU
    t3 = time.perf_counter()
    res_b = ranks.spawn(_tp_disagg_rank, 4, None, timeout=300)
    cpu = _tp_disagg("cpu", None)
    for r in res_b:
        _check(r["handoffs"] == cpu["handoffs"] == 4,
               f"tp disagg: rank {r['coords']} handoffs {r['handoffs']}, "
               f"CPU {cpu['handoffs']}")
        for rid, toks in cpu["outputs"].items():
            _check(bool((r["outputs"][rid] == toks).all()),
                   f"tp disagg: rank {r['coords']} rid {rid}: "
                   f"{r['outputs'][rid]} against {toks} on the CPU")
        _check(all(n > 0 for n in r["launches"].values()),
               f"tp disagg: rank {r['coords']} launches {r['launches']}")
        for name, n in r["launches"].items():
            launches[name] += n
    print(f"tp disagg: SMOKE disaggregated on a (2, 2) mesh of 4 ranks on "
          f"the card equals the CPU on 4 requests x 8 tokens, "
          f"{cpu['handoffs']} handoffs; launches a rank "
          f"{[(r['coords'], r['launches']) for r in res_b]}; "
          f"{time.perf_counter() - t3:.1f} s")
    print(f"tp: phase 19 {time.perf_counter() - t0:.1f} s")
    return launches


def phase_tp_kernels() -> dict:
    """Phase 19, the kernels at a rank's shapes (``TP_ATTN``: 8 query
    heads over 4 KV heads, dh 128): the paged decode at batch 8 over rows
    of up to 2048 positions and at the serve's step (300 a row), and the
    paged prefill of phase 19a's 128-token chunk at n_past 896 (the last
    of its 1024-token prompt), f32, held to their plain versions and
    timed as in phase 2."""
    import torch
    f32 = torch.float32
    prefill = dict(TP_ATTN, C=128)
    return _kernel_cases(
        [("decode", 8, f32, TP_ATTN), ("decode", 8, f32,
                                       dict(TP_ATTN, lengths=300)),
         ("prefill", 896, f32, prefill)],
        {("decode", 8, "float32", tuple(sorted(TP_ATTN.items()))):
         "paged_decode_attention_rank",
         ("prefill", 896, "float32", tuple(sorted(prefill.items()))):
         "paged_prefill_attention_rank"})


# =============================================================================
# phase 20: training and the generic decode across devices — the ranks of
# a mesh sharing the card
# =============================================================================
# phase 20a: qwen3-1.7b at full width in f32 on a (2, 2) mesh of 4 ranks,
# ZeRO-1 on, phase 17c's TRAIN_FULL_STEPS steps of 4 rows, at 512 tokens
# (TP_TRAIN_SEQ; half of 17c's 1024, for the script's time: a rank's step
# hands gloo its 3.2 GiB gradient and weights whatever the tokens, and
# its activations' all-reduces besides) — a rank takes 2 rows, half of
# every cut weight and half of the moments it cuts — held to a single
# rank's steps on the same seeded weights and batches: each loss within
# TP_TRAIN_LOSS_TOL relative, the parameters after the first step at the
# port's step tolerance (TRAIN_TOL, with TRAIN_OFF of them within 2 lr)
TP_TRAIN_MESH = (2, 2)
TP_TRAIN_SEQ = 512
TP_TRAIN_LOSS_TOL = 5e-4
# phase 20b: the SMOKE scenarios on 4 ranks of the card against the same
# on 4 ranks of the CPU: DDP on 2 ranks (the reference's tiny qwen2-0.5b
# of tests/multidev_scenarios.py:46-48), training on (1, 2), and glm4's
# decode with the sequence over ("data", "model") on (2, 2)
TP_SMOKE_TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                     d_head=8, d_ff=64, vocab_size=64)
TP_SMOKE_TRAIN = ("mamba2-2.7b", "zamba2-2.7b", "seamless-m4t-large-v2")
TP_DECODE_STEPS = 12
# phase 20a': mamba2-2.7b at full width in f32 on (1, 2) — each rank 40
# of the 80 heads, the gate norm's sum of squares all-reduced, wB / wC
# whole — its depth cut to TP_SSM_LAYERS Mamba2 layers (the embedding and
# head whole), one step of TRAIN_FULL_BATCH x TRAIN_FULL_SEQ tokens at
# TRAIN_SSM_OPT, held to the single rank's step as 20a
TP_SSM_ARCH, TP_SSM_LAYERS = "mamba2-2.7b", 4


def _params_close(got: dict, want: dict, lr: float) -> tuple:
    """(elements, those beyond TRAIN_TOL, those beyond 2 lr, largest
    |difference|) of two dicts of tensors (or arrays), in f64 on the
    device of ``got``'s tensors."""
    import torch
    rtol, atol = TRAIN_TOL
    n = off = far = 0
    worst = 0.0
    for k, w in want.items():
        g = torch.as_tensor(got[k])
        g, w = g.double(), torch.as_tensor(w).to(g.device).double()
        d = (g - w).abs()
        n += d.numel()
        off += int((d > atol + rtol * w.abs()).sum())
        far += int((d > 2 * lr).sum())
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return n, off, far, worst


def _tp_train_rank(args, path: str, ssm_path: str) -> tuple:
    """Phase 20 on one rank of 4: (a) :func:`_tp_full_run`, then, its
    memory freed, (a') :func:`_tp_ssm_run` on ranks 0-1 and (b)
    :func:`_tp_smoke_run` on the card and on the CPU, in the same process
    group (one spawn: a rank takes ~8 s to reach the card).  Returns (a's,
    a''s (None off its mesh), (b's on the card, on the CPU))."""
    import torch
    _rank_threads(args)
    full = _tp_full_run(args, path)
    torch.cuda.empty_cache()
    ssm = _tp_ssm_run(args, ssm_path)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    card = _tp_smoke_run(args, args.device, args.device_type)
    cpu = _tp_smoke_run(args, "cpu", "cpu")
    full["seconds"] += (time.perf_counter() - t,)
    return full, ssm, (card, cpu)


def _tp_ssm_cfg():
    import torch
    from repro_torch.configs import get_config
    return get_config(TP_SSM_ARCH).with_(dtype=torch.float32,
                                         n_layers=TP_SSM_LAYERS)


def _tp_ssm_run(args, path: str):
    """Phase 20a' on ranks 0-1 of the group, a (1, 2) mesh: the whole
    weights drawn from seed 0 on the card (the single rank's), moved to
    the host and cut to the rank's shard; one ``steps.build_train`` step
    (ZeRO-1 has no data axis to cut); the rank's loss, its parameters
    against its part of the single rank's (``path``) and the kernels'
    launches.  None on ranks 2-3."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.sharding import rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import parallel as P
    from repro_torch.train import train_loop as TL
    mesh = make_mesh_for(2, model_parallel=2, device=args.device_type)
    if not mesh.member:
        return None
    cfg = _tp_ssm_cfg()
    whole = R.init_params(cfg, seed=0).to("cpu")
    torch.cuda.empty_cache()
    local = R.shard_params(whole, cfg, mesh)
    del whole
    opt = O.AdamWConfig(**TRAIN_SSM_OPT)
    step = steps.build_train(cfg, mesh, "train_4k", opt_cfg=opt, accum=1,
                             zero1=True)[0]
    state = TL.make_train_state(local, opt, zero1=True)
    plan = P.plan_for(local, True)
    batch = _train_batch(cfg, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, 0,
                         args.device)
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    state, met = step(state, batch)
    loss = met["loss"].item()
    wall = time.perf_counter() - t
    launches = _counts()
    want = torch.load(path, mmap=True)
    cmp = _params_close(
        {n: p.detach() for n, p in local.named_parameters()},
        {n: rules.local_shard(want[n], plan.spec[n], mesh)
         for n, _ in local.named_parameters()}, opt.lr)
    return {"coords": mesh.coords, "loss": loss, "wall": wall, "cmp": cmp,
            "launches": launches}


def _tp_full_run(args, path: str) -> dict:
    """Phase 20a on one rank of the (2, 2) mesh: the whole weights drawn
    from seed 0 on the card (the single rank's), moved to the host and
    cut to the rank's shard; ``steps.build_train``'s step with ZeRO-1 on
    the synthetic stream's batches; after the first step the rank's
    parameters against its part of the single rank's (``path``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.sharding import collectives as CL
    from repro_torch.sharding import rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import parallel as P
    from repro_torch.train import train_loop as TL
    t0 = time.perf_counter()
    d, m = TP_TRAIN_MESH
    mesh = make_mesh_for(d * m, model_parallel=m, device=args.device_type)
    cfg = get_config("qwen3-1.7b").with_(dtype=torch.float32)
    whole = R.init_params(cfg, seed=0).to("cpu")
    torch.cuda.empty_cache()
    local = R.shard_params(whole, cfg, mesh)
    del whole
    opt = O.AdamWConfig(**TRAIN_OPT)
    step = steps.build_train(cfg, mesh, "train_4k", opt_cfg=opt, accum=1,
                             zero1=True)[0]
    state = TL.make_train_state(local, opt, zero1=True)
    plan = P.plan_for(local, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _zero_counts()
    CL.reset()
    losses, walls, cmp, coll = [], [], None, None
    for i in range(TRAIN_FULL_STEPS):
        if i == 1:
            CL.reset()
        t = time.perf_counter()
        state, met = step(state, _train_batch(cfg, TRAIN_FULL_BATCH,
                                              TP_TRAIN_SEQ, i, args.device))
        losses.append(met["loss"].item())
        walls.append(time.perf_counter() - t)
        if i == 0:
            want = torch.load(path, mmap=True)
            cmp = _params_close(
                {n: p.detach() for n, p in local.named_parameters()},
                {n: rules.local_shard(want[n], plan.spec[n], mesh)
                 for n, _ in local.named_parameters()}, opt.lr)
            del want
        if i == 1:
            coll = CL.stats()
    return {"coords": mesh.coords, "losses": losses, "walls": walls,
            "cmp": cmp, "collectives": coll, "launches": _counts(),
            "peak": torch.cuda.max_memory_allocated(),
            "shard_bytes": _param_bytes(local),
            "moment_bytes": sum(t.numel() * 4 for t in
                                state["opt"]["m"].values()) * 2,
            "seconds": (t1 - t0, time.perf_counter() - t1)}


def _tp_smoke_run(args, dev, kind) -> dict:
    """DDP with each compressor on ranks 0-1, two ``build_train`` steps
    of each of ``TP_SMOKE_TRAIN`` on (1, 2) (ranks 0-1), and
    ``TP_DECODE_STEPS`` decode steps of glm4 SMOKE with ``seq_shard`` on
    (2, 2), on ``dev``; the weights from a seed on the CPU, the same on
    both devices.  Returns the losses, the parameters after the steps
    (whole), the logits (the rank's rows and vocab slice) and the
    kernels' launches (the card's); arrays, not tensors (a tensor leaves
    the rank as a shared-memory handle that dies with it)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import registry as R
    from repro_torch.train import optimizer as O
    from repro_torch.train import parallel as P
    from repro_torch.train import train_loop as TL
    _zero_counts()
    out = {}
    pair = dist.new_group([0, 1])
    opt = O.AdamWConfig(**TRAIN_OPT)
    if args.rank < 2:
        cfg = get_smoke_config("qwen2-0.5b").with_(dtype=torch.float32,
                                                    **TP_SMOKE_TINY)
        batch = _train_batch(cfg, 8, 16, 0, dev)
        for comp in (None, "bf16", "int8"):
            model = R.init_params(cfg, seed=0, device="cpu").to(dev)
            state = TL.make_train_state(model, opt)
            state, met = TL.make_ddp_train_step(cfg, opt, pair, comp)(
                state, batch)
            out[("ddp", comp)] = (met["loss"].item(), {
                n: p.detach().cpu().numpy()
                for n, p in model.named_parameters()})
    mesh = make_mesh_for(2, model_parallel=2, device=kind)
    for arch in TP_SMOKE_TRAIN:
        if not mesh.member:
            continue
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        local = R.shard_params(R.init_params(cfg, seed=0, device="cpu"), cfg,
                               mesh)
        step = steps.build_train(cfg, mesh, "train_4k", opt_cfg=opt,
                                 accum=1, zero1=True)[0]
        state = TL.make_train_state(local, opt, zero1=True)
        plan = P.plan_for(local, True)
        losses = []
        for i in range(2):
            state, met = step(state, _train_batch(cfg, 4, 32, i, dev))
            losses.append(met["loss"].item())
        out[("train", arch)] = (losses, {
            n: plan.whole(n, p.detach()).cpu().numpy()
            for n, p in local.named_parameters()})
    mesh = make_mesh_for(4, model_parallel=2, device=kind)
    cfg = get_smoke_config("glm4-9b").with_(dtype=torch.float32)
    local = R.shard_params(R.init_params(cfg, seed=0, device="cpu"), cfg,
                           mesh)
    cache = R.make_cache(local, cfg, 2, 64, dtype=torch.float32,
                         seq_shard=True)
    logits = []
    for i in range(TP_DECODE_STEPS):
        toks = np.random.default_rng(40 + i).integers(0, cfg.vocab_size,
                                                      size=(2, 1))
        lg, cache = R.decode_step(local, cache, {"tokens": torch.as_tensor(
            toks, device=dev)}, cfg)
        logits.append(lg.cpu().numpy())
    out["decode"] = (mesh.coords, logits)
    out["launches"] = _counts()
    return out


def phase_tp_train(smi: str) -> dict:
    """Phase 20: training and the generic decode across devices, the ranks
    sharing the card over gloo (``launch.ranks.spawn``; NCCL puts no two
    ranks on one device, so no NCCL or NVLink time is measured here).
    (a) qwen3-1.7b at full width in f32 on a (2, 2) mesh of 4 ranks (see
    ``TP_TRAIN_MESH``) against the single rank, run first on the same
    seeded weights and batches and freed before the spawn: losses,
    parameters after the first step, each rank's card peak, the
    collectives of a step, the flash kernels launched at a rank's shapes.
    (a') mamba2-2.7b at full width, its depth cut, on (1, 2) against the
    single rank's step (``TP_SSM_ARCH``).  (b) The SMOKE scenarios (``_tp_smoke_run``) on 4 ranks of the card
    against 4 of the CPU.  Returns the kernels' launches summed over the
    ranks of both."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import ranks
    from repro_torch.models import registry as R
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = get_config("qwen3-1.7b").with_(dtype=torch.float32)
    opt = O.AdamWConfig(**TRAIN_OPT)
    model = R.init_params(cfg, seed=0)
    state = TL.make_train_state(model, opt)
    step = TL.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="tp_train_")
    path = os.path.join(tmp, "step1.pt")
    losses, walls = [], []
    try:
        for i in range(TRAIN_FULL_STEPS):
            t = time.perf_counter()
            state, met = step(state, _train_batch(
                cfg, TRAIN_FULL_BATCH, TP_TRAIN_SEQ, i, "cuda"))
            losses.append(met["loss"].item())
            walls.append(time.perf_counter() - t)
            if i == 0:
                torch.save({n: p.detach().cpu()
                            for n, p in model.named_parameters()}, path)
        peak1 = torch.cuda.max_memory_allocated()
        del model, state, step, met
        torch.cuda.empty_cache()
        # 20a': the single rank's mamba2 step on the same seeded weights
        ssm_cfg = _tp_ssm_cfg()
        ssm_opt = O.AdamWConfig(**TRAIN_SSM_OPT)
        model = R.init_params(ssm_cfg, seed=0)
        state, met = TL.make_train_step(ssm_cfg, ssm_opt)(
            TL.make_train_state(model, ssm_opt), _train_batch(
                ssm_cfg, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, 0, "cuda"))
        ssm_loss = met["loss"].item()
        ssm_path = os.path.join(tmp, "ssm_step1.pt")
        torch.save({n: p.detach().cpu()
                    for n, p in model.named_parameters()}, ssm_path)
        del model, state, met
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res, ssm, smoke = zip(*ranks.spawn(
            _tp_train_rank, int(np.prod(TP_TRAIN_MESH)), None,
            args=(path, ssm_path), timeout=600))
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"flash_attention": 0, "flash_attention_bwd": 0,
                "ssd_chunked": 0, "ssd_chunked_bwd": 0,
                "decode_attention": 0}
    L = cfg.n_layers
    for r in res:
        tag = f"tp train: rank {r['coords']}"
        for i, (a, b) in enumerate(zip(r["losses"], losses)):
            _check(abs(a - b) <= TP_TRAIN_LOSS_TOL * abs(b),
                   f"{tag}: step {i} loss {a} against the single rank's {b}")
        n, off, far, worst = r["cmp"]
        _check(far == 0 and off <= TRAIN_OFF * n,
               f"{tag}: after step 1 {off} of {n} parameters beyond "
               f"TRAIN_TOL, {far} beyond 2 lr (largest {worst:.3g})")
        got = r["launches"]
        _check(got["flash_attention"] == 2 * L * TRAIN_FULL_STEPS
               and got["flash_attention_bwd"] == L * TRAIN_FULL_STEPS,
               f"{tag}: launches {got}")
        for name in launches:
            launches[name] += got[name]
    ssm = [r for r in ssm if r is not None]
    _check(len(ssm) == 2, f"tp train ssm: {len(ssm)} ranks of (1, 2)")
    Ls = TP_SSM_LAYERS
    for r in ssm:
        tag = f"tp train ssm: rank {r['coords']}"
        _check(abs(r["loss"] - ssm_loss) <= TP_TRAIN_LOSS_TOL * abs(ssm_loss),
               f"{tag}: loss {r['loss']} against the single rank's "
               f"{ssm_loss}")
        n, off, far, worst = r["cmp"]
        _check(far == 0 and off <= TRAIN_OFF * n,
               f"{tag}: after the step {off} of {n} parameters beyond "
               f"TRAIN_TOL, {far} beyond 2 lr (largest {worst:.3g})")
        got = r["launches"]
        _check(got["ssd_chunked"] == 2 * Ls
               and got["ssd_chunked_bwd"] == Ls, f"{tag}: launches {got}")
        for name in launches:
            launches[name] += got[name]
    print(f"tp train ssm [{smi}]: {TP_SSM_ARCH} f32 at full width, "
          f"{Ls} Mamba2 layers, on (1, 2), one step of {TRAIN_FULL_BATCH} "
          f"x {TRAIN_FULL_SEQ} tokens: losses "
          f"{[r['loss'] for r in ssm]} against the single rank's "
          f"{ssm_loss} (limit {TP_TRAIN_LOSS_TOL} relative); after the "
          f"step " + "; ".join(
              f"{r['coords']} {r['cmp'][1]} of {r['cmp'][0]} beyond "
              f"TRAIN_TOL, largest {r['cmp'][3]:.3g}" for r in ssm)
          + f"; a rank's step {[round(r['wall'] * 1e3, 1) for r in ssm]} "
          f"ms (the first); launches a rank {ssm[0]['launches']}")
    gib = 2.0 ** 30
    ms = [1e3 * sum(r["walls"][1:]) / max(len(r["walls"]) - 1, 1)
          for r in res]
    print(f"tp train [{smi}]: {cfg.name} f32 on a {TP_TRAIN_MESH} mesh of "
          f"{len(res)} ranks on one card (gloo), ZeRO-1, "
          f"{TRAIN_FULL_STEPS} steps of {TRAIN_FULL_BATCH} x "
          f"{TP_TRAIN_SEQ} tokens: losses {[round(x, 5) for x in res[0]['losses']]} "
          f"against the single rank's {[round(x, 5) for x in losses]} "
          f"(limit {TP_TRAIN_LOSS_TOL} relative); after step 1 "
          + "; ".join(f"{r['coords']} {r['cmp'][1]} of {r['cmp'][0]} beyond "
                      f"TRAIN_TOL, largest {r['cmp'][3]:.3g}" for r in res))
    print(f"tp train: steps a rank {[round(x, 1) for x in ms]} ms (the "
          f"second; the first {[round(r['walls'][0] * 1e3, 1) for r in res]}"
          f" ms) against the single rank's {walls[1] * 1e3:.1f} ms "
          f"(first {walls[0] * 1e3:.1f} ms); each rank's card peak "
          + ", ".join(f"{r['coords']} {r['peak'] / gib:.2f} GiB" for r in res)
          + f" (shard {res[0]['shard_bytes'] / gib:.2f} GiB, moments "
          f"{res[0]['moment_bytes'] / gib:.2f} GiB) against the single "
          f"rank's {peak1 / gib:.2f} GiB")
    print("tp train: collectives of one step (rank 0): " + ", ".join(
        f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB handed, "
        f"{v['wire_bytes'] / 2**20:.1f} MiB on the wire"
        for k, v in res[0]["collectives"].items() if v["calls"]))
    print(f"tp train: launches a rank {[(r['coords'], r['launches']) for r in res]};"
          f" single rank {t1 - t0:.1f} s, the ranks' spawn with (b) "
          f"{t2 - t1:.1f} s (rank 0: mesh, weights and shard "
          f"{res[0]['seconds'][0]:.1f} s, steps {res[0]['seconds'][1]:.1f} "
          f"s, (b) {res[0]['seconds'][2]:.1f} s)")
    torch.cuda.empty_cache()
    # (b) the SMOKE scenarios, the card against the CPU
    card, cpu = zip(*smoke)
    for rg, rc in zip(card, cpu):
        for key, val in rc.items():
            if key == "launches":
                continue
            if key == "decode":
                _check(val[0] == rg[key][0], f"tp smoke: decode coords")
                err = max(float(np.abs(a - b).max())
                          for a, b in zip(rg[key][1], val[1]))
                _check(err <= TOL["float32"][0] * 10,
                       f"tp smoke: glm4 seq-sharded decode {val[0]} logits "
                       f"off the CPU's by {err:.3g}")
                continue
            loss_g, p_g = rg[key]
            loss_c, p_c = val
            lg = np.atleast_1d(loss_g)
            lc = np.atleast_1d(loss_c)
            _check(bool(np.all(np.abs(lg - lc) <= 1e-5 * np.abs(lc))),
                   f"tp smoke {key}: losses {lg} against the CPU's {lc}")
            n, off, far, worst = _params_close(p_g, p_c, opt.lr)
            _check(far == 0 and off <= TRAIN_OFF * n + 1,
                   f"tp smoke {key}: {off} of {n} parameters beyond "
                   f"TRAIN_TOL, {far} beyond 2 lr (largest {worst:.3g})")
    for r in card:
        for name in launches:
            launches[name] += r["launches"][name]
    _check(all(n > 0 for n in launches.values()),
           f"tp: a kernel of phase 20's path was not launched: {launches}")
    print(f"tp smoke: DDP f32 / bf16 / int8 on 2 ranks, {', '.join(TP_SMOKE_TRAIN)} "
          f"trained on (1, 2), glm4's seq-sharded decode on (2, 2) "
          f"({TP_DECODE_STEPS} steps): the card equals the CPU; launches "
          f"a rank {[r['launches'] for r in card]}")
    print(f"tp: phase 20 (a, b) {time.perf_counter() - t0:.1f} s")
    return launches


# phase 20c: the kernels of the training and decode paths at a rank's
# shapes: qwen3-1.7b's attention in phase 20a (2 rows of 512, 8 query
# heads over 4 KV heads) and mamba2-2.7b's scan in phase 20a' (40 of its
# 80 heads, 4 x 1024), both driven at those shapes; and glm4-9b's decode
# on (2, 4) with seq_shard (every head, 32 over 2, on a segment of 4096
# of 32768 positions, its first 1700 seen, a window of 1024 ending 300
# positions past them: in the next segment) — a shape no driven path
# gives: phase 20 drives the sequence-sharded decode at SMOKE width only,
# and the record's launches are that decode's
TP_FLASH = dict(b=2, sq=TP_TRAIN_SEQ, K=4, g=2, dh=128)
TP_SSD = dict(b=4, s=1024, H=40, P=64, G=1, N=128, chunk=128)
TP_SEGMENT = dict(b=4, S=4096, K=2, g=16, dh=128, length=1700, window=1024,
                  end=2000)


def _rank_record(name: str, label: str, err: float, limit: float,
                 kern, plain, lib, n_bytes: float, n_ops: float,
                 reps: int = 10) -> dict:
    """Check ``err`` <= ``limit`` and time the kernel, its plain version
    and the library call (None: no single PyTorch call computes it)."""
    _check(err <= limit, f"{name} {label}: error {err:.3g} beyond "
                         f"{limit:.3g}")
    ms = _time_ms(kern, reps=reps, warmup=2)
    plain_ms = _time_ms(plain, reps=3, warmup=1)
    lib_ms = None if lib is None else _time_ms(lib, reps=reps, warmup=2)
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, "float32",
                                   name.replace("_rank", ""))
    print(f"kernel {name} {label}: max_abs_err {err:.3g} (limit "
          f"{limit:.3g}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms "
          f"{bound_ms:.5f} ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def phase_tp_train_kernels() -> dict:
    """Phase 20c: the flash forward and backward, the SSD scan and its
    backward, and the contiguous decode with its window end and lse, f32,
    at a rank's shapes of phase 20's meshes (``TP_FLASH``, ``TP_SSD``,
    ``TP_SEGMENT``), held to their plain versions (``TOL``, ``SSD_TOL``,
    ``SSD_BWD_TOL``, ``LSE_TOL``) and timed beside them and, where one
    PyTorch call computes the same, that call (SDPA).  Two launches of
    the flash backward, and of the SSD backward, must give the same bits;
    the flash backward's split count is printed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels import ssd_scan as SSD
    f32 = torch.float32
    rec = {}
    # the flash forward and backward
    b, sq, K, g, dh = (TP_FLASH[k] for k in ("b", "sq", "K", "g", "dh"))
    q, k, v = _flash_case(sq, f32, seed=70, K=K, g=g, dh=dh, b=b)
    torch.manual_seed(71)
    do = torch.randn_like(q)
    out, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    want = REF.flash_attention_ref(q, k, v, causal=True)
    label = f"b={b} sq={sq} H={K * g} K={K} dh={dh} causal f32"
    atol, rtol = TOL["float32"]
    err = (out - want).abs().max().item()
    pairs = b * K * g * sq * (sq + 1) // 2
    rec["flash_attention_rank"] = _rank_record(
        "flash_attention_rank", label, err,
        atol + rtol * want.abs().max().item(),
        lambda: FA.flash_attention(q, k, v, causal=True),
        lambda: REF.flash_attention_ref(q, k, v, causal=True),
        _sdpa_flash(q, k, v, 0), 4 * (2 * q.numel() + 2 * k.numel()),
        4 * dh * pairs)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_ref = REF.flash_attention_ref(*leaves, causal=True)
    ref = torch.autograd.grad(o_ref, leaves, do, retain_graph=True)
    grads = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    again = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, c) for a, c in zip(grads, again)),
           f"flash_attention_bwd_rank {label}: two launches differ")
    del again
    n_split = PA.bwd_split_plan(b, sq, sq, K * g, K, _build.sm_count(q.device),
                                PA.BWD_CTAS_PER_SM[f32])
    print(f"kernel flash_attention_bwd_rank {label}: n_split {n_split}; two "
          f"launches bit-equal")
    err = max((a - w).abs().max().item() / w.abs().max().item()
              for a, w in zip(grads, ref))
    qq, kq, vq = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qq, kq, vq, is_causal=True,
                                           enable_gqa=True)
    do_lib = do.transpose(1, 2).contiguous()
    rec["flash_attention_bwd_rank"] = _rank_record(
        "flash_attention_bwd_rank", label + " (dq, dk, dv: error over the "
        "largest magnitude)", err, BWD_TOL["float32"],
        lambda: FA.flash_attention_bwd(q, k, v, out, lse, do, causal=True),
        lambda: torch.autograd.grad(o_ref, leaves, do, retain_graph=True),
        lambda: torch.autograd.grad(o_lib, (qq, kq, vq), do_lib,
                                    retain_graph=True),
        4 * (4 * q.numel() + 4 * k.numel() + lse.numel()), 10 * dh * pairs)
    rec["flash_attention_bwd_rank"]["max_abs_err"] = max(
        (a - w).abs().max().item() for a, w in zip(grads, ref))
    del q, k, v, do, out, lse, want, leaves, o_ref, ref, grads, qq, kq, vq
    del o_lib, do_lib
    torch.cuda.empty_cache()
    # the SSD scan and its backward at mamba2's rank widths
    sh = TP_SSD
    SSD_SHAPES["mamba2_rank"] = {k: sh[k] for k in ("H", "P", "G", "N",
                                                    "chunk")}
    b, s, c = sh["b"], sh["s"], sh["chunk"]
    args = _ssd_case("mamba2_rank", b, s, f32, seed=72)
    x, dt, A, B, C = args
    y, st, states = SSD.ssd_chunked(*args, chunk=c, return_states=True)
    torch.cuda.synchronize()
    y_ref, st_ref = REF.ssd_chunked_ref(*args, c)
    err = max((y - y_ref).abs().max().item() / y_ref.abs().max().item(),
              (st - st_ref).abs().max().item() / st_ref.abs().max().item())
    H, P, N = sh["H"], sh["P"], sh["N"]
    label = f"b={b} s={s} H={H} P={P} G={sh['G']} N={N} c={c} f32"
    io = 4 * (x.numel() + B.numel() + C.numel() + dt.numel() + A.numel())
    rec["ssd_chunked_rank"] = _rank_record(
        "ssd_chunked_rank", label + " (error over the largest magnitude)",
        err, SSD_TOL, lambda: SSD.ssd_chunked(*args, chunk=c),
        lambda: REF.ssd_chunked_ref(*args, c), None,
        io + 4 * (y.numel() + st.numel()), _ssd_fwd_ops(b, s, H, P, N, c),
        reps=5)
    rec["ssd_chunked_rank"]["max_abs_err"] = max(
        (y - y_ref).abs().max().item(), (st - st_ref).abs().max().item())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(73)
    dy = torch.randn(x.shape, device="cuda", generator=gen)
    grads = SSD.ssd_chunked_bwd(*args, states, dy, chunk=c)
    again = SSD.ssd_chunked_bwd(*args, states, dy, chunk=c)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, w) for a, w in zip(grads, again)),
           f"ssd_chunked_bwd_rank {label}: two launches differ")
    del again
    leaves = [t.detach().requires_grad_() for t in args]
    yl, _ = REF.ssd_chunked_ref(*leaves, c)
    ref = torch.autograd.grad(yl, leaves, dy, retain_graph=True)
    err = max((a.float() - w.float()).abs().max().item()
              / w.float().abs().max().item() for a, w in zip(grads, ref))
    rec["ssd_chunked_bwd_rank"] = _rank_record(
        "ssd_chunked_bwd_rank", label + " (dx, ddt, dA, dB, dC: error over "
        "the largest magnitude)", err, SSD_BWD_TOL["float32"],
        lambda: SSD.ssd_chunked_bwd(*args, states, dy, chunk=c),
        lambda: torch.autograd.grad(yl, leaves, dy, retain_graph=True),
        None, 2 * io + 4 * (dt.numel() + A.numel() + dy.numel()
                            + states.numel()),
        _ssd_bwd_ops(b, s, H, sh["G"], P, N, c), reps=5)
    rec["ssd_chunked_bwd_rank"]["max_abs_err"] = max(
        (a.float() - w.float()).abs().max().item() for a, w in zip(grads, ref))
    del args, x, dt, A, B, C, y, st, states, y_ref, st_ref, dy, grads
    del leaves, yl, ref
    torch.cuda.empty_cache()
    # a segment of glm4's sequence-sharded decode: every head's query over
    # the rank's positions, the window end past the segment's end
    sg = TP_SEGMENT
    b, S, K, g, dh, length, window, end = (
        sg[k] for k in ("b", "S", "K", "g", "dh", "length", "window", "end"))
    q, kc, vc, ln = _contig_decode_case(b, f32, seed=74, S=S, K=K, g=g,
                                        dh=dh, lengths=length)
    wend = torch.tensor(end, dtype=torch.int32, device="cuda")
    args = dict(window=window, window_end=wend, return_lse=True)
    out, lse = DA.decode_attention(q, kc, vc, ln, **args)
    torch.cuda.synchronize()
    want, want_lse = REF.decode_attention_ref(q, kc, vc, ln, **args)
    seen = length - (end - window)
    pos = torch.arange(S, device="cuda")
    mask = ((pos >= end - window) & (pos < length))[None, None, None]
    kq, vq = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    lse_err = (lse - want_lse).abs().max().item()
    _check(lse_err <= LSE_TOL, f"decode_attention_lse_rank: lse |err| "
                               f"{lse_err:.3g} beyond {LSE_TOL}")
    err = (out - want).abs().max().item()
    rec["decode_attention_lse_rank"] = _rank_record(
        "decode_attention_lse_rank",
        f"b={b} S={S} length {length} window {window} window_end {end} "
        f"H={K * g} K={K} dh={dh} f32 (lse |err| {lse_err:.3g}; glm4-9b's "
        f"segment on (2, 4), not a driven path's shape: the launches are "
        f"glm4 SMOKE's seq-sharded decode on (2, 2))", err,
        atol + rtol * want.abs().max().item(),
        lambda: DA.decode_attention(q, kc, vc, ln, **args),
        lambda: REF.decode_attention_ref(q, kc, vc, ln, **args),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None], kq, vq, attn_mask=mask, enable_gqa=True),
        4 * (2 * q.numel() + 2 * b * seen * K * dh + b * K * g),
        4 * b * seen * K * g * dh)
    del q, kc, vc, out, lse, want, want_lse, kq, vq
    torch.cuda.empty_cache()
    return rec


# =============================================================================
# main
# =============================================================================
KERNELS = (
    ("paged_decode_attention",
     "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:90"),
    ("paged_prefill_attention",
     "src/repro_torch/kernels/csrc/paged_prefill.cu",
     "src/repro/kernels/flash_attention.py:80"),
    ("decode_attention",
     "src/repro_torch/kernels/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention.py:65"),
    ("flash_attention",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:80"),
    ("flash_attention_f32",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:80"),
    ("ssd_chunked",
     "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:72"),
    ("flash_attention_bwd",
     "src/repro_torch/kernels/csrc/flash_backward.cu",
     "the gradient of src/repro/kernels/flash_attention.py:80 (the "
     "reference differentiates jnp blocked_attention; no Pallas backward)"),
    ("ssd_chunked_bwd",
     "src/repro_torch/kernels/csrc/ssd_backward.cu",
     "the gradient of src/repro/kernels/ssd_scan.py:72 (the reference "
     "differentiates jnp ssd_ref; no Pallas backward)"),
    # the two paged kernels at a rank's shapes of phase 19's mesh, with
    # the ranks' launches
    ("paged_decode_attention_rank",
     "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:90"),
    ("paged_prefill_attention_rank",
     "src/repro_torch/kernels/csrc/paged_prefill.cu",
     "src/repro/kernels/flash_attention.py:80"),
    # the training and generic decode paths' kernels at a rank's shapes of
    # phase 20's meshes, with the ranks' launches
    ("flash_attention_rank",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:80"),
    ("flash_attention_bwd_rank",
     "src/repro_torch/kernels/csrc/flash_backward.cu",
     "the gradient of src/repro/kernels/flash_attention.py:80 (the "
     "reference differentiates jnp blocked_attention; no Pallas backward)"),
    ("ssd_chunked_rank",
     "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:72"),
    ("ssd_chunked_bwd_rank",
     "src/repro_torch/kernels/csrc/ssd_backward.cu",
     "the gradient of src/repro/kernels/ssd_scan.py:72 (the reference "
     "differentiates jnp ssd_ref; no Pallas backward)"),
    ("decode_attention_lse_rank",
     "src/repro_torch/kernels/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention.py:65"),
)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # f32 products in full f32 (the comparisons' tolerances assume it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_device_build()
    t1 = time.perf_counter()
    records = phase_kernels()
    records.update(phase_ssd_kernels())
    t = time.perf_counter()
    phase_split_decode_kernels()
    SPLIT_SECONDS["a"] = time.perf_counter() - t
    t2 = time.perf_counter()
    launches = phase_serve()
    t3 = time.perf_counter()
    slotted = phase_slotted_serve()
    t4 = time.perf_counter()
    phase_clover()
    t5 = time.perf_counter()
    phase_parity()
    t6 = time.perf_counter()
    launches.update(phase_ssm())
    t7 = time.perf_counter()
    hybrid = phase_hybrid()
    t8 = time.perf_counter()
    preempt = phase_preempt_serve()
    t9 = time.perf_counter()
    phase_ssm_parity()
    t10 = time.perf_counter()
    fleet = phase_fleet()
    t11 = time.perf_counter()
    fleet_parity = phase_fleet_parity()
    t12 = time.perf_counter()
    phase_sim()
    t13 = time.perf_counter()
    dense = phase_dense()
    t14 = time.perf_counter()
    dense_parity = phase_dense_parity()
    t15 = time.perf_counter()
    # free what earlier phases cached before the largest model
    torch.cuda.empty_cache()
    moe = phase_moe()
    t16 = time.perf_counter()
    moe_parity = phase_moe_parity()
    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    disagg = phase_disagg()
    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    phase_encdec_vl_kernels()
    encdec = phase_encdec(smi)
    vl = phase_vl(smi)
    encdec_vl_parity = phase_encdec_vl_parity()
    t19 = time.perf_counter()
    torch.cuda.empty_cache()
    records.update(phase_train_kernels())
    records.update(phase_train_ssd_kernels())
    launches["flash_attention_bwd"] = 0
    launches["ssd_chunked_bwd"] = 0
    train_parity = phase_train_parity()
    train_full = phase_train_full(smi)
    train_full_ssm = phase_train_full_ssm(smi)
    t20 = time.perf_counter()
    torch.cuda.empty_cache()
    tp = phase_tp_serve()
    records.update(phase_tp_kernels())
    t21 = time.perf_counter()
    torch.cuda.empty_cache()
    tp_train = phase_tp_train(smi)
    records.update(phase_tp_train_kernels())
    t22 = time.perf_counter()
    # the flash records: the hybrid forward's shape (bf16, 4 x 4096, 32
    # heads of 80) with that forward's launches, and the slotted serve's
    # f32 prefill (1024 tokens) with the serve's launches
    launches["decode_attention"] = slotted["decode_attention"]
    launches["flash_attention_f32"] = slotted["flash_attention"]
    launches["flash_attention"] = hybrid["flash_attention"]
    for name, n in preempt.items():       # the paged kernels' two serves
        launches[name] += n
    for name, n in fleet.items():         # and the full-width fleet's probes
        launches[name] += n
    for name, n in fleet_parity.items():  # the SMOKE fleet on the card
        launches[name] += n
    # the dense and MoE families' serves and forwards, and their SMOKE
    # engines and decode steps on the card
    for name, n in (list(dense.items()) + list(dense_parity.items())
                    + list(moe.items()) + list(moe_parity.items())):
        launches[name] += n
    for name, n in disagg.items():        # both worker pools' serves
        launches[name] += n
    # the enc-dec and VL forwards, decode replays and SMOKE runs
    for name, n in (list(encdec.items()) + list(vl.items())
                    + list(encdec_vl_parity.items())):
        launches[name] += n
    # training: the SMOKE steps on the card and the full-width steps
    for name, n in (list(train_parity.items()) + list(train_full.items())
                    + list(train_full_ssm.items())):
        launches[name] += n
    # phase 18: the append-buffer decode's and the mesh serves' launches
    for name, n in SPLIT_LAUNCHES.items():
        launches[name] += n
    # phase 19: the ranks' launches, at a rank's shapes
    for name, n in tp.items():
        launches[f"{name}_rank"] = n
    # phase 20: the training and decode ranks' launches, at a rank's shapes
    for name, n in tp_train.items():
        launches[f"{name}_lse_rank" if name == "decode_attention"
                 else f"{name}_rank"] = n
    split_s = sum(SPLIT_SECONDS.values())
    print(f"hybrid launches (one forward): {hybrid}")
    print(f"phases: build {t1 - t0:.1f} s, kernels "
          f"{t2 - t1 - SPLIT_SECONDS['a']:.1f} s, paged serve "
          f"{t3 - t2 - SPLIT_SECONDS['c']:.1f} s, slotted serve "
          f"{t4 - t3:.1f} s, "
          f"clover {t5 - t4:.1f} s, parity {t6 - t5:.1f} s, ssm "
          f"{t7 - t6:.1f} s, hybrid {t8 - t7:.1f} s, preempted serve "
          f"{t9 - t8:.1f} s, ssm parity {t10 - t9:.1f} s, fleet "
          f"{t11 - t10:.1f} s, fleet parity {t12 - t11:.1f} s, sim "
          f"{t13 - t12:.1f} s, dense {t14 - t13 - SPLIT_SECONDS['b']:.1f} s, "
          f"dense parity "
          f"{t15 - t14:.1f} s, moe {t16 - t15:.1f} s, moe parity "
          f"{t17 - t16:.1f} s, disagg {t18 - t17:.1f} s, encdec/vl "
          f"{t19 - t18:.1f} s, training {t20 - t19:.1f} s, split decode "
          f"and mesh (18a-c) {split_s:.1f} s, ranks (19) {t21 - t20:.1f} s, "
          f"ranks training (20) {t22 - t21:.1f} s, total {t22 - t0:.1f} s")
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **records[name]}
               for name, source, replaces in KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
