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
   at 1 x 32768 (32-column P slices).  Each case prints its time, the
   plain version's, one ``scaled_dot_product_attention`` call as a
   yardstick (none computes the scan), and the least time the card could
   take (for f32 work multiplied as split bf16, also at the CUDA cores'
   f32 peak);
3. the paged engine serving 8 requests at the full width of qwen3-1.7b
   (28 layers, bf16 random weights from a seed), with both paged kernels
   counted; then the profiles of one fused 8-step decode dispatch and of
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
   the forward; then the same replay check with f32 weights;
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
11. the ``kernels`` line: every ported kernel with its launches on the main
   paths that run it (phases 3 and 9 for the paged kernels, phase 4 for the
   contiguous decode and the f32 contiguous prefill, whose record is the
   slotted serve's 1024-token shape, phase 7 for the scan, phase 8's
   forward for the bf16 contiguous prefill, whose record is that
   forward's shape).

Any failed check raises, and the script exits non-zero without printing a
result.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
SPLIT_BF16 = ("paged_prefill_attention", "flash_attention", "ssd_chunked")
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


def _sdpa_decode(q, ka, va, tables, lengths):
    """Yardstick: one scaled_dot_product_attention call on the gathered
    K/V (gather outside the timed call) with a per-row length mask."""
    from repro_torch.kernels.ref import gather_paged_kv
    kc, vc = gather_paged_kv(ka, va, tables)
    return _sdpa_contig_decode(q, kc, vc, lengths)


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
                dh: int = 128, b: int = 1):
    """Random contiguous-prefill inputs: b prompts of sq tokens."""
    import torch
    torch.manual_seed(seed)
    dev = "cuda"
    q = torch.randn(b, sq, K * g, dh, device=dev).to(dtype)
    k = torch.randn(b, sq, K, dh, device=dev).to(dtype)
    v = torch.randn(b, sq, K, dh, device=dev).to(dtype)
    return q, k, v


def _sdpa_contig_decode(q, kc, vc, lengths):
    import torch
    import torch.nn.functional as F
    kq = kc.transpose(1, 2).contiguous()              # (b, K, S, dh)
    vq = vc.transpose(1, 2).contiguous()
    qq = q[:, :, None, :]                              # (b, H, 1, dh)
    mask = (torch.arange(kc.shape[1], device=q.device)[None, :]
            < lengths.reshape(-1, 1))[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask,
                                                  enable_gqa=True)


def _sdpa_flash(q, k, v, window: int):
    import torch
    import torch.nn.functional as F
    qq, kq, vq = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qq, kq, vq, is_causal=True, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < window)
    return lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask,
                                                  enable_gqa=True)


# zamba2's shared attention: 32 heads of 80 over 32 KV heads (g = 1); its
# decode step reads a cache of 128 prompt + 32 new positions at one shared
# length (lengths=160 in a case)
ZAMBA2_ATTN = dict(K=32, g=1, dh=80)
# zamba2 SMOKE's: 4 heads of 16 over 4 KV heads
ZAMBA2_SMOKE_ATTN = dict(K=4, g=1, dh=16)


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
    with a window, and at zamba2 SMOKE's head dim 16, in both types."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as REF
    records = {}
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
             + [("prefill", 992, d, dict(window=256)) for d in (f32, bf16)])
    # the case whose numbers each record of the kernels line carries
    headlines = {("decode", 8, "float32", ()): "paged_decode_attention",
                 ("prefill", 992, "float32", ()): "paged_prefill_attention",
                 ("contig_decode", 8, "float32", ()): "decode_attention",
                 ("flash", (4096, 0), "bfloat16",
                  tuple(sorted(dict(ZAMBA2_ATTN, b=4).items()))):
                     "flash_attention",
                 ("flash", (1024, 0), "float32", ()): "flash_attention_f32"}
    for i, (kind, arg, dtype, *shape) in enumerate(cases):
        shape = dict(shape[0]) if shape else {}
        dname = str(dtype).replace("torch.", "")
        key = (kind, arg, dname, tuple(sorted(shape.items())))
        elt = torch.tensor([], dtype=dtype).element_size()
        if kind == "decode":
            args = _decode_case(arg, dtype, seed=i, **shape)
            kern = lambda a=args: PA.paged_decode_attention(*a)
            plain = lambda a=args: REF.paged_decode_attention_ref(*a)
            lib = _sdpa_decode(*args)
            q, ka, va, tables, lengths = args
            H, dh = q.shape[1], q.shape[2]
            K = ka.shape[2]
            ln = lengths.long().cpu()
            pages = (-(-ln // ka.shape[1])).sum().item()
            n_bytes = (2 * q.numel() * elt + 2 * int(ln.sum()) * K * dh * elt
                       + 4 * (pages + len(ln)))
            n_ops = 4 * int(ln.sum()) * H * dh
            name, label = "paged_decode_attention", f"b={arg}"
            if shape:
                label += f" lengths {tuple(int(x) for x in ln)}"
        elif kind == "contig_decode":
            args = _contig_decode_case(arg, dtype, seed=i, **shape)
            kern = lambda a=args: DA.decode_attention(*a)
            plain = lambda a=args: REF.decode_attention_ref(*a)
            lib = _sdpa_contig_decode(*args)
            q, kc, vc, lengths = args
            H, dh, K = q.shape[1], q.shape[2], kc.shape[2]
            ln = lengths.long().cpu().clamp(max=kc.shape[1]).expand(arg)
            n_bytes = (2 * q.numel() * elt + 2 * int(ln.sum()) * K * dh * elt
                       + lengths.numel() * 4)
            n_ops = 4 * int(ln.sum()) * H * dh
            name, label = "decode_attention", f"b={arg}"
            if shape:
                given = tuple(int(x) for x in lengths.reshape(-1).cpu())
                label += (f" S={kc.shape[1]} H={H} dh={dh} lengths "
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
            args = _flash_case(sq, dtype, seed=i, **shape)
            kern = lambda a=args, w=window: FA.flash_attention(*a, window=w)
            plain = lambda a=args, w=window: REF.flash_attention_ref(
                *a, window=w)
            lib = _sdpa_flash(*args, window)
            q, k, v = args
            H, dh, K = q.shape[2], q.shape[3], k.shape[2]
            qpos = torch.arange(sq)
            visible = qpos + 1 if window <= 0 else (qpos + 1).clamp(
                max=window)
            n_bytes = 2 * q.numel() * elt + 2 * k.numel() * elt
            n_ops = 4 * dh * H * int(visible.sum()) * q.shape[0]
            name, label = "flash_attention", f"sq={sq} window={window}"
            if shape:
                label += f" b={q.shape[0]} H={H} K={K} dh={dh}"
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


def _device_profile(fn, steps: int, t_wall: float, parts: dict) -> str:
    """Device time per step of ``fn`` (which runs ``steps`` decode steps,
    or one forward) from torch.profiler: the sum over device events
    (kernels, copies, fills), each counted once — the CPU op that launched
    a kernel carries its time too, so CPU events are left out — with the
    time of the kernels each predicate of ``parts`` picks (by label), the
    number of device events, the idle share against the wall time
    ``t_wall`` of ``fn``, and the five largest events by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    heads, bf16 weights, f32 arena) serving 8 requests of 32 new tokens;
    returns each kernel's launches during the serve."""
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
    n_new = 32
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
    (8 slots of 2048 positions) serving the 8 requests of phase 3, 32 new
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
    n_new = 32
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
# f32 (2 prompts of 256 tokens): 4.8e-6 and 3.5e-6, with the plain scan
# 4.7e-6 and 3.7e-6; the limit sits ~20x above them and rejects a scan
# whose y is 0.2% low (7.6e-4, 1.1e-3)
REPLAY_TOL = {"bfloat16": 6e-2, "float32": 1e-4}


def _counters() -> dict:
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    return {"ssd_chunked": SSD.ssd_chunked,
            "flash_attention": FA.flash_attention,
            "decode_attention": DA.decode_attention}


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _forward_run(tag: str, model, b: int, s: int, per_forward: dict,
                 seed: int) -> dict:
    """``registry.forward`` over b random prompts of s tokens: one warm-up
    call, then one timed call whose kernel launches are counted (each
    kernel of ``per_forward`` exactly that often), then one profiled call;
    returns the timed call's launches."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    cfg = model.cfg
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32), device="cuda")

    def fwd():
        return R.forward(model, {"tokens": tokens}, cfg)[0]

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


def _replay(model, prompts, cache):
    """Feed ``prompts`` (b, n) through ``decode_step`` one position at a
    time (the forward returns no SSM state); returns the last position's
    logits and the cache."""
    from repro_torch.models import registry as R
    for i in range(prompts.shape[1]):
        lg, cache = R.decode_step(model, cache,
                                  {"tokens": prompts[:, i:i + 1]}, model.cfg)
    return lg, cache


def _replay_vs_forward(tag: str, model, prompts, lg) -> str:
    """Hold a replay's logits ``lg`` at the last prompt position against
    ``registry.forward``'s over the same prompts, relative to what the
    layers add to them (``REPLAY_TOL`` of the model's type); returns the
    reading."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    cfg = model.cfg
    ref = R.forward(model, {"tokens": prompts}, cfg)[0][:, -1].float()
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
                seed: int, b: int = 4) -> None:
    """Greedy generation through ``make_cache`` and ``decode_step`` (bf16
    cache, the default): b random prompts of n_prompt tokens replayed
    token by token, then n_new tokens.  The replay is held against the
    forward (``_replay_vs_forward``); every decode step launches each
    kernel of ``per_step`` exactly that often."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    cfg = model.cfg
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, n_prompt)).astype(np.int32),
        device="cuda")
    cache = R.make_cache(model, cfg, b, n_prompt + n_new + 1)
    torch.cuda.synchronize()
    _zero_counts()
    t = time.perf_counter()
    lg, cache = _replay(model, prompts, cache)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t
    counts = _counts()
    for name, n in per_step.items():
        _check(counts[name] == n * n_prompt,
               f"{tag}: {counts[name]} {name} launches in {n_prompt} decode "
               f"steps, expected {n} per step")
    reading = _replay_vs_forward(tag, model, prompts, lg)
    tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    out = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n_new):
        out.append(tok)
        lg, cache = R.decode_step(model, cache, {"tokens": tok}, cfg)
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
        lambda: R.decode_step(model, cache, {"tokens": tok}, cfg), 1,
        t_wall / n_new, {
            "attention kernel (split and merge)":
                lambda key: "decode_split_kernel" in key
                and "ContigKV" in key})
    print(f"{tag} decode (batch {b}): replay of {n_prompt} prompt tokens "
          f"{t_replay / n_prompt * 1e3:.2f} ms/step; {reading}; {n_new} new "
          f"tokens: wall {t_wall / n_new * 1e3:.2f} ms/step, host enqueue "
          f"{t_enqueue / n_new * 1e3:.2f} ms/step, {device}")


def _f32_replay_run(tag: str, cfg, seed: int, b: int = 2,
                    n_prompt: int = 256) -> None:
    """The model at full width in f32 (weights from the same seed as the
    bf16 one): b prompts of n_prompt tokens — two chunks, so the scan
    carries its state across a chunk boundary — replayed through
    ``decode_step`` with an f32 cache and held against the forward."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    cfg = cfg.with_(dtype=torch.float32)
    model = R.init_params(cfg, seed=0)
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, n_prompt)).astype(np.int32),
        device="cuda")
    cache = R.make_cache(model, cfg, b, n_prompt + 1, dtype=torch.float32)
    t = time.perf_counter()
    lg, cache = _replay(model, prompts, cache)
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t
    reading = _replay_vs_forward(f"{tag} f32", model, prompts, lg)
    print(f"{tag} f32 replay (batch {b}, {n_prompt} tokens, "
          f"{t_replay / n_prompt * 1e3:.2f} ms/step): {reading}")
    del model, cache
    torch.cuda.empty_cache()


def phase_ssm() -> dict:
    """mamba2-2.7b at full width (64 Mamba2 layers, d_model 2560, d_inner
    5120 = 80 heads of 64, N 128, vocab 50280 padded to 50688, tied), bf16
    weights from the port's seeded init: ``registry.forward`` over 4 x
    4096 and 1 x 32768 tokens (64 ``ssd_chunked`` launches each), and
    greedy generation for 4 prompts of 128 tokens (replayed) plus 32 new
    through ``make_cache`` and ``decode_step``; then the f32 replay check
    (``_f32_replay_run``); returns the scan's launches over the two timed
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
    _greedy_run("ssm", model, 128, 32, {"ssd_chunked": 0,
                                        "decode_attention": 0}, seed=7)
    del model
    torch.cuda.empty_cache()
    _f32_replay_run("ssm", cfg, seed=8)
    return {"ssd_chunked": total}


def phase_hybrid() -> dict:
    """zamba2-2.7b at full width (54 Mamba2 layers, N 64, and one shared
    attention + MLP block of 32 heads of 80, d_ff 10240, after every 6;
    vocab 32000, untied), bf16 weights from the port's seeded init:
    ``registry.forward`` over 4 x 4096 tokens (54 ``ssd_chunked`` and 9
    ``flash_attention`` launches) and greedy generation for 4 prompts of
    128 tokens plus 32 new (9 ``decode_attention`` launches a step); then
    the f32 replay check; returns the timed forward's launches."""
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
    _greedy_run("hybrid", model, 128, 32, {"ssd_chunked": 0,
                                           "decode_attention": G}, seed=13)
    del model
    torch.cuda.empty_cache()
    _f32_replay_run("hybrid", cfg, seed=14)
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


def _replay_greedy(model, prompt, n_new: int):
    """Greedy tokens and every step's logits (on the host) of ``prompt``
    (b, n) replayed through ``decode_step`` and continued n_new tokens, on
    the model's device with an f32 cache."""
    import torch
    from repro_torch.models import registry as R
    cfg = model.cfg
    dev = next(model.parameters()).device
    b, n = prompt.shape
    cache = R.make_cache(model, cfg, b, n + n_new, dtype=torch.float32,
                         device=dev)
    toks = torch.as_tensor(prompt, device=dev)
    for i in range(n):
        lg, cache = R.decode_step(model, cache, {"tokens": toks[:, i:i + 1]},
                                  cfg)
    out, logits = [], []
    for _ in range(n_new):
        logits.append(lg.float().cpu())
        tok = lg.argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok.cpu())
        lg, cache = R.decode_step(model, cache, {"tokens": tok}, cfg)
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
    # the flash records: the hybrid forward's shape (bf16, 4 x 4096, 32
    # heads of 80) with that forward's launches, and the slotted serve's
    # f32 prefill (1024 tokens) with the serve's launches
    launches["decode_attention"] = slotted["decode_attention"]
    launches["flash_attention_f32"] = slotted["flash_attention"]
    launches["flash_attention"] = hybrid["flash_attention"]
    for name, n in preempt.items():       # the paged kernels' two serves
        launches[name] += n
    print(f"hybrid launches (one forward): {hybrid}")
    print(f"phases: build {t1 - t0:.1f} s, kernels {t2 - t1:.1f} s, "
          f"paged serve {t3 - t2:.1f} s, slotted serve {t4 - t3:.1f} s, "
          f"clover {t5 - t4:.1f} s, parity {t6 - t5:.1f} s, ssm "
          f"{t7 - t6:.1f} s, hybrid {t8 - t7:.1f} s, preempted serve "
          f"{t9 - t8:.1f} s, ssm parity {t10 - t9:.1f} s, total "
          f"{t10 - t0:.1f} s")
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
