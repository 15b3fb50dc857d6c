#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result lines:

1. device and build — the card's name and power limit (``nvidia-smi``) and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels against their plain PyTorch versions on the card, at the shapes
   of the serving paths (8 KV heads, g = 2, dh = 128): paged decode at
   batch 1 and 8 with lengths up to 2048 and chunked prefill of 32 tokens
   at n_past 0, 224 and 992 (block 16, f32 arena); contiguous decode at
   batch 1 and 8 over a 2048-position cache; contiguous causal prefill at
   128 and 1024 tokens, and one with a sliding window; bf16 cases of each.
   Each case prints its time, the plain version's, one
   ``scaled_dot_product_attention`` call as a yardstick, and the least
   time the card could take;
3. the paged engine serving 8 requests at the full width of qwen3-1.7b
   (28 layers, bf16 random weights from a seed), with both paged kernels
   counted;
4. the slotted engine (the default layout) serving the same 8 requests at
   full width with f32 weights (the layout serves f32 models only), with
   both contiguous kernels counted;
5. Clover's real-mode control loop (``repro_torch.launch.serve --mode
   real``) on the card: annealing over configuration graphs of the SMOKE
   ladder on measured latencies;
6. the paged and the slotted engines at SMOKE size on the card against the
   same engines on the CPU (plain versions), and slotted against paged on
   the card: the greedy token streams must be equal;
7. the ``kernels`` line: every ported kernel with its launches on the main
   path that runs it (phase 3 for the paged kernels, phase 4 for the
   contiguous ones).

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
# rate of each input type — f32 on the CUDA cores, bf16 on the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
# (atol, rtol) of a kernel against its plain version: f32 differs in the
# order of its sums; both accumulate bf16 inputs in f32, so a bf16 output
# differs by about one bf16 rounding of the output (relative 2**-8)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-3, 1e-2)}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[dtype]
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
                 bs: int = 16, K: int = 8, g: int = 2, dh: int = 128):
    """Random paged-decode inputs: every row's pages are distinct arena
    blocks, one row runs to ``max_len``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    n_pages = max_len // bs
    lengths = rng.integers(1, max_len + 1, size=b)
    lengths[0] = max_len
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
            torch.as_tensor(lengths.astype(np.int32), device=dev))


def _prefill_case(n_past: int, dtype, seed: int, C: int = 32, bs: int = 16,
                  K: int = 8, g: int = 2, dh: int = 128, nb: int = 257):
    """Random chunked-prefill inputs: a chunk of C queries at n_past.., the
    table sliced to the power-of-two page bucket the engine uses."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    need = -(-(n_past + C) // bs)
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


def _sdpa_prefill(q, ka, va, table, pos):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import gather_paged_kv
    kc, vc = gather_paged_kv(ka, va, table[None])
    kq = kc.transpose(1, 2).contiguous()              # (1, K, S, dh)
    vq = vc.transpose(1, 2).contiguous()
    qq = q.transpose(0, 1)[None]                       # (1, H, C, dh)
    S = kc.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos.long()[:, None])[None, None]
    return lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask,
                                                  enable_gqa=True)


def _contig_decode_case(b: int, dtype, seed: int, S: int = 2048, K: int = 8,
                        g: int = 2, dh: int = 128):
    """Random slotted-decode inputs: one layer's (b, S, K, dh) caches with
    per-row lengths drawn up to S, one row at S."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    lengths = rng.integers(1, S + 1, size=b)
    lengths[0] = S
    dev = "cuda"
    q = torch.randn(b, K * g, dh, device=dev).to(dtype)
    kc = torch.randn(b, S, K, dh, device=dev).to(dtype)
    vc = torch.randn(b, S, K, dh, device=dev).to(dtype)
    return q, kc, vc, torch.as_tensor(lengths.astype(np.int32), device=dev)


def _flash_case(sq: int, dtype, seed: int, K: int = 8, g: int = 2,
                dh: int = 128):
    """Random contiguous-prefill inputs: one prompt of sq tokens."""
    import torch
    torch.manual_seed(seed)
    dev = "cuda"
    q = torch.randn(1, sq, K * g, dh, device=dev).to(dtype)
    k = torch.randn(1, sq, K, dh, device=dev).to(dtype)
    v = torch.randn(1, sq, K, dh, device=dev).to(dtype)
    return q, k, v


def _sdpa_contig_decode(q, kc, vc, lengths):
    import torch
    import torch.nn.functional as F
    kq = kc.transpose(1, 2).contiguous()              # (b, K, S, dh)
    vq = vc.transpose(1, 2).contiguous()
    qq = q[:, :, None, :]                              # (b, H, 1, dh)
    mask = (torch.arange(kc.shape[1], device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
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


def phase_kernels() -> dict:
    """Hold every kernel against its plain version; returns per-kernel
    records measured at the headline shape of its main path (paged decode
    b=8, paged prefill n_past=992, contiguous decode b=8, contiguous
    prefill 1024 tokens; f32)."""
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
             + [("flash", (1024, 256), f32), ("flash", (1024, 0), bf16)])
    headlines = {("decode", 8), ("prefill", 992), ("contig_decode", 8),
                 ("flash", (1024, 0))}
    for i, (kind, arg, dtype) in enumerate(cases):
        dname = str(dtype).replace("torch.", "")
        elt = torch.tensor([], dtype=dtype).element_size()
        if kind == "decode":
            args = _decode_case(arg, dtype, seed=i)
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
        elif kind == "contig_decode":
            args = _contig_decode_case(arg, dtype, seed=i)
            kern = lambda a=args: DA.decode_attention(*a)
            plain = lambda a=args: REF.decode_attention_ref(*a)
            lib = _sdpa_contig_decode(*args)
            q, kc, vc, lengths = args
            H, dh, K = q.shape[1], q.shape[2], kc.shape[2]
            ln = lengths.long().cpu().clamp(max=kc.shape[1])
            n_bytes = (2 * q.numel() * elt + 2 * int(ln.sum()) * K * dh * elt
                       + 4 * len(ln))
            n_ops = 4 * int(ln.sum()) * H * dh
            name, label = "decode_attention", f"b={arg}"
        elif kind == "flash":
            sq, window = arg
            args = _flash_case(sq, dtype, seed=i)
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
            n_ops = 4 * dh * H * int(visible.sum())
            name, label = "flash_attention", f"sq={sq} window={window}"
        else:
            args = _prefill_case(arg, dtype, seed=i)
            kern = lambda a=args: FA.paged_prefill_attention(*a)
            plain = lambda a=args: REF.paged_prefill_attention_ref(*a)
            lib = _sdpa_prefill(*args)
            q, ka, va, table, pos = args
            C, H, dh = q.shape
            K = ka.shape[2]
            visible = int(pos.max()) + 1
            pages = -(-visible // ka.shape[1])
            n_bytes = (2 * q.numel() * elt + 2 * visible * K * dh * elt
                       + 4 * (pages + C))
            n_ops = 4 * H * dh * int((pos.long() + 1).sum())
            name, label = "paged_prefill_attention", f"n_past={arg}"
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
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, dname)
        print(f"kernel {name} {label} {dname}: max_abs_err {err:.3g} "
              f"(atol {atol} rtol {rtol}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"sdpa_ms {lib_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
        if dname == "float32" and (kind, arg) in headlines:
            records[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms}
    return records


def _device_profile(fn, steps: int, t_wall: float, is_attention) -> str:
    """Device time per step of ``fn`` (which runs ``steps`` decode steps)
    from torch.profiler: the sum over device events (kernels, copies,
    fills), each counted once — the CPU op that launched a kernel carries
    its time too, so CPU events are left out — with the attention kernel's
    share, the number of device events, the idle share against the wall
    time ``t_wall`` of ``fn``, and the five largest events by name."""
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
    attn_us = sum(e.self_device_time_total for e in dev if is_attention(e.key))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    top_s = "; ".join(f"{e.key[:48]} {e.self_device_time_total / steps / 1e3:.3f}"
                      f" ms in {e.count / steps:g}" for e in top)
    return (f"device busy {busy_us / steps / 1e3:.3f} ms in "
            f"{sum(e.count for e in dev) / steps:g} device events (attention "
            f"kernel {attn_us / steps / 1e3:.3f} ms), device idle share "
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
    device = _device_profile(dispatch, 8, t_wall,
                             lambda key: "paged_decode_kernel" in key)
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
    device = _device_profile(
        step, 1, t_wall,
        lambda key: "decode_kernel" in key and "paged" not in key)
    ctx = int(inst.cache["lengths"].max())
    print(f"slotted decode step (8 slots, up to {ctx} positions): wall "
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


def phase_parity() -> None:
    """SMOKE-size engines on the card (kernels) and on the CPU (plain
    versions), same weights, same prompts: the paged engine on the card
    against the paged engine on the CPU, the slotted engine on the card
    against the slotted engine on the CPU and against the paged engine on
    the card — the greedy streams must be equal."""
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
    for layout in ("paged", "slotted"):
        for fam, dev in ((fam_gpu, None), (fam_cpu, "cpu")):
            eng = ENG.RealEngine(fam, n_slots=2, max_len=64,
                                 kv_layout=layout, block_size=8, max_seqs=6,
                                 device=dev)
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
    print(f"parity: on {len(prompts)} requests x {n_new} tokens the SMOKE "
          f"paged engine on the card equals the CPU's ({ties} near-tie "
          f"divergences; prefix hits "
          f"{stats['paged', 'cuda']['prefix_hit_tokens']}), the slotted "
          f"engine on the card equals the CPU's ({ties_s}) and the paged "
          f"engine on the card ({ties_sp})")


# =============================================================================
# main
# =============================================================================
KERNELS = (
    ("paged_decode_attention",
     "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:90"),
    ("paged_prefill_attention",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:80"),
    ("decode_attention",
     "src/repro_torch/kernels/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention.py:65"),
    ("flash_attention",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:80"),
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
    t2 = time.perf_counter()
    launches = phase_serve()
    t3 = time.perf_counter()
    launches.update(phase_slotted_serve())
    t4 = time.perf_counter()
    phase_clover()
    t5 = time.perf_counter()
    phase_parity()
    t6 = time.perf_counter()
    print(f"phases: build {t1 - t0:.1f} s, kernels {t2 - t1:.1f} s, "
          f"paged serve {t3 - t2:.1f} s, slotted serve {t4 - t3:.1f} s, "
          f"clover {t5 - t4:.1f} s, parity {t6 - t5:.1f} s, total "
          f"{t6 - t0:.1f} s")
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
