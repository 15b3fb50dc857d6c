#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its result lines:

1. device and build — the card's name and power limit (``nvidia-smi``) and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels against their plain PyTorch versions on the card, at the shapes
   of the serving path (block 16, 8 KV heads, g = 2, dh = 128, f32 arena;
   decode at batch 1 and 8 with lengths up to 2048, chunked prefill of 32
   tokens at n_past 0, 224 and 992, and bf16 cases), with each kernel's
   time, the plain version's, ``scaled_dot_product_attention`` on the
   gathered K/V as a yardstick, and the least time the card could take;
3. the paged engine serving 8 requests at the full width of qwen3-1.7b
   (28 layers, random weights from a seed), with both kernels counted;
4. the paged engine at SMOKE size on the card against the same engine on
   the CPU (plain versions): the greedy token streams must be equal;
5. the ``kernels`` line: every ported kernel with its launches on the main
   path of phase 3.

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
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # sum order / bf16 rounding


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
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import gather_paged_kv
    kc, vc = gather_paged_kv(ka, va, tables)
    kq = kc.transpose(1, 2).contiguous()              # (b, K, S, dh)
    vq = vc.transpose(1, 2).contiguous()
    qq = q[:, :, None, :]                              # (b, H, 1, dh)
    S = kc.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kq, vq, attn_mask=mask,
                                                  enable_gqa=True)


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


def phase_kernels() -> dict:
    """Hold both kernels against their plain versions; returns per-kernel
    records measured at the headline shape (decode b=8, prefill
    n_past=992, f32)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref as REF
    records = {}
    cases = ([("decode", b, torch.float32) for b in (1, 8)]
             + [("prefill", n, torch.float32) for n in (0, 224, 992)]
             + [("decode", 8, torch.bfloat16), ("prefill", 992,
                                                torch.bfloat16)])
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
        tol = TOL[dname]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        _check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite")
        _check(ok, f"{name} {label} {dname}: max |err| {err:.3g} > {tol}")
        ms, plain_ms, lib_ms = _time_ms(kern), _time_ms(plain), _time_ms(lib)
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, dname)
        print(f"kernel {name} {label} {dname}: max_abs_err {err:.3g} "
              f"(tol {tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"sdpa_ms {lib_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
        headline = (dname == "float32"
                    and (kind, arg) in (("decode", 8), ("prefill", 992)))
        if headline:
            records[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms}
    return records


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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dispatch()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in ev)
    attn_us = sum(e.self_device_time_total for e in ev
                  if "paged_decode_kernel" in e.key)
    device = (f"device busy {busy_us / 8 / 1e3:.3f} ms (attention kernel "
              f"{attn_us / 8 / 1e3:.3f} ms), device idle share "
              f"{1 - busy_us / 1e6 / t_wall:.3f}" if busy_us > 0 else
              "device busy not measured (the profiler saw no device time)")
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
# phase 4: the engine on the card against the engine on the CPU
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


def phase_parity() -> None:
    """SMOKE-size paged engine on the card (kernels) and on the CPU (plain
    versions), same weights, same prompts: the greedy streams must be
    equal.  A differing token is a fault unless the CPU logits at that step
    are a near-tie (top-2 gap within the f32 tolerance)."""
    import torch
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
    outs, stats = [], []
    for fam, dev in ((fam_gpu, None), (fam_cpu, "cpu")):
        eng = ENG.RealEngine(fam, n_slots=2, max_len=64, kv_layout="paged",
                             block_size=8, max_seqs=6, device=dev)
        eng.configure(ConfigGraph.from_dict(cfg.name, {("x1", 1): 1}))
        stats.append(serve_prompts(eng, prompts, n_new=n_new))
        outs.append(dict(eng.last_outputs))
    gpu, cpu = outs
    _check(set(gpu) == set(cpu) == set(range(len(prompts))),
           "parity: request sets differ")
    ties = 0
    for rid in sorted(cpu):
        if (gpu[rid] == cpu[rid]).all():
            continue
        step = int((gpu[rid] != cpu[rid]).argmax())
        lg_c = _greedy_logits(fam_cpu[0].params, prompts[rid],
                              step + 1)[step]
        top = torch.topk(lg_c, 2).values
        gap = float(top[0] - top[1])
        _check(gap <= 1e-4 * max(1.0, float(top[0].abs())),
               f"parity: rid {rid} differs at step {step} with a top-2 "
               f"logit gap of {gap:.3g} — not a near-tie")
        ties += 1
    for key in ("prefix_hit_tokens", "prefill_chunks", "decode_steps"):
        _check(stats[0][key] == stats[1][key] or ties,
               f"parity: {key} {stats[0][key]} vs {stats[1][key]}")
    print(f"parity: SMOKE engine on the card equals the CPU engine on "
          f"{len(prompts)} requests x {n_new} tokens "
          f"({ties} near-tie divergences); prefix hits "
          f"{stats[0]['prefix_hit_tokens']}")


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
    phase_parity()
    t4 = time.perf_counter()
    print(f"phases: build {t1 - t0:.1f} s, kernels {t2 - t1:.1f} s, "
          f"serve {t3 - t2:.1f} s, parity {t4 - t3:.1f} s")
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
