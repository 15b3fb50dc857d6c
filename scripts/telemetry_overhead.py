#!/usr/bin/env python3
"""Host cost of the telemetry plane on ``chip_smoke.py``'s phase-9 serve.

    PYTHONPATH=src:. python3 scripts/telemetry_overhead.py [--turns N]

Needs one GPU.  Builds phase 9's engine once (``chip_smoke._preempt_engine``:
qwen3-1.7b at full width on the ladder x0.5 / x1, preemption on 78-block
arenas, a static quality selector) and serves phase 9's 16 requests in
turns without and with a ``Telemetry`` bundle (trace and carbon feed),
``plain tel tel plain`` repeated ``--turns`` times over, reconfiguring
before each serve so every turn runs the same schedule.  Each serve's
scheduler steps are timed on the host clock (``chip_smoke._timed_serve``);
the steps of a plain and a telemetry serve side by side in the order pair
up one to one.  A last telemetry serve runs under ``cProfile``, which
attributes host time to the instrumentation itself: the trace recorder's
methods, the engine's per-tick trace (``_trace_tick``) and the phase
profiler's ``observe`` (cProfile slows every call, so that share is an
upper bound).  It prints one line per serve and a last JSON line with the
median wall and step time of each kind, the median of the paired per-step
ratios (telemetry over plain), and the profiled share.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    import torch
    if not torch.cuda.is_available():
        print("telemetry_overhead: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.obs import CarbonFeed, Telemetry, TraceRecorder
    eng, graph, _ = CS._preempt_engine()
    prompts = CS._serve_prompts(eng.instances[0].ev.cfg.vocab_size)
    order = ["plain", "tel", "tel", "plain"] * args.turns
    runs = []
    for kind in order:
        eng.telemetry = (Telemetry(tracer=TraceRecorder("real-paged"),
                                   feed=CarbonFeed(300.0, interval_s=1e9))
                         if kind == "tel" else None)
        eng.configure(graph)
        torch.cuda.synchronize()
        _, steps = CS._timed_serve(eng, CS._mixed_quality_requests(prompts,
                                                                    48))
        m = eng.stats()
        runs.append((kind, m["wall_s"], steps))
        print(f"{kind}: wall {m['wall_s']:.3f} s, {len(steps)} steps, "
              f"median step {statistics.median(steps) * 1e3:.2f} ms, "
              f"preemptions {m['preemptions']}", flush=True)
    ratios = []
    for (ka, _, sa), (kb, _, sb) in zip(runs[::2], runs[1::2]):
        tel, plain = (sa, sb) if ka == "tel" else (sb, sa)
        ratios += [a / b for a, b in zip(tel, plain)]
    prof = cProfile.Profile()
    eng.telemetry = Telemetry(tracer=TraceRecorder("real-paged"),
                              feed=CarbonFeed(300.0, interval_s=1e9))
    eng.configure(graph)
    torch.cuda.synchronize()
    prof.enable()
    _, steps = CS._timed_serve(eng, CS._mixed_quality_requests(prompts, 48))
    prof.disable()
    own_s = 0.0
    for (path, _, func), (_, _, tt, ct, _) in pstats.Stats(prof).stats.items():
        if path.endswith(os.path.join("obs", "trace.py")) or \
                func == "_trace_tick":
            own_s += tt
        elif path.endswith(os.path.join("obs", "profile.py")) and \
                func == "observe":
            own_s += ct
    summary = {kind: {"wall_s": statistics.median(w for k, w, _ in runs
                                                  if k == kind),
                      "step_ms": statistics.median(
                          s * 1e3 for k, _, st in runs if k == kind
                          for s in st)}
               for kind in ("plain", "tel")}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "serves": len(runs), **summary,
                      "paired_step_ratio_median": statistics.median(ratios),
                      "profiled_own_s": own_s,
                      "profiled_serve_s": sum(steps),
                      "profiled_share": own_s / sum(steps),
                      "wall_ratio": summary["tel"]["wall_s"]
                      / summary["plain"]["wall_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
