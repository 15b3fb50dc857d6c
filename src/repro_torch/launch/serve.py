"""Clover serving entry point on the port: the full carbon-aware serving loop.

Modes:
  --mode sim    48 h trace simulation for any (--family, --scheme) pair —
                the paper's evaluation rig (``serving/simulator.py``).  It
                touches no tensor (numpy and the standard library only), so
                it needs no device; it prints one JSON object, the scheme's
                savings against BASE on the same trace.
  --mode real   real execution of a reduced LM quality ladder (SMOKE widths,
                8 layers, f32) through the port's slotted serving engine:
                measured wall latencies and energies feed Clover's
                simulated annealing over configuration graphs.  Runs on the
                GPU unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode sim --hours 6
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys


def run_sim(args) -> int:
    from repro_torch.core import carbon as CB
    from repro_torch.serving import simulator as SIM
    tr = CB.make_trace(args.region, hours=args.hours)
    rep = SIM.run_trace(args.scheme, args.family, tr,
                        SIM.SimConfig(n_blocks=args.blocks, lam=args.lam))
    base = SIM.run_trace("BASE", args.family, tr,
                         SIM.SimConfig(n_blocks=args.blocks, lam=args.lam))
    out = {
        "scheme": args.scheme,
        "family": args.family,
        "region": args.region,
        "carbon_saving_pct": (1 - rep.carbon_per_req_g()
                              / base.carbon_per_req_g()) * 100,
        "accuracy_delta_pct": (rep.accuracy - base.accuracy)
                              / base.accuracy * 100,
        "p95_vs_sla": rep.p95_latency_s / rep.sla_target_s,
        "opt_time_pct": rep.opt_time_frac * 100,
        "invocations": rep.n_invocations,
    }
    print(json.dumps(out, indent=1))
    return 0


def run_real(args) -> int:
    import random

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import annealing as SA
    from repro_torch.core import carbon as CB
    from repro_torch.core import config_graph as CG
    from repro_torch.core import objective as OBJ
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.api import serve_prompts as serve

    device = resolve_device(args.device)
    base_cfg = get_smoke_config(args.arch).with_(n_layers=8,
                                                 dtype=torch.float32)
    fam = ENG.build_engine_family(base_cfg, fracs=(1.0, 0.5, 0.25),
                                  device=device)
    eng = ENG.RealEngine(fam, device=device)
    variants = [ev.variant for ev in fam]
    trace = CB.make_trace(args.region, hours=1.0)
    rng = random.Random(0)

    g = CG.ConfigGraph.from_dict(base_cfg.name,
                                 {(variants[-1].name, 8): 2})
    print(f"[serve] device {device}; initial config: {dict(g.edges)}")
    eng.configure(g)
    prompts = [np.array([[1, 5, 9, 2]], dtype=np.int32)
               for _ in range(args.requests)]
    m0 = serve(eng, prompts, 4)
    print(f"[serve] BASE-quality: p95={m0['p95_s']*1e3:.0f}ms "
          f"energy={m0['energy_j']:.1f}J acc={m0['mean_accuracy']:.2f}")

    # one Clover invocation against the measured latencies
    obj = OBJ.ObjectiveConfig(lam=args.lam, a_base=m0["mean_accuracy"],
                              c_base=m0["energy_j"] / m0["served"] / 3.6e6
                              * 380 * 1.5,
                              l_tail_s=m0["p95_s"] * 1.2)

    def evaluator(graph):
        eng.configure(graph)
        m = serve(eng, prompts[: max(4, args.requests // 4)], 4)
        return OBJ.EvalResult(m["mean_accuracy"], 1.0 / m["p50_s"], 0.5,
                              m["p95_s"], 0.0,
                              m["energy_j"] / m["served"])

    out = SA.anneal(g, variants, evaluator, ci=trace.at(0), obj_cfg=obj,
                    sa_cfg=SA.SAConfig(stale_limit=3, eval_window_s=0.0),
                    rng=rng)
    print(f"[serve] Clover chose {dict(out.best.edges)} after {out.n_evals} "
          f"real evaluations; f={out.best_f:.2f}")
    eng.configure(out.best)
    m1 = serve(eng, prompts, 4)
    print(f"[serve] CLOVER: p95={m1['p95_s']*1e3:.0f}ms "
          f"energy={m1['energy_j']:.1f}J acc={m1['mean_accuracy']:.2f} "
          f"(energy saving {100*(1-m1['energy_j']/m0['energy_j']):.0f}%)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("sim", "real"), default="sim")
    ap.add_argument("--family", default="efficientnet")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--scheme", default="CLOVER")
    ap.add_argument("--region", default="CISO-March")
    ap.add_argument("--hours", type=float, default=48.0)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    return run_sim(args) if args.mode == "sim" else run_real(args)


if __name__ == "__main__":
    sys.exit(main())
