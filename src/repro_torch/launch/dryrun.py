"""Dry run of every (architecture x input-shape x mesh) cell on the
reference's production meshes, with no device — the port's counterpart of
the reference package's ``launch/dryrun.py``.

The reference lowers and compiles each cell with XLA on 512 host devices
and reads the compiled program's memory, FLOPs and collectives.  Here each
cell's step (``launch/steps.py``: the port's train step, forward or decode
step) runs once on meta tensors on an abstract mesh
(``launch/mesh.py``), and the cell reports:

  * per-device bytes of the parameters, the optimizer state (ZeRO-1), the
    cache and the inputs, from their specs (``sharding/rules.py``), a
    shard being ``ceil(dim / axis sizes)`` as GSPMD pads; temporaries are
    not counted;
  * the step's FLOPs (``torch.utils.flop_counter.FlopCounterMode``) over
    the mesh's devices, and their ratio to the reference's analytic
    ``model_flops_per_device`` (``launch/roofline.py``);
  * the collectives of one step: the step runs again as one
    representative rank of the mesh (``launch/mesh.py``
    ``representative_rank``: coordinates (0, ..., 0), its shard of the
    meta model, its rows, its cache), and its collectives
    (``sharding/collectives.py``) are counted, not run — the calls and the
    wire bytes by kind, by the reference's formulas (all-gather ``out x
    (g-1)/g``, all-reduce ``2 x in x (g-1)/g``, reduce-scatter ``in x
    (g-1)/g``, g the axis group's size), under the reference's keys
    ``collective_wire_bytes``, ``collective_counts`` and
    ``total_collective_bytes``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k --single-pod-only
  PYTHONPATH=src python -m repro_torch.launch.roofline --in dryrun_results.json

A cell that cannot run on meta tensors is a failure: it is printed and
the exit code is 1, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

from repro_torch.configs import ARCHS, get_config, get_optimized_config
from repro_torch.configs import shapes as SH
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline
from repro_torch.launch import steps
from repro_torch.sharding import collectives as CL
from repro_torch.sharding import rules

# the reference's names of the kinds (HLO's)
_KIND_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter"}


def _step_bytes(kind: str, cfg, mesh, args: tuple, specs: dict,
                out) -> Dict[str, int]:
    """Per-device bytes of the cell's arguments and outputs, by kind."""
    if kind == "train":
        state, batch = args
        model = state["params"]
        param = rules.param_device_bytes(model, specs["params"], mesh)
        # m and v in f32, and the step counter
        opt = 2 * rules.param_device_bytes(model, specs["opt"]["m"], mesh,
                                           elt=4) + 4
        return {"param_bytes": param, "opt_bytes": opt, "cache_bytes": 0,
                "input_bytes": steps.device_bytes(batch, specs["batch"],
                                                  mesh),
                # the state is updated in place: nothing new comes out
                "output_bytes": 0, "alias_bytes": 0}
    model, *rest = args
    param = rules.param_device_bytes(model, specs["params"], mesh)
    if kind == "prefill":
        batch, = rest
        return {"param_bytes": param, "opt_bytes": 0, "cache_bytes": 0,
                "input_bytes": steps.device_bytes(batch, specs["batch"],
                                                  mesh),
                "output_bytes": rules.shard_bytes(
                    out.shape, specs["logits"], mesh, out.element_size()),
                "alias_bytes": 0}
    cache, batch = rest
    cache_b = steps.device_bytes(cache, specs["cache"], mesh)
    logits = out[0]
    return {"param_bytes": param, "opt_bytes": 0, "cache_bytes": cache_b,
            "input_bytes": steps.device_bytes(batch, specs["batch"], mesh),
            # the cache is advanced in place: it comes out aliased
            "output_bytes": cache_b + rules.shard_bytes(
                logits.shape, specs["logits"], mesh, logits.element_size()),
            "alias_bytes": cache_b}


def count_collectives(cfg, mesh, shape: str, **kw) -> Dict:
    """One step of the cell as the representative rank of ``mesh``: its
    collectives' calls and wire bytes by kind, and their total."""
    rank = MESH.representative_rank(mesh)
    step, args, _ = steps.build_step_for_cell(cfg, rank, shape, **kw)
    CL.reset()
    step(*args)
    st = CL.stats()
    CL.reset()
    wire = {_KIND_NAMES[k]: float(st[k]["wire_bytes"]) for k in _KIND_NAMES}
    return {"collective_wire_bytes": wire,
            "collective_counts": {_KIND_NAMES[k]: int(st[k]["calls"])
                                  for k in _KIND_NAMES},
            "total_collective_bytes": float(sum(wire.values()))}


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             seq_shard: Optional[bool] = None, verbose: bool = True,
             optimized: bool = False) -> Dict:
    cfg = get_optimized_config(arch) if optimized else get_config(arch)
    if not SH.cell_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "full-attention arch skips long_500k"}
    mesh = MESH.make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    kind = SH.SHAPES[shape].kind
    t0 = time.time()
    kw = {}
    if kind == "decode" and seq_shard is not None:
        kw["seq_shard"] = seq_shard
    step, args, specs = steps.build_step_for_cell(cfg, mesh, shape, **kw)
    t_build = time.time() - t0
    out, flops = steps.count_flops(step, args)
    flops /= n_dev
    coll = count_collectives(cfg, mesh, shape, **kw)
    t_count = time.time() - t0 - t_build
    mem = _step_bytes(kind, cfg, mesh, args, specs, out)
    args_b = (mem["param_bytes"] + mem["opt_bytes"] + mem["cache_bytes"]
              + mem["input_bytes"])
    mf = roofline.model_flops_per_device(arch, shape, n_dev)
    res = {
        "arch": arch,
        "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        # building the abstract step, and running it on meta tensors
        "lower_s": round(t_build, 1),
        "compile_s": round(t_count, 1),
        "dot_flops_per_device": flops,
        "collectives": coll,
        # no XLA program: no raw cost analysis
        "xla_flops_per_device_raw": None,
        "xla_bytes_accessed_raw": None,
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / max(flops, 1.0),
        "memory": {
            **mem,
            "argument_bytes": args_b,
            "temp_bytes": None,
            "peak_per_device_bytes": args_b + mem["output_bytes"]
                                     - mem["alias_bytes"],
        },
    }
    if kind == "train":
        res["accum"] = specs["accum"]
    if verbose:
        gib = res["memory"]["peak_per_device_bytes"] / 2**30
        print(f"[dryrun] {arch:24s} {shape:12s} {res['mesh']:8s} "
              f"flops/dev={flops:.3e} model/counted={res['useful_flops_ratio']:.3f} "
              f"mem/dev={gib:6.2f}GiB (params "
              f"{mem['param_bytes'] / 2**30:.2f}, opt "
              f"{mem['opt_bytes'] / 2**30:.2f}, cache "
              f"{mem['cache_bytes'] / 2**30:.2f}, inputs "
              f"{mem['input_bytes'] / 2**30:.4f}; temporaries not counted) "
              f"coll={coll['total_collective_bytes'] / 2**30:.3f}GiB "
              f"(build {t_build:.1f}s count {t_count:.1f}s)",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES) + [None])
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--seq-shard", default=None, choices=[None, "on", "off"],
                    help="override KV sequence sharding for decode cells")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the optimized per-arch overrides")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shape_names = [args.shape] if args.shape else list(SH.SHAPES)
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]
    seq_shard = None if args.seq_shard is None else (args.seq_shard == "on")

    results, failures = [], []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shape_names:
                try:
                    results.append(run_cell(arch, shape, multi_pod,
                                            seq_shard=seq_shard,
                                            optimized=args.optimized))
                except Exception as e:  # a failure here is a fault of the port
                    failures.append((arch, shape, multi_pod, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape} multi_pod="
                          f"{multi_pod}: {e!r}", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_run = sum(1 for r in results if not r.get("skipped"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    print(f"[dryrun] wrote {args.out}: {n_run} counted, {n_skip} skipped, "
          f"{len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
