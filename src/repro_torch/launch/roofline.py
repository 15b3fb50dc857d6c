"""Roofline of the dry run's cells on the NVIDIA H100 — the port's
counterpart of the reference package's ``launch/roofline.py``.

Two terms, at the card's published peaks (NVIDIA H100 80GB HBM3 (SXM),
700 W; NVIDIA's data sheet, dense):

  compute = FLOPs a device / 989 TFLOP/s    (bf16 tensor cores)
  memory  = bytes a device / 3.35 TB/s      (HBM3)

and a third, collective = wire bytes a device / 450 GB/s (NVLink, one
direction), the wire bytes of one step's collectives as the dry run
counts them on a representative rank (``launch/dryrun.py``).

FLOPs a device are ``torch.utils.flop_counter``'s count of the step on
meta tensors (``launch/steps.py``) over the mesh's devices — an even
split, without the work a sharded program repeats on every shard.  The
memory term counts what the port can count: each argument's bytes on one
device from its spec (parameters, optimizer state, cache, inputs), read
``_TRAFFIC_COEF`` times a step (train: the forward, the recomputed forward
and the backward read the weights; prefill and decode once).  Temporaries
(activations, scores, the backward's buffers) are not counted, so the
term is a floor.

``model_flops_per_device`` is the reference's analytic count, unchanged:
6·N_active·tokens (train), the config's per-token FLOPs times tokens
(prefill), per-token decode FLOPs times the batch (decode); its ratio to
the counted FLOPs shows the work the step does beyond the math (remat,
the plain attention's full score matrices).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.configs import shapes as SH

CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s, one direction
HBM_BYTES = 80e9             # device memory

_TRAFFIC_COEF = {"train": 3.0, "prefill": 1.0, "decode": 1.0}


def model_flops_per_device(arch: str, shape: str, devices: int) -> float:
    cfg = get_config(arch)
    cell = SH.SHAPES[shape]
    n_act = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        total = 6.0 * n_act * tokens
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        total = cfg.flops_per_token(cell.seq_len) * tokens
    else:
        total = cfg.flops_per_token(cell.seq_len, decode=True) \
            * cell.global_batch
    return total / devices


def roofline_row(rec: Dict) -> Optional[Dict]:
    if rec.get("skipped"):
        return None
    kind = SH.SHAPES[rec["shape"]].kind
    mem = rec["memory"]
    traffic = _TRAFFIC_COEF[kind] * mem["argument_bytes"]
    t_compute = rec["dot_flops_per_device"] / PEAK_FLOPS
    t_memory = traffic / HBM_BW
    coll = rec.get("collectives")
    t_coll = (coll["total_collective_bytes"] / NVLINK_BW
              if coll is not None else None)
    terms = {"compute": t_compute, "memory": t_memory}
    if t_coll is not None:
        terms["collective"] = t_coll
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec["arch"], rec["shape"], rec["devices"])
    bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / max(rec["dot_flops_per_device"], 1.0),
        "step_time_bound_s": bound,
        "roofline_fraction": (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0,
        "mem_footprint_gib": mem["peak_per_device_bytes"] / 2**30,
        "fits_hbm": mem["peak_per_device_bytes"] <= HBM_BYTES,
    }


def analyze_file(path: str, mesh: str = "16x16") -> List[Dict]:
    with open(path) as f:
        records = json.load(f)
    rows = []
    for rec in records:
        if rec.get("skipped") or rec.get("mesh") != mesh:
            continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def to_markdown(rows: List[Dict]) -> str:
    def s(x):
        return "n/a" if x is None else f"{x:.3e}"
    hdr = (f"Bounds at the peaks of one {CARD}; temporaries not "
           f"counted.\n\n"
           "| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL/counted flops | roofline frac | mem GiB (args) | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {s(r['t_compute_s'])} "
            f"| {s(r['t_memory_s'])} | {s(r['t_collective_s'])} "
            f"| **{r['dominant']}** | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {r['mem_footprint_gib']:.1f} "
            f"| {'yes' if r['fits_hbm'] else 'no'} |\n")
    return "".join(out)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="dryrun_results.json")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = analyze_file(args.inp, args.mesh)
    print(to_markdown(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
