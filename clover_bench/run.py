"""Run one cell of the benchmark once, on the card of this machine.

    python3 clover_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, last on
standard output; the numbers that decide ``correct`` go last on standard
error, each beside its limit.  Exits with a code other than 0, and prints
no result, when no card (or too few) is present, when the program cannot
be loaded, or when JAX or the JAX package is found loaded.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every cache the program or its libraries may write stays in the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
# one host thread for the CPU side of torch: the loop is the host's work
os.environ["OMP_NUM_THREADS"] = "1"

from clover_bench.guard import forbidden_loaded  # noqa: E402


def _fail(code: int, msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    bad = forbidden_loaded()
    if bad:
        _fail(3, f"forbidden modules loaded at start: {bad}")
    import torch
    from clover_bench import harness
    from clover_bench.energy import EnergyMeter
    torch.set_num_threads(1)

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in manifest["workloads"]}.get(a.workload)
    if wl is None:
        _fail(2, f"no workload {a.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available():
        _fail(2, "no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < int(wl["chips"]):
        _fail(2, f"{wl['chips']} card(s) needed, "
                 f"{torch.cuda.device_count()} present")
    import repro_torch  # noqa: F401  (the program; fails here if absent)
    cell = harness.Cell.load(manifest, a.workload)
    device = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(device)
    meter = EnergyMeter(uuid=f"GPU-{props.uuid}" if hasattr(props, "uuid")
                        else None)
    try:
        res = harness.run(cell, a.seed, a.seconds, bool(a.trace), device,
                          T_PROC0, energy=meter)
    finally:
        meter.close()
    bad = forbidden_loaded()
    if bad:
        _fail(3, f"forbidden modules loaded after the window: {bad}")
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": int(wl["chips"]),
                   "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device_info}
    tr = res.get("trace")
    if a.trace and tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["info"] = {"window_s": res["window_s"],
                   "window_tokens": res["window_tokens"],
                   "card_joules": res["joules"],
                   "energy_source": meter.source,
                   "power_limit_w": meter.power_limit_w,
                   "modelled_joules_finished": res["modelled_j"],
                   "modelled_j_per_token": res["modelled_j_per_token"],
                   "counters": res["counters"],
                   "sample": [res["sample_requests"], res["sample_tokens"]],
                   "host": res["host"],
                   "ttft_ms": res["ttft_ms"],
                   "slice_tokens_per_s": (tr["slice_tokens_per_s"]
                                          if tr else None),
                   "trace_reduce_s": tr["reduce_s"] if tr else None}
    out["checked"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in res["numbers"]}
    for n, v, lim in res["numbers"]:
        print(f"checked {n} = {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
