"""The readings that set the limits of ``correct``, on the card: for each
seed, one run of a cell (short window, the cell's own load and sizes)
whose sample is compared twice, as served by the program and as the
control would serve it, the reference computed with fp8 products
(``reference/<family>.py``'s ``quant="fp8"``).  The program's widest gap
over the seeds is the lower reading of the limit; the control's smallest
is the upper.  Each control is judged as a run is (``harness.judge``,
its gap in the program's place against the cell's limit), and has to
read as not correct.  One process, one seed after another:

    python3 clover_bench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

Prints one JSON line per seed and a summary line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args()
    import torch
    from clover_bench import harness
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell.load(manifest, a.workload)
    device = torch.device("cuda", 0)
    prog, ctrl, ctrl_ok = [], [], []
    for seed in a.seeds:
        t0 = time.perf_counter()
        res = harness.run(cell, seed, a.seconds, False, device, t0,
                          control="fp8")
        (name, gap, limit), rest = res["numbers"][0], res["numbers"][1:]
        ctrl_numbers = [(name, res["control_gap_max"], limit)] + rest
        prog.append(gap)
        ctrl.append(res["control_gap_max"])
        ctrl_ok.append(harness.judge(ctrl_numbers))
        print(json.dumps({"seed": seed, "gap_max": gap,
                          "correct": res["correct"],
                          "control_gap_max": res["control_gap_max"],
                          "control_correct": ctrl_ok[-1],
                          "numbers": res["numbers"]}), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    print(json.dumps({"workload": a.workload, "program_max": max(prog),
                      "control_min": min(ctrl),
                      "every_control_not_correct": not any(ctrl_ok),
                      "program": prog,
                      "control": ctrl}), flush=True)


if __name__ == "__main__":
    main()
