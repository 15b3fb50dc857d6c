"""The knee of an open-loop cell, found once by a sweep on the card: the
cell's deployment set up once, then its traffic at each rate in turn for
a window, each followed by a drain.  For each rate: requests due and
finished, the backlog when the window closed, and the tails of TTFT and
TPOT.  The knee is the highest rate whose backlog stays flat and whose
TTFT tail stays near the lower rates'.

    python3 clover_bench/sweep.py --workload <name> --seconds <s> \\
        --seed <n> --rates <r> [<r> ...]
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args()
    import torch
    from clover_bench import generate, harness, readers
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell.load(manifest, a.workload)
    device = torch.device("cuda", 0)
    eng, rungs, model = harness.build(cell, a.seed, device)
    if cell.mix.get("warm", {}).get("prefix_fill"):
        harness._fill_prefixes(eng, generate.Traffic(
            cell.mix, a.seed, model["vocab_size"]))
    print(json.dumps({"setup_s": time.perf_counter() - T0}), flush=True)
    for k, rate in enumerate(a.rates):
        mix = dict(cell.mix, rate_rps=rate)
        loop = harness.Loop(eng, generate.Traffic(mix, a.seed + k,
                                                  model["vocab_size"]),
                            rid0=(k + 1) << 32)
        loop.start()
        loop.run_until(time.perf_counter()
                       + float(mix.get("warm", {}).get("lead_in_s", 0.0)))
        t_w0 = time.perf_counter()
        loop.in_window = True
        loop.run_until(t_w0 + a.seconds)
        loop.in_window = False
        t_w1 = time.perf_counter()
        backlog = loop.outstanding
        due = [r for r in loop.recs.values() if t_w0 <= r.due < t_w1]
        loop.release = False
        loop.run_until(t_w1 + 120.0)
        ttft = [r.first - r.due for r in due if r.first is not None]
        tpot = [(r.last - r.first) / (r.n - 1) for r in due
                if r.first is not None and r.n > 1]
        print(json.dumps({
            "rate_rps": rate, "due": len(due),
            "finished": sum(1 for r in due if r.done is not None),
            "backlog_at_close": backlog,
            "ttft_p50_ms": 1e3 * readers.percentile(ttft, 50),
            "ttft_p95_ms": 1e3 * readers.percentile(ttft, 95),
            "tpot_p95_ms": 1e3 * readers.percentile(tpot, 95),
            "tokens_per_s": loop.window_tokens / (t_w1 - t_w0)}),
            flush=True)


if __name__ == "__main__":
    main()
