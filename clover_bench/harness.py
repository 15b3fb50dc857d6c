"""One run of one cell: set up the port's paged engine from the cell's
files, drive it with the cell's traffic for the measured window, and
reduce what it did to the end-to-end or per-layer metrics, with the
check that decides ``correct``.

What the window drives is the port's serving entry:
``repro_torch.serving.engine.RealEngine`` with ``kv_layout="paged"``,
through ``submit`` and ``step``.  The loop here hands each request to
``submit`` when it is due, as a front end would (never ahead of time), and
calls ``step`` in between; latency is timed from the due time, so any lag
of the loop counts.

Files, found by the names in ``BENCHMARK.json``:
    configs/<config>.json     the model as run, its source and ladder
    traffic/<mix>.json        arrivals, lengths, sharing, classes, and the
                              engine deployment the mix is served on
    limits/<workload>.json    the limit of each number ``correct`` compares
    metrics/<metric>.py       a reader of one per-layer metric
    metrics/<base>.py         the reader of every metric <base>.<suffix>
                              that has no file of its own (one quantity
                              split by the end-to-end metric it moves)
    families/<family>.py      a family's weights, their names in the
                              port, a token's projection FLOPs
    reference/<family>.py     the plain reference of a family

A ``--trace 1`` run measures its window as a ``--trace 0`` run does, and
reads the per-layer metrics of counters and of the host's clock from it;
only then, under the same traffic, it profiles a slice of the card for
the metrics of the device trace, so that the profiler disturbs none of
the others.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import pathlib
import resource
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from clover_bench import check, generate, readers, weights as W
from clover_bench import yardstick as Y

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
TAIL_S = 150.0         # wait for requests due in the window past its close
                       # (an answer of 512 tokens at ~150 ms a token)
SLICE_S = 2.0          # seconds of the card profiled in a traced run,
                       # once the window's requests are done
HOST_SLICE_S = 0.5     # then seconds of the card and the host


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""
    name: str
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @staticmethod
    def load(manifest: Dict, name: str) -> "Cell":
        wl = {w["name"]: w for w in manifest["workloads"]}[name]
        cfg = {c["name"]: c for c in manifest["configs"]}[wl["config"]]

        def mine(metric):
            return name in metric.get("workloads", [name])
        return Cell(name, load_json(ROOT / cfg["file"]),
                    load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                    load_json(HERE / "limits" / f"{name}.json"),
                    [m for m in manifest["end_to_end"] if mine(m)],
                    [m for m in manifest["per_layer"] if mine(m)])


# =============================================================================
# set-up: weights, the port's engine
# =============================================================================
def build(cell: Cell, seed: int, device: torch.device):
    """(engine, rungs, model): the port's engine configured on the cell's
    graph, with weights made from ``seed``; ``rungs`` maps each rung to
    (weights, layers) for the reference."""
    from repro_torch.core.catalog import Variant
    from repro_torch.core.config_graph import ConfigGraph
    from repro_torch.models import registry as R
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import EngineVariant, RealEngine
    from repro_torch.serving.quality import StaticPinSelector

    model, dep = cell.config["model"], cell.mix["engine"]
    dtype = getattr(torch, cell.config["dtype"])
    # the config's model holds the port's ModelConfig fields by name
    base = ModelConfig(name=cell.config["name"], dtype=dtype, **model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ladder = cell.config["ladder"]            # rung -> fraction of depth
    order = sorted(ladder, key=lambda r: ladder[r])
    family, rungs = [], {}
    for q, rung in enumerate(order):
        if rung not in dep["graph"]:
            continue
        n_layers = max(int(model["n_layers"] * ladder[rung]), 1)
        cfg = base.with_(n_layers=n_layers, name=f"{base.name}-{rung}")
        w = W.make(model, n_layers, cfg.padded_vocab, gen, dtype, device)
        params = W.bind(R.init_params(cfg, device="meta"), w, n_layers,
                        model)
        n_params = sum(t.numel() for t in w.values())
        v = Variant(family=base.name, name=rung, quality=q + 1,
                    accuracy=0.80 + 0.05 * q, flops_g=n_params * 2 / 1e9,
                    params_m=n_params / 1e6,
                    mem_gb=n_params * 4 / 2**30 + 0.1)
        family.append(EngineVariant(v, cfg, params))
        rungs[rung] = (w, n_layers)
    pins = dep.get("pins")
    eng = RealEngine(family, kv_layout="paged", max_len=dep["max_len"],
                     block_size=dep["block_size"], n_blocks=dep["n_blocks"],
                     max_seqs=dep["max_seqs"],
                     chunk_blocks=dep["chunk_blocks"],
                     prefix_caching=dep["prefix_caching"],
                     fused_steps=dep["fused_steps"], policy="fifo",
                     quality_selector=(StaticPinSelector(pins)
                                       if pins is not None else None),
                     device=device)
    eng.configure(ConfigGraph.from_dict(
        base.name, {(r, 1): int(n) for r, n in dep["graph"].items()}))
    kv = kv_dtype(cell)
    for inst in eng.instances:
        if inst.arena["k"].dtype != kv:
            raise ValueError(f"the engine's arena holds "
                             f"{inst.arena['k'].dtype}, the config states "
                             f"kv_dtype {cell.config['kv_dtype']}")
    return eng, rungs, model


def kv_dtype(cell: Cell) -> torch.dtype:
    """The type of the K/V arena the config states (and :func:`build`
    holds the engine to)."""
    return getattr(torch, cell.config["kv_dtype"])


# =============================================================================
# the traffic loop
# =============================================================================
@dataclasses.dataclass
class Rec:
    """One request as the front end saw it (perf_counter seconds)."""
    rid: int
    due: float
    prompt: np.ndarray
    n_new: int
    slo: str
    hint: Optional[str]
    first: Optional[float] = None
    last: Optional[float] = None
    n: int = 0
    done: Optional[float] = None
    resp: object = None


class Loop:
    """Hands the traffic's requests to the engine when due and steps it."""

    def __init__(self, eng, traffic: generate.Traffic, rid0: int = 0):
        self.eng, self.traffic = eng, traffic
        self.rid0 = rid0                 # rids rid0 + i, unique per session
        self.recs: Dict[int, Rec] = {}
        self.next_i = 0
        self.outstanding = 0
        self.in_window = False
        self.window_tokens = 0
        self.tokens = 0                  # every token landed
        self.t_sched0: Optional[float] = None
        self.ranges = False              # record_function ranges (traced)
        self.release = True              # hand due requests to the engine
        self.step_s: List[float] = []    # each step's wall in the window

    def _range(self, name: str):
        if not self.ranges:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _on_token(self, rid: int, tok: int) -> None:
        r = self.recs[rid]
        t = time.perf_counter()
        if r.first is None:
            r.first = t
        r.last = t
        r.n += 1
        self.tokens += 1
        if self.in_window:
            self.window_tokens += 1

    def submit(self, due: float) -> None:
        from repro_torch.serving.api import InferenceRequest
        req = self.traffic.request(self.next_i)
        rec = Rec(self.rid0 + self.next_i, due, req.prompt,
                  req.max_new_tokens, req.slo, req.hint)
        self.recs[rec.rid] = rec
        s = self.eng._session
        # the engine's own arrival clock (its session's start) takes the
        # due time, so its queue delay and TTFT count from it too
        arrival = None if s is None else max(due - s.t0, 0.0)
        with self._range("bench.submit"):
            self.eng.submit(InferenceRequest(
                rid=rec.rid, prompt=req.prompt,
                max_new_tokens=req.max_new_tokens, slo=req.slo,
                quality_hint=req.hint, arrival_s=arrival,
                on_token=self._on_token))
        self.next_i += 1
        self.outstanding += 1

    def start(self) -> None:
        """Open the schedule: a closed loop submits every client's first
        request now; an open loop counts due times from now."""
        now = time.perf_counter()
        self.t_sched0 = now
        if self.traffic.closed:
            for _ in range(int(self.traffic.mix["clients"])):
                self.submit(now)

    def _release(self, now: float) -> None:
        if self.traffic.closed or not self.release:
            return
        while self.t_sched0 + self.traffic.due(self.next_i) <= now:
            self.submit(self.t_sched0 + self.traffic.due(self.next_i))

    def run_until(self, t_stop: float,
                  stop: Optional[Callable[[], bool]] = None) -> None:
        while True:
            now = time.perf_counter()
            if now >= t_stop or (stop is not None and stop()):
                return
            self._release(now)
            if self.outstanding == 0 and not self.release:
                return
            if self.outstanding == 0:
                nxt = self.t_sched0 + self.traffic.due(self.next_i)
                with self._range("bench.wait"):
                    time.sleep(max(0.0, min(nxt, t_stop) - now))
                continue
            with self._range("bench.step"):
                done = self.eng.step()
            t = time.perf_counter()
            if self.in_window:
                self.step_s.append(t - now)
            for resp in done:
                r = self.recs[resp.rid]
                r.done, r.resp = t, resp
                self.outstanding -= 1
                if self.traffic.closed and self.release:
                    self.submit(t)


# =============================================================================
# work counted at the model's entry points (traced runs)
# =============================================================================
class WorkLog:
    """Records, while ``in_slice`` (the profiled slice of a traced
    run), every paged prefill chunk and fused decode dispatch the
    engine makes: the rung's layers and the shapes and lengths each
    needs."""

    def __init__(self) -> None:
        self.in_slice = False
        # (layers, n_past, true_c, in_slice)
        self.prefill: List[tuple] = []
        # (layers, k, lengths, active, in_slice): the dispatch's device
        # tensors, read once the window has closed
        self.decode: List[tuple] = []
        self._undo: List[Callable] = []

    def install(self) -> None:
        from repro_torch.models import registry as R
        pf, dm = R.prefill_paged, R.decode_paged_multi

        def prefill_paged(params, batch, arena, table, n_past, true_c):
            if self.in_slice:
                self.prefill.append((params.cfg.n_layers, int(n_past),
                                     int(true_c), self.in_slice))
            return pf(params, batch, arena, table, n_past, true_c)

        def decode_paged_multi(params, arena, batch, tables, lengths,
                               active, n_steps):
            if self.in_slice:
                self.decode.append((params.cfg.n_layers, int(n_steps),
                                    lengths, active, self.in_slice))
            return dm(params, arena, batch, tables, lengths, active, n_steps)

        R.prefill_paged, R.decode_paged_multi = prefill_paged, \
            decode_paged_multi
        self._undo.append(lambda: (setattr(R, "prefill_paged", pf),
                                   setattr(R, "decode_paged_multi", dm)))

    def uninstall(self) -> None:
        for f in self._undo:
            f()
        self._undo = []

    def totals(self, model: Dict, kv_bytes: int, n_first: int,
               proj: Callable[[int], float]) -> Dict[str, float]:
        """Over the profiled slice: the model FLOPs of its prefill chunks
        and decode tokens (``n_first`` prompts ended in it, each adding
        its row of logits; ``proj(n_layers)`` is one token's projection
        FLOPs in a rung of that depth), and the decode and prefill
        kernels' bytes and bound."""
        flops = n_first * Y.head_flops(model)
        dec_bytes = pf_bound = 0.0
        for n_layers, n_past, true_c, sl in self.prefill:
            if not sl:
                continue
            flops += Y.prefill_flops(model, n_layers, n_past, true_c, False,
                                     proj(n_layers))
            pf_bound += n_layers * Y.paged_prefill_bound_s(
                model, n_past, true_c, kv_bytes)
        for n_layers, k, lengths, active, sl in self.decode:
            if not sl:
                continue
            ln = lengths.cpu().numpy().astype(np.float64)
            act = active.cpu().numpy().astype(bool)
            steps = np.arange(1, k + 1, dtype=np.float64)
            # each active row's k tokens, the s-th over its length + s keys
            keys = (ln[act, None] + steps).sum()
            flops += int(act.sum()) * k * Y.decode_flops(
                model, n_layers, 0.0, proj(n_layers)) \
                + Y.attn_flops(model, n_layers, keys)
            # every row of the bucket runs: active rows at their growing
            # lengths, the others at their kept length
            keys_all = keys + (ln[~act] + 1).sum() * k
            dec_bytes += n_layers * k * Y.paged_decode_bytes(
                model, keys_all / k, len(ln), kv_bytes)
        return {"flops": flops, "decode_bytes": dec_bytes,
                "prefill_bound_s": pf_bound}


# =============================================================================
# per-layer metric readers
# =============================================================================
def reader_path(name: str) -> pathlib.Path:
    """``metrics/<name>.py``, else the file of the name's base (the part
    before the first dot)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    return path


def load_reader(name: str) -> Callable:
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# =============================================================================
# one run
# =============================================================================
def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_proc0: float, energy=None,
        control: Optional[str] = None) -> Dict:
    """Set up, warm, measure for ``seconds``, check; returns the result
    (without the import check, which the caller makes).  ``trace`` then
    profiles a slice of the card under the same traffic, once the
    window's requests are done.  ``control`` (``control.py`` only) also
    reads the gap of the reference computed in that lower precision on
    the same sample."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng, rungs, model = build(cell, seed, device)
    traffic = generate.Traffic(cell.mix, seed, model["vocab_size"])
    loop = Loop(eng, traffic)
    warm = cell.mix.get("warm", {})
    # set-up the traffic needs: the shared prefixes' cache filled, then
    # the traffic itself until the system is at its steady state
    if warm.get("prefix_fill"):
        _fill_prefixes(eng, traffic)
    loop.start()
    if traffic.closed:
        # every client's first request under way: its first token landed
        loop.run_until(float("inf"), stop=lambda: all(
            r.first is not None for r in loop.recs.values()))
    loop.run_until(time.perf_counter() + float(warm.get("lead_in_s", 0.0)))
    if trace and device.type == "cuda":
        warm_profiler(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # what set-up made stays: the collector skips it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_proc0
    # ---- the measured window, alike with and without a trace ----------------
    c0, n_admit0 = _counters(eng), len(eng.last_admit_order)
    probe = HostProbe()
    probe.start()
    if energy is not None:
        energy.start()
    t_w0 = time.perf_counter()
    loop.in_window = True
    loop.run_until(t_w0 + seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_w1 = time.perf_counter()
    joules = energy.stop() if energy is not None else None
    host = probe.stop()
    c1 = _counters(eng)
    admitted = list(eng.last_admit_order[n_admit0:])
    loop.in_window = False
    window_s = t_w1 - t_w0
    loop._release(t_w1)              # every request due in the window
    due_in = [r for r in loop.recs.values() if t_w0 <= r.due < t_w1]
    if not traffic.closed:
        # wait for each request due in the window (load continues)
        loop.run_until(t_w1 + TAIL_S, stop=lambda: all(
            r.done is not None for r in due_in))
    elif not any(r.done is not None for r in loop.recs.values()):
        # a closed loop that finished nothing in the window: wait for one
        loop.run_until(t_w1 + TAIL_S, stop=lambda: any(
            r.done is not None for r in loop.recs.values()))
    # ---- a traced run: a slice of the card under the same traffic ---------
    trace_res = work = None
    if trace and device.type == "cuda":
        log = WorkLog()
        log.install()
        try:
            trace_res = _profile_slice(loop, log, device)
        finally:
            log.uninstall()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    if trace_res is not None:
        trace_res = reduce_slice(trace_res)
        s0, s1 = trace_res["t_slice"]
        fam = W.family(model["family"])
        kv_bytes = torch.empty((), dtype=kv_dtype(cell)).element_size()
        work = log.totals(model, kv_bytes, sum(
            1 for r in loop.recs.values()
            if r.first is not None and s0 <= r.first <= s1),
            lambda n: fam.proj_flops(model, n))
    due_ids = {r.rid for r in due_in}
    finished = [r for r in loop.recs.values() if r.done is not None
                and (r.done <= t_w1 or r.rid in due_ids)]
    if traffic.closed and not finished:
        finished = [r for r in loop.recs.values() if r.done is not None]
    counters = {k: c1[k] - c0[k] for k in c1}
    counters["prompt_tokens_admitted"] = sum(
        len(loop.recs[rid].prompt) for rid in admitted if rid in loop.recs)
    modelled_j = sum(r.resp.energy_j for r in finished)
    modelled_tokens = sum(len(r.resp.tokens) for r in finished)
    host.update(_step_stats(loop.step_s, window_s))
    # ---- free the program's state, then the reference -------------------
    samples = [{"rid": r.rid, "prompt": r.prompt,
                "tokens": list(r.resp.tokens), "variant": r.resp.variant,
                "n_new": r.n_new} for r in finished]
    expected_rung = {r.rid: _expected_rung(cell, r) for r in finished}
    del eng, loop.eng
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chk = cell.mix.get("check", {})
    sample = check.pick_sample(samples, seed, int(chk.get("tokens", 256)),
                               int(chk.get("requests", 4)))
    cmp = check.compare(sample, rungs, model, device, control=control)
    # ---- judge ---------------------------------------------------------
    failed = (0 if traffic.closed
              else sum(1 for r in due_in if r.done is None))
    wrong_len = sum(1 for s in samples if len(s["tokens"]) != s["n_new"])
    wrong_rung = sum(1 for s in samples
                     if s["variant"] != expected_rung[s["rid"]])
    # each number is held at or under its limit
    numbers = [("gap_max", cmp["gap_max"], float(cell.limits["gap_max"])),
               ("empty_sample", int(cmp["tokens"] == 0), 0),
               ("wrong_length", wrong_len, 0),
               ("wrong_rung", wrong_rung, 0),
               ("never_finished", failed, 0)]
    ctx = {"cell": cell, "loop_recs": loop.recs, "due_in": due_in,
           "t_w0": t_w0, "t_w1": t_w1, "window_s": window_s,
           "window_tokens": loop.window_tokens, "joules": joules,
           "setup_s": setup_s, "counters": counters, "work": work,
           "trace": trace_res, "model": model, "finished": finished}
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        v = (load_reader(m["name"])(ctx) if trace
             else _end_to_end(m["name"], ctx))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    res = {"correct": judge(numbers),
           "attempted": len(due_in) if not traffic.closed
           else len(finished),
           "failed": failed, "metrics": metrics,
           "memory_peak_bytes": int(memory_peak),
           "window_s": window_s, "modelled_j": modelled_j,
           "modelled_j_per_token": modelled_j / max(modelled_tokens, 1),
           "window_tokens": loop.window_tokens, "joules": joules,
           "control_gap_max": cmp.get("control_gap_max"),
           "counters": counters, "sample_requests": cmp["requests"],
           "sample_tokens": cmp["tokens"], "host": host,
           "ttft_ms": sorted(round(1e3 * (r.first - r.due), 1)
                             for r in due_in if r.first is not None),
           "numbers": numbers}
    if trace_res is not None:
        res["trace"] = trace_res
    return res


def judge(numbers) -> bool:
    """``correct``: every compared number at or under its limit."""
    return all(v <= lim for _, v, lim in numbers)


def _expected_rung(cell: Cell, r: Rec) -> str:
    """The rung the deployment's selector should serve ``r`` on: its hint
    when the ladder serves it, else its class's pin, else the best rung."""
    dep, ladder = cell.mix["engine"], cell.config["ladder"]
    served = [x for x in ladder if x in dep["graph"]]
    if r.hint in served:
        return r.hint
    pin = (dep.get("pins") or {}).get(r.slo)
    if pin in served:
        return pin
    return max(served, key=lambda x: ladder[x])


def _fill_prefixes(eng, traffic: generate.Traffic) -> None:
    """Set-up of a mix with shared prefixes: ``warm.prefix_fill`` prompts
    of prefixes alone, sent back to back with a one-token budget, so the
    prefix cache holds what the traffic shares before the window."""
    from repro_torch.serving.api import InferenceRequest
    prompts = traffic.warm_prompts(int(traffic.mix["warm"]["prefix_fill"]))
    base = 1 << 40                       # rids apart from the traffic's
    pending = set()
    for i, p in enumerate(prompts):
        pending.add(base + i)
        eng.submit(InferenceRequest(rid=base + i, prompt=p,
                                    max_new_tokens=1))
    while pending:
        for resp in eng.step():
            pending.discard(resp.rid)


def _counters(eng) -> Dict[str, float]:
    """The engine's lifetime counters, summed over instances."""
    out = {k: 0 for k in ("prefill_chunks", "prefix_hit_tokens",
                          "decode_dispatches", "host_syncs",
                          "h2d_transfers")}
    for inst in eng.instances:
        for k in out:
            out[k] += getattr(inst, k, 0)
    s = eng._session
    out["decode_steps"] = s.decode_steps if s is not None else 0
    return out


def _end_to_end(name: str, ctx: Dict) -> Optional[float]:
    if name == "setup_s":
        return ctx["setup_s"]
    if name == "tokens_per_s":
        return ctx["window_tokens"] / ctx["window_s"]
    if name == "j_per_token":
        if ctx["joules"] is None or not ctx["window_tokens"]:
            return None
        return ctx["joules"] / ctx["window_tokens"]
    if name == "ttft_p95_ms":
        return readers.ttft_p95_ms(ctx)
    if name == "tpot_p95_ms":
        return readers.tpot_p95_ms(ctx)
    raise KeyError(f"no end-to-end reading for {name!r}")


class HostProbe:
    """What the host did over the window, for the run's record (not a
    metric): the process's CPU seconds and context switches, the
    collector's passes and their time, and, once the window has closed,
    the time of a fixed loop of plain Python."""

    def __init__(self) -> None:
        self.gc_s, self.gc_n, self._t = 0.0, [0, 0, 0], None

    def _gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n[info["generation"]] += 1
            self._t = None

    def start(self) -> None:
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._gc)

    def stop(self) -> Dict:
        gc.callbacks.remove(self._gc)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        return {"utime_s": r1.ru_utime - self.r0.ru_utime,
                "stime_s": r1.ru_stime - self.r0.ru_stime,
                "vol_switches": r1.ru_nvcsw - self.r0.ru_nvcsw,
                "invol_switches": r1.ru_nivcsw - self.r0.ru_nivcsw,
                "gc_s": self.gc_s, "gc_passes": list(self.gc_n),
                "py_loop_ms": _py_loop_ms()}


def _py_loop_ms() -> float:
    """The wall (ms) of a fixed loop of plain Python, the best of three:
    the host's speed at the Python the engine's loop runs."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def _step_stats(step_s: List[float], window_s: float) -> Dict:
    """The loop's steps in the window: how many, their wall (ms) at the
    median and the 95th percentile, and their share of the window."""
    if not step_s:
        return {"steps": 0}
    return {"steps": len(step_s),
            "step_ms_p50": 1e3 * readers.percentile(step_s, 50),
            "step_ms_p95": 1e3 * readers.percentile(step_s, 95),
            "step_share": sum(step_s) / window_s}


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once in set-up, so its first start
    (CUPTI's) is not paid inside the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones((8,), device=device).sum()
        torch.cuda.synchronize(device)


def _profile_slice(loop: Loop, log: WorkLog, device: torch.device) -> Dict:
    """Profile the engine for ``SLICE_S`` seconds, the device drained at
    both ends: the card alone (its kernels, for the busy share and the
    kernels' times, at the least cost to the host), then for
    ``HOST_SLICE_S`` the card and the host's operations (what the host
    did in each idle gap).  Returns both profiles, reduced by
    :func:`reduce_slice` once the window has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from clover_bench.trace import SLICE
    torch.cuda.synchronize(device)
    log.in_slice = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok0 = loop.tokens
        loop.run_until(t0 + SLICE_S)
        torch.cuda.synchronize(device)
        slice_s = time.perf_counter() - t0
        slice_tokens = loop.tokens - tok0
    log.in_slice = False
    loop.ranges = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_host:
        with record_function(SLICE):
            loop.run_until(time.perf_counter() + HOST_SLICE_S)
            torch.cuda.synchronize(device)
    loop.ranges = False
    return {"slice_s": slice_s, "slice_tokens": slice_tokens,
            "t_slice": (t0, t0 + slice_s), "prof": prof,
            "prof_host": prof_host}


def reduce_slice(p: Dict) -> Dict:
    """What the metrics and the breakdown read from ``_profile_slice``'s
    two profiles (reduced once the window has closed)."""
    from clover_bench.trace import DeviceTrace, rows
    decode = ("decode_split_kernel", "PagedKV")
    prefill = ("paged_prefill_split_kernel", "paged_prefill_merge_kernel")
    t_r = time.perf_counter()
    tr = DeviceTrace(rows(p["prof"]))
    out = {"busy_s": tr.busy_s, "window_s": p["slice_s"],
           "t_slice": p["t_slice"],
           "slice_tokens_per_s": p["slice_tokens"] / p["slice_s"],
           "decode_kernel_s": tr.kernel_s(
               lambda n: all(x in n for x in decode)),
           "prefill_kernel_s": tr.kernel_s(
               lambda n: any(x in n for x in prefill)),
           "device_ops": tr.top_ops(10),
           "idle_gaps": DeviceTrace(rows(p["prof_host"])).idle_by_host(10)}
    out["reduce_s"] = time.perf_counter() - t_r
    return out
