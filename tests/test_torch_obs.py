"""The port's telemetry plane against the reference's, at SMOKE size on the
CPU with the reference's weights carried across: the request trace
conserves joules through preemption and partial swap-in and records the
same lifecycle as the reference's engine; phase timings and the per-tick
counter tracks reach the registry and the Chrome export; an engine without
a bundle records nothing; and the port's carbon feed gives bit-identical
totals and snapshots to the reference's on the same segments."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import carbon as CBJ
from repro.core import config_graph as CGJ
from repro.obs import CarbonFeed as CarbonFeedJ
from repro.obs import Telemetry as TelemetryJ
from repro.obs import TraceRecorder as TraceRecorderJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import carbon as CBT
from repro_torch.core import config_graph as CGT
from repro_torch.models import bridge
from repro_torch.obs import CATALOG, CarbonFeed, Telemetry, TraceRecorder, \
    validate_chrome_events, validate_trace
from repro_torch.serving import engine as ENG

CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE


@pytest.fixture(scope="module")
def families():
    """(reference family, port family with the same weights)."""
    fam_j = ENGJ.build_engine_family(CFG, fracs=(1.0,))
    fam_t = ENG.build_engine_family(CFG_T, fracs=(1.0,), device="cpu")
    bridge.load_reference(fam_t[0].params, _flatten(fam_j[0].params))
    return fam_j, fam_t


def _bundles(backend):
    """(reference bundle, port bundle), each with its tracer and feed."""
    return (TelemetryJ(tracer=TraceRecorderJ(backend),
                       feed=CarbonFeedJ(300.0, interval_s=1e9,
                                        region=backend), backend=backend),
            Telemetry(tracer=TraceRecorder(backend),
                      feed=CarbonFeed(300.0, interval_s=1e9, region=backend),
                      backend=backend))


def _pair(families, telemetry=(None, None), **kw):
    fam_j, fam_t = families
    ref = ENGJ.RealEngine(fam_j, telemetry=telemetry[0], **kw)
    ref.configure(CGJ.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    eng = ENG.RealEngine(fam_t, telemetry=telemetry[1], device="cpu", **kw)
    eng.configure(CGT.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    return ref, eng


def _lifecycle(tr):
    """What a trace records apart from wall-clock times: every record's
    kind, name and request, the decode ticks' occupant sets, the counter
    tracks' values and the preempted spans' page counts."""
    out = []
    for r in tr.records:
        rec = (r["kind"], r["name"], r.get("rid"))
        if r["name"] == "decode_tick":
            rec += (tuple(r["args"]["rids"]), r["args"]["n"])
        elif r["kind"] == "counter":
            rec += (r["value"],)
        elif r["name"] in ("preempted", "swap_out"):
            rec += (r["args"]["pages"],)
        out.append(rec)
    return out


# =============================================================================
# the trace through preemption and partial swap-in (the reference's
# tests/test_obs.py:302)
# =============================================================================
def test_engine_trace_conserves_through_preemption_and_swapin(families):
    rng = np.random.default_rng(5)
    pre = rng.integers(0, CFG.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, CFG.vocab_size, size=6)
                               .astype(np.int32)]) for _ in range(4)]
    tels = _bundles("real-paged")
    ref, eng = _pair(families, telemetry=tels, n_slots=2, max_len=64,
                     kv_layout="paged", block_size=8, max_seqs=4,
                     n_blocks=14, preemption=True, ci_g_per_kwh=300.0)
    m_ref = ref._serve_prompts(prompts, n_new=16)
    m = eng._serve_prompts(prompts, n_new=16)
    assert m["preemptions"] >= 1, "arena did not force preemption"
    assert m["partial_swapin_pages_saved"] >= 1
    for key in ("preemptions", "partial_swapin_pages_saved",
                "prefill_chunks", "decode_steps", "blocks_peak"):
        assert m[key] == m_ref[key], key
    for rid in ref.last_outputs:
        np.testing.assert_array_equal(ref.last_outputs[rid],
                                      eng.last_outputs[rid])

    tel = tels[1]
    s = validate_trace(tel.tracer, expect_energy_j=m["energy_j"],
                       expect_requests=4)
    assert s["carbon_g"] == pytest.approx(m["carbon_g"], rel=1e-9)
    tr = tel.tracer
    pre_spans = tr.spans("preempted")       # opened at swap-out, closed at
    assert len(pre_spans) == m["preemptions"]          # partial swap-in
    assert all(p["t1"] > p["t0"] and "pages" in p["args"]
               for p in pre_spans)
    assert len(tr.instants("swap_out")) == m["preemptions"]
    assert len(tr.instants("swap_in")) == m["preemptions"]
    assert len(tr.spans("prefill_chunk")) == m["prefill_chunks"]
    assert len(tr.spans("decode_tick")) == m["decode_steps"]
    occupants = [d["args"]["rids"] for d in tr.spans("decode_tick")]
    assert any(len(o) > 1 for o in occupants)   # batched ticks, one event
    # the same lifecycle, record for record, as the reference's trace
    assert _lifecycle(tr) == _lifecycle(tels[0].tracer)

    reg = eng.last_registry
    assert reg.names() == set(CATALOG)
    assert reg.value("preemptions") == m["preemptions"]
    assert reg.value("swapin_pages_saved") == m["partial_swapin_pages_saved"]
    assert reg.gauge("blocks_in_use").peak == m["blocks_peak"]
    tel.feed.flush(m["wall_s"])
    assert tel.feed.energy_j_total == pytest.approx(m["energy_j"],
                                                    rel=1e-12)


# =============================================================================
# phase profiling and counter tracks (the reference's tests/test_obs.py:366)
# =============================================================================
def test_engine_phase_profiling_and_counter_tracks(families, tmp_path):
    tels = _bundles("real-paged")
    ref, eng = _pair(families, telemetry=tels, n_slots=2, max_len=48,
                     kv_layout="paged", block_size=8, max_seqs=4,
                     n_blocks=20, ci_g_per_kwh=300.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, size=6).astype(np.int32)
               for _ in range(4)]
    ref._serve_prompts(prompts, n_new=8)
    eng._serve_prompts(prompts, n_new=8)
    reg = eng.last_registry
    assert reg.labels.get("kv_layout") == "paged"
    phases = {d["phase"]: h for _, d, h in
              reg.labeled_series("phase_latency_s")}
    assert {"prefill_chunk", "decode_dispatch", "decode_land"} <= set(phases)
    assert all(h.count > 0 and h.sum >= 0.0 for h in phases.values())
    counts_ref = {d["phase"]: h.count for _, d, h in
                  ref.last_registry.labeled_series("phase_latency_s")}
    assert {p: h.count for p, h in phases.items()} == counts_ref
    # per-request slo_class children recorded alongside the parents
    assert any(d.get("slo_class") for _, d, _ in
               reg.labeled_series("latency_s"))
    # the chrome export carries the per-tick counter tracks
    ct = tmp_path / "t.json"
    tels[1].tracer.to_chrome_trace(str(ct))
    doc = json.loads(ct.read_text())
    assert validate_chrome_events(doc["traceEvents"]) == \
        len(tels[1].tracer.records)
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    by_name = {}
    for e in counters:
        by_name.setdefault(e["name"], []).append(e)
    assert {"blocks_in_use", "occupied_rows", "power_w"} <= set(by_name)
    # one sample per engine tick on every track, power always > 0 (the
    # idle floor), and occupancy actually moved during the session
    n_ticks = {n: len(v) for n, v in by_name.items()
               if n in ("blocks_in_use", "occupied_rows", "power_w")}
    assert len(set(n_ticks.values())) == 1
    assert all(next(iter(e["args"].values())) > 0.0
               for e in by_name["power_w"])
    occ = [next(iter(e["args"].values())) for e in by_name["occupied_rows"]]
    assert max(occ) > 0.0
    assert _lifecycle(tels[1].tracer) == _lifecycle(tels[0].tracer)


def test_engine_detached_profiler_records_nothing(families):
    ref, eng = _pair(families, n_slots=2, max_len=48, kv_layout="paged",
                     block_size=8, max_seqs=4, n_blocks=20,
                     ci_g_per_kwh=300.0)          # no telemetry bundle
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, size=6).astype(np.int32)
               for _ in range(2)]
    eng._serve_prompts(prompts, n_new=4)
    assert eng.profiler.registry is None
    assert list(eng.last_registry.labeled_series("phase_latency_s")) == []


# =============================================================================
# the carbon feed, bit for bit
# =============================================================================
def test_carbon_feed_bit_identical_to_reference():
    """The port's feed and the reference's, each fed the same segments —
    the reference's accountant path (exact grams), the midpoint-CI path
    (grams left to the feed, each package's own trace) and the sampler —
    emit equal snapshots and totals, compared with ``==``.  (The
    reference's own check that the snapshots' energies sum to the total
    fails by one ulp of summation order; this test holds the port to the
    reference's values, not to that sum.)"""
    tr_j = CBJ.make_trace("CISO-March", hours=6.0)
    tr_t = CBT.make_trace("CISO-March", hours=6.0)
    feeds = {"ref": CarbonFeedJ(tr_j.at, interval_s=600.0, region="r",
                                pue=CBJ.PUE_DEFAULT),
             "port": CarbonFeed(tr_t.at, interval_s=600.0, region="r",
                                pue=CBT.PUE_DEFAULT)}
    seen = {name: [] for name in feeds}
    for name, feed in feeds.items():
        feed.subscribe(seen[name].append)
    acct = CBJ.CarbonAccountant(tr_j, feed=feeds["ref"])
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(40):
        dt = float(rng.uniform(30.0, 400.0))
        p_w = float(rng.uniform(100.0, 5000.0))
        if i % 2:
            g = acct.add(t, dt, power_w=p_w)           # → the ref's feed
            feeds["port"].record_segment(t, dt, p_w * dt, g)
        else:
            for feed in feeds.values():
                feed.record_segment(t, dt, p_w * dt)
        t += dt
    for feed in feeds.values():
        feed.sample(t, 800.0)
        feed.sample(t + 120.0, 1200.0)
        feed.flush(t + 120.0, sla_ok_frac=0.97)
    ref, port = feeds["ref"], feeds["port"]
    assert port.energy_j_total == ref.energy_j_total
    assert port.carbon_g_total == ref.carbon_g_total
    assert port.pending_energy_j == ref.pending_energy_j == 0.0
    assert len(port.snapshots) == len(ref.snapshots) > 1
    assert [dataclasses.asdict(s) for s in port.snapshots] == \
        [dataclasses.asdict(s) for s in ref.snapshots]
    assert len(seen["port"]) == len(seen["ref"])
    assert seen["port"] == port.snapshots
    assert port.latest().sla_ok_frac == 0.97
