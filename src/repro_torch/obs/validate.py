"""Self-contained telemetry validation — the port's copy of the reference
package's ``obs/validate.py``; run it as

    python -m repro_torch.obs.validate

Runs a small two-class workload through the torch-free DES backend with the
FULL telemetry bundle attached — metrics registry, trace recorder, carbon
feed — under a carbon-aware hold policy on a stepped grid, then enforces
every contract the observability layer promises:

  * the metric-name set equals the shared CATALOG exactly;
  * every span closed, and span-attributed joules == the backend's session
    energy total (the conservation invariant, :func:`repro_torch.obs.trace.
    validate_trace`);
  * per-response joules/grams also sum to the session totals;
  * held requests carry ``held_s`` ≤ their queue delay plus a release
    reason, and un-held requests carry neither;
  * the Chrome-trace export passes the Perfetto schema check and a JSON
    round-trip (written to a temp file exactly as a user would);
  * the OpenMetrics exposition round-trips exactly (export → parse →
    re-export identical) and its counter samples carry the same values the
    registry holds;
  * a fleet rollup over per-region copies conserves energy/carbon
    bit-exactly and exposes the same labeled family set as one region;
  * the mixed-quality request path (``serving.quality``): a governed
    selector on a two-rung pool downshifts deferrable work on the dirty
    spell, every response's accuracy/variant matches its decision, the
    per-class served mean never breaches the configured floor, and
    per-request joules still sum exactly to the session total;
  * disaggregated-serving conservation
    (:func:`check_disagg_conservation`): the per-role joules split a
    serving engine reports (``prefill_energy_j`` + ``decode_energy_j`` +
    ``handoff_energy_j`` + ``both_energy_j``) sums exactly to its
    ``energy_j`` session total — exercised here on synthetic stats dicts
    (both the disagg and the monolithic shape, plus a violated one that
    must be caught), and on real engine stats by the disaggregated
    engine's tests and ``chip_smoke.py``'s disaggregation phase.

It needs no device and no kernel (the modules it runs are stdlib and
numpy), and finishes in well under a second.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from repro_torch.core import catalog as CAT
from repro_torch.core import config_graph as CG
from repro_torch.obs import CarbonFeed, CATALOG, FleetRollup, \
    MetricsRegistry, Telemetry, TraceRecorder, parse_openmetrics, to_openmetrics, \
    validate_chrome_events, validate_trace
from repro_torch.obs.export import render_families
from repro_torch.serving import queue as Q
from repro_torch.serving.api import DEFERRABLE, INTERACTIVE, InferenceRequest
from repro_torch.serving.policies import CarbonAwarePolicy


ROLE_ENERGY_KEYS = ("prefill_energy_j", "decode_energy_j",
                    "handoff_energy_j", "both_energy_j")


def check_disagg_conservation(stats, rel_tol: float = 1e-9) -> float:
    """Assert the per-role joules split conserves against the session total.

    ``stats`` is any serving backend's ``stats()`` dict carrying the
    :data:`ROLE_ENERGY_KEYS` (monolithic engines put the whole total under
    ``both_energy_j``; disaggregated engines split it across prefill /
    decode / handoff).  The roles partition every charged joule by
    construction, so the check is exact up to float accumulation
    (``rel_tol`` of the total, the repo-wide conservation tolerance).
    Returns the session ``energy_j`` for convenience."""
    total = float(stats["energy_j"])
    by_role = sum(float(stats.get(k, 0.0)) for k in ROLE_ENERGY_KEYS)
    tol = rel_tol * max(total, 1e-12)
    assert abs(by_role - total) <= tol, \
        f"role energy split {by_role!r} J != session total {total!r} J " \
        f"(prefill+decode+handoff+both must conserve exactly)"
    return total


def _ci_step(t: float) -> float:
    """Dirty grid for the first minute, clean after — the hold policy parks
    deferrable work through the dirty spell and releases on "threshold"."""
    return 400.0 if t < 60.0 else 50.0


def build_backend() -> Q.DESBackend:
    variants = CAT.get_family("efficientnet")
    g = CG.ConfigGraph.from_dict("efficientnet", {("B3", 1): 1})
    policy = CarbonAwarePolicy(_ci_step, ci_threshold=100.0,
                               est_service_s=1.0)
    tel = Telemetry(tracer=TraceRecorder("des"),
                    feed=CarbonFeed(_ci_step, interval_s=30.0,
                                    region="validate"),
                    backend="des")
    return Q.DESBackend(g, variants, Q.DESConfig(jitter_sigma=0.0),
                        policy=policy, ci_g_per_kwh=_ci_step,
                        hold_retry_s=5.0, telemetry=tel)


def main() -> int:
    be = build_backend()
    rng = np.random.default_rng(0)
    rid = 0
    for a in np.linspace(0.0, 30.0, 8):          # interactive: always flow
        be.submit(InferenceRequest(
            rid=rid, prompt=rng.integers(0, 64, size=6).astype(np.int32),
            max_new_tokens=8, slo=INTERACTIVE, priority=1,
            arrival_s=float(a)))
        rid += 1
    for a in (1.0, 2.0, 3.0, 4.0):               # deferrable: held to t=60
        be.submit(InferenceRequest(
            rid=rid, prompt=rng.integers(0, 64, size=6).astype(np.int32),
            max_new_tokens=8, slo=DEFERRABLE, priority=0,
            arrival_s=a, deadline_s=a + 300.0))
        rid += 1
    responses = be.drain()
    stats = be.stats()
    tel = be.telemetry

    # 1. metric-name parity with the shared catalog
    assert tel.registry.names() == set(CATALOG), \
        f"metric names diverge from CATALOG: " \
        f"{tel.registry.names() ^ set(CATALOG)}"

    # 2. trace conservation: spans closed, joules sum to the session total
    summary = validate_trace(tel.tracer, expect_energy_j=stats["energy_j"],
                             expect_requests=int(stats["served"]))

    # 3. per-response attribution sums to the session totals too
    tol = 1e-9 * max(stats["energy_j"], 1e-12)
    assert abs(sum(r.energy_j for r in responses)
               - stats["energy_j"]) <= tol
    assert abs(sum(r.carbon_g for r in responses)
               - stats["carbon_g"]) <= 1e-9 * max(stats["carbon_g"], 1e-12)

    # 4. hold accounting: held deferrable work carries reason + held_s
    held = [r for r in responses if r.release_reason is not None]
    assert held, "stepped grid produced no holds — scenario degenerated"
    for r in held:
        assert r.slo == DEFERRABLE
        assert 0.0 <= r.held_s <= r.queue_delay_s + 1e-9, \
            f"rid {r.rid}: held_s {r.held_s} > queue_delay {r.queue_delay_s}"
    for r in responses:
        if r.release_reason is None:
            assert r.held_s == 0.0

    # 5. carbon feed streamed the exact same totals
    tel.feed.flush(stats["wall_s"])
    assert abs(tel.feed.energy_j_total - stats["energy_j"]) <= tol

    # 6. the exports themselves: JSONL + Perfetto-loadable Chrome trace
    with tempfile.TemporaryDirectory() as td:
        jl = os.path.join(td, "trace.jsonl")
        ct = os.path.join(td, "trace.json")
        tel.tracer.to_jsonl(jl)
        tel.tracer.to_chrome_trace(ct)
        with open(jl) as f:
            assert len(f.readlines()) == summary["records"]
        with open(ct) as f:
            doc = json.load(f)
        n_events = validate_chrome_events(doc["traceEvents"])

    # 7. OpenMetrics exposition round-trip: export → parse → re-export must
    # be byte-identical, and the counter samples must carry the registry's
    # exact values (repr round-trip)
    text = to_openmetrics(tel.registry)
    families = parse_openmetrics(text)
    assert render_families(families) == text, \
        "OpenMetrics round-trip diverged"
    e_samples = [v for n, lbl, v in families["repro_energy_j"]["samples"]
                 if n == "repro_energy_j_total" and "region" not in dict(lbl)]
    assert [float(v) for v in e_samples] == [stats["energy_j"]], \
        "exposition energy_j != registry energy_j"

    # 8. fleet-rollup conservation: split the session registry into two
    # synthetic regions and merge — region sums must equal fleet totals
    # EXACTLY, and the rollup must expose the same family set as a region
    rollup = FleetRollup()
    for rname, frac in (("east", 0.25), ("west", 0.75)):
        reg = MetricsRegistry.standard(rname, labels={"region": rname})
        reg.counter("energy_j").inc(frac * stats["energy_j"])
        reg.counter("carbon_g").inc(frac * stats["carbon_g"])
        reg.counter("requests_served").inc(
            round(frac * 4) + (0 if rname == "east" else stats["served"] - 4))
        rollup.add(reg)
    totals = rollup.conservation(("energy_j", "carbon_g",
                                  "requests_served"))
    fleet_families = parse_openmetrics(to_openmetrics(rollup))
    region_families = parse_openmetrics(
        to_openmetrics(rollup.regions["east"]))
    assert set(region_families) <= set(fleet_families), \
        "fleet exposition missing region families"

    # 9. mixed-quality request path: governed selector on a two-rung pool
    # under the same stepped grid — the dirty first minute must downshift
    # deferrable work, every served accuracy must equal its decision, the
    # per-class windowed mean must hold the floor, and attribution must
    # still conserve
    from repro_torch.serving.quality import make_selector
    floor = 0.80
    sel = make_selector("governed", ci_fn=_ci_step, dirty_threshold_g=100.0,
                        floors={DEFERRABLE: floor})
    mixed_g = CG.ConfigGraph.from_dict("efficientnet",
                                       {("B1", 1): 1, ("B3", 1): 1})
    mq = Q.DESBackend(mixed_g, CAT.get_family("efficientnet"),
                      Q.DESConfig(jitter_sigma=0.0), policy="fifo",
                      ci_g_per_kwh=_ci_step, quality_selector=sel)
    rng_q = np.random.default_rng(1)
    for i in range(24):
        mq.submit(InferenceRequest(
            rid=i, prompt=rng_q.integers(0, 64, size=6).astype(np.int32),
            max_new_tokens=8, slo=DEFERRABLE if i % 2 else INTERACTIVE,
            arrival_s=i * 10.0))
    mq_responses = mq.drain()
    mq_stats = mq.stats()
    dec_of = {d.rid: d for d in sel.decisions}
    assert len(mq_responses) == 24 and len(dec_of) == 24
    for r in mq_responses:
        d = dec_of[r.rid]
        assert r.variant == d.variant and r.accuracy == d.accuracy, \
            f"rid {r.rid}: served {r.variant}/{r.accuracy} != decided " \
            f"{d.variant}/{d.accuracy}"
    downshifted = [r for r in mq_responses
                   if dec_of[r.rid].reason == "downshift"]
    assert downshifted, "dirty spell produced no downshift — degenerated"
    assert all(r.slo == DEFERRABLE and r.accuracy < sel.best.accuracy
               for r in downshifted)
    for slo in (INTERACTIVE, DEFERRABLE):
        accs = [r.accuracy for r in mq_responses if r.slo == slo]
        mean = sum(accs) / len(accs)
        assert mean >= floor - 1e-12, \
            f"{slo} served mean {mean:.4f} breached the {floor} floor"
    mq_tol = 1e-9 * max(mq_stats["energy_j"], 1e-12)
    assert abs(sum(r.energy_j for r in mq_responses)
               - mq_stats["energy_j"]) <= mq_tol, \
        "mixed-quality routing broke per-request energy conservation"

    # 10. disagg role-split conservation: the checker itself must accept
    # both stats shapes (disagg split / monolithic "both") and reject a
    # violated split — the real-engine stats are held to this same
    # function by the disaggregated engine's tests and chip_smoke.py
    check_disagg_conservation({
        "energy_j": 10.0, "prefill_energy_j": 6.0, "decode_energy_j": 3.5,
        "handoff_energy_j": 0.5, "both_energy_j": 0.0})
    check_disagg_conservation({"energy_j": stats["energy_j"],
                               "both_energy_j": stats["energy_j"]})
    try:
        check_disagg_conservation({"energy_j": 10.0,
                                   "prefill_energy_j": 6.0})
    except AssertionError:
        pass
    else:
        raise AssertionError("check_disagg_conservation accepted a "
                             "non-conserving role split")

    print(f"obs.validate OK: {int(stats['served'])} requests, "
          f"{summary['spans']} spans, {n_events} chrome events, "
          f"{len(held)} holds released, "
          f"energy {stats['energy_j']:.1f} J conserved, "
          f"openmetrics {len(families)} families round-tripped, "
          f"rollup conserved {totals['energy_j']:.1f} J over "
          f"{len(rollup.regions)} regions, "
          f"mixed-quality governed {len(downshifted)} downshifts "
          f"with the {floor} floor held, "
          f"disagg role-split conservation enforced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
