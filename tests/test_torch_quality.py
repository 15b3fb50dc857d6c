"""The port's mixed-quality request path against the reference's: the
selector units (static pinning, greedy dirty-grid downshifting, the
windowed accuracy-floor governor, per-request hint/floor clamps, the
registry) make identical decisions in both packages; the port's slotted
and paged engines give the same decision sequence as the reference's
engine and DES on one workload and serve each request on its decided rung;
and accuracy is labelled by SLO class."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import catalog as CAT
from repro.core import config_graph as CGJ
from repro.serving import engine as ENGJ
from repro.serving import queue as Q
from repro.serving import quality as QJ
from repro.serving.api import InferenceRequest as RequestJ
from repro.serving.api import serve_workload as serve_workload_j
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.core import catalog as CATT
from repro_torch.core import config_graph as CGT
from repro_torch.models import bridge
from repro_torch.serving import engine as ENG
from repro_torch.serving import quality as QT
from repro_torch.serving.api import DEFERRABLE, INTERACTIVE, \
    InferenceRequest, serve_workload

CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE
MIX = {("x0.5", 16): 1, ("x1", 16): 1}


@pytest.fixture(scope="module")
def families():
    """Two real rungs in each package, the same weights: x0.5 (quality 1,
    accuracy 0.80) and x1 (quality 2, accuracy 0.85)."""
    fam_j = ENGJ.build_engine_family(CFG, fracs=(1.0, 0.5))
    fam_t = ENG.build_engine_family(CFG_T, fracs=(1.0, 0.5), device="cpu")
    for ev_j, ev_t in zip(fam_j, fam_t):
        assert ev_j.variant.name == ev_t.variant.name
        bridge.load_reference(ev_t.params, _flatten(ev_j.params))
    return fam_j, fam_t


def _ladders():
    """The efficientnet rungs B1 (0.791) and B3 (0.816), as the reference's
    variants and as the port's."""
    by = {v.name: v for v in CAT.get_family("efficientnet")}
    ref = [by["B1"], by["B3"]]
    return ref, [CATT.Variant(**dataclasses.asdict(v)) for v in ref]


def _both(make):
    """The selector ``make(package)`` builds, from each package, bound to
    the same ladder: (reference's, port's)."""
    sels = make(QJ), make(QT)
    for sel, ladder in zip(sels, _ladders()):
        sel.reset(ladder)
    return sels


def _decide(sels, rid, slo=INTERACTIVE, arrival=None, **kw):
    """One request through both selectors; the decisions must be equal
    field for field.  Returns the port's."""
    decs = [sel.select(Req(rid=rid, prompt=[1], max_new_tokens=8, slo=slo,
                           arrival_s=arrival, **kw))
            for sel, Req in zip(sels, (RequestJ, InferenceRequest))]
    assert dataclasses.astuple(decs[0]) == dataclasses.astuple(decs[1])
    return decs[1]


# =============================================================================
# selector units (the reference's tests/test_quality.py:69-129)
# =============================================================================
def test_static_pin_selector_pins_class_and_defaults_rest():
    sels = _both(lambda Q_: Q_.StaticPinSelector(pins={DEFERRABLE: "B1"}))
    d0 = _decide(sels, 0, DEFERRABLE)
    d1 = _decide(sels, 1, INTERACTIVE)
    assert (d0.variant, d0.reason) == ("B1", "pinned")
    assert (d1.variant, d1.reason) == ("B3", "default")
    assert sels[1].decision_sequence() == [(0, "B1", "pinned"),
                                           (1, "B3", "default")]


def test_greedy_downshifts_deferrable_when_dirty_only():
    sels = _both(lambda Q_: Q_.GreedyDownshiftSelector(
        ci_fn=lambda t: 400.0 if t < 60 else 50.0, dirty_threshold_g=300.0,
        sustain_s=30.0))
    assert _decide(sels, 0, DEFERRABLE, 0.0).reason == "downshift"
    assert _decide(sels, 1, INTERACTIVE, 10.0).reason == "default"
    # sustained dirt (>= 30 s since t=0) drops interactive one rung too
    d = _decide(sels, 2, INTERACTIVE, 45.0)
    assert d.reason == "pressure" and d.variant == "B1"
    # clean grid restores everyone to best (and resets the sustain clock)
    assert _decide(sels, 3, DEFERRABLE, 90.0).variant == "B3"
    assert _decide(sels, 4, INTERACTIVE, 95.0).reason == "default"


def test_governor_refuses_floor_breaching_downshift():
    sels = _both(lambda Q_: Q_.AccuracyFloorGovernor(
        base=Q_.GreedyDownshiftSelector(ci_fn=lambda t: 400.0),
        floors={DEFERRABLE: 0.80}))
    # empty window: a lone B1 would put the mean at 0.791 < 0.80 → refused
    d0 = _decide(sels, 0, DEFERRABLE, 0.0)
    assert (d0.variant, d0.reason) == ("B3", "floor")
    # window now holds 0.816: (0.816 + 0.791) / 2 = 0.8035 ≥ 0.80 → allowed
    d1 = _decide(sels, 1, DEFERRABLE, 1.0)
    assert (d1.variant, d1.reason) == ("B1", "downshift")
    # (0.816 + 0.791 + 0.791) / 3 = 0.799 < 0.80 → refused again
    d2 = _decide(sels, 2, DEFERRABLE, 2.0)
    assert (d2.variant, d2.reason) == ("B3", "floor")
    assert sels[1].window_mean(DEFERRABLE) == \
        sels[0].window_mean(DEFERRABLE) >= 0.80
    # the window prunes: far in the future the refusals start over
    d3 = _decide(sels, 3, DEFERRABLE, 10 * 3600.0)
    assert (d3.variant, d3.reason) == ("B3", "floor")


def test_per_request_hint_and_min_accuracy_clamp():
    sels = _both(lambda Q_: Q_.GreedyDownshiftSelector(
        ci_fn=lambda t: 400.0))                  # always dirty
    # the hint pins even against the downshifter's choice
    d = _decide(sels, 0, DEFERRABLE, 0.0, quality_hint="B3")
    assert (d.variant, d.reason) == ("B3", "hint")
    # an unknown hint is ignored (the rung isn't instantiable here)
    assert _decide(sels, 1, DEFERRABLE, 0.0,
                   quality_hint="B9").variant == "B1"
    # min_accuracy is a hard clamp: B1's 0.791 < 0.8 → promoted
    d = _decide(sels, 2, DEFERRABLE, 0.0, min_accuracy=0.8)
    assert (d.variant, d.reason) == ("B3", "min_accuracy")


def test_make_selector_registry():
    assert QT.make_selector(None) is None
    assert QT.make_selector("off") is None
    sel = QT.make_selector("static", pins={DEFERRABLE: "B1"},
                           ci_fn=lambda t: 0.0)    # irrelevant kwarg dropped
    assert isinstance(sel, QT.StaticPinSelector)
    assert QT.make_selector(sel) is sel            # instance passthrough
    assert isinstance(QT.make_selector("greedy"), QT.GreedyDownshiftSelector)
    assert isinstance(QT.make_selector("governed"), QT.AccuracyFloorGovernor)
    assert sorted(QT.selectors.SELECTORS) == sorted(QJ.selectors.SELECTORS)
    with pytest.raises(ValueError):
        QT.make_selector("nope")
    with pytest.raises(NotImplementedError):
        base = QT.QualitySelector()
        base.reset(_ladders()[1])
        base.select(InferenceRequest(rid=0, prompt=[1], max_new_tokens=8))


# =============================================================================
# decision-sequence conformance (the reference's tests/test_quality.py:221)
# =============================================================================
def _conformance_workload(Req):
    """Arrival clocks under 1 s, so the real engines replay the open-loop
    schedule the DES simulates; the stepped grid is dirty for the first
    0.2 s of decision time."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(10):
        kw = {}
        if i == 6:
            kw["quality_hint"] = "x0.5"
        if i == 3:          # dirty window: would downshift without the floor
            kw["min_accuracy"] = 0.82
        reqs.append(Req(
            rid=i, prompt=rng.integers(0, CFG.vocab_size, size=4)
            .astype(np.int32), max_new_tokens=4,
            slo=DEFERRABLE if i % 2 else INTERACTIVE,
            arrival_s=i * 0.05, **kw))
    return reqs


def _conformance_selector(Q_):
    return Q_.make_selector(
        "governed", ci_fn=lambda t: 500.0 if t < 0.2 else 50.0,
        dirty_threshold_g=300.0, sustain_s=0.1, floors={DEFERRABLE: 0.82})


def _served_as_decided(sel, responses):
    dec_of = {d.rid: d for d in sel.decisions}
    for r in responses:
        assert r.variant == dec_of[r.rid].variant, r.rid
        assert r.accuracy == dec_of[r.rid].accuracy, r.rid


def test_decision_sequence_identical_across_backends(families):
    fam_j, fam_t = families
    sequences = {}
    for layout in ("slotted", "paged"):
        for name, fam, cg, Q_, Req, serve, kw in (
                ("ref", fam_j, CGJ, QJ, RequestJ, serve_workload_j, {}),
                ("port", fam_t, CGT, QT, InferenceRequest, serve_workload,
                 {"device": "cpu"})):
            sel = _conformance_selector(Q_)
            eng = (ENGJ if name == "ref" else ENG).RealEngine(
                fam, n_slots=2, max_len=32, kv_layout=layout, block_size=8,
                policy="fifo", ci_g_per_kwh=100.0, quality_selector=sel,
                **kw)
            eng.configure(cg.ConfigGraph.from_dict(CFG.name, MIX))
            responses = serve(eng, _conformance_workload(Req))
            m = eng.stats()
            assert m["served"] == 10
            _served_as_decided(sel, responses)
            assert sum(r.energy_j for r in responses) == \
                pytest.approx(m["energy_j"], rel=1e-9)
            sequences[layout, name] = sel.decision_sequence()
    sel = _conformance_selector(QJ)
    des = Q.DESBackend(CGJ.ConfigGraph.from_dict(CFG.name, MIX),
                       [ev.variant for ev in fam_j],
                       Q.DESConfig(jitter_sigma=0.0), policy="fifo",
                       ci_g_per_kwh=100.0, quality_selector=sel)
    _served_as_decided(sel, serve_workload_j(
        des, _conformance_workload(RequestJ)))
    sequences["des"] = sel.decision_sequence()
    # one workload, one decision sequence, on every engine of both packages
    # and on the reference's DES
    assert len(set(map(tuple, sequences.values()))) == 1, sequences
    chosen = {v for _, v, _ in sequences["des"]}
    reasons = {why for _, _, why in sequences["des"]}
    assert chosen == {"x0.5", "x1"}
    assert "hint" in reasons and "min_accuracy" in reasons


# =============================================================================
# accuracy by SLO class (the reference's tests/test_quality.py:284)
# =============================================================================
def test_real_engine_labels_accuracy_by_slo_class(families):
    fam_j, fam_t = families
    served = {}
    for name, fam, cg, Q_, Req, serve, kw in (
            ("ref", fam_j, CGJ, QJ, RequestJ, serve_workload_j, {}),
            ("port", fam_t, CGT, QT, InferenceRequest, serve_workload,
             {"device": "cpu"})):
        eng = (ENGJ if name == "ref" else ENG).RealEngine(
            fam, n_slots=2, max_len=32, policy="fifo",
            quality_selector=Q_.make_selector(
                "static", pins={DEFERRABLE: "x0.5"}), **kw)
        eng.configure(cg.ConfigGraph.from_dict(CFG.name, MIX))
        rng = np.random.default_rng(13)
        reqs = [Req(rid=i, prompt=rng.integers(0, CFG.vocab_size, size=4)
                    .astype(np.int32), max_new_tokens=4,
                    slo=DEFERRABLE if i % 2 else INTERACTIVE)
                for i in range(8)]
        responses = serve(eng, reqs)
        reg = eng.last_registry
        for slo in (INTERACTIVE, DEFERRABLE):
            child = reg.labeled("accuracy", slo_class=slo)
            assert child.count == sum(1 for r in responses if r.slo == slo)
        # the pin held: every deferrable response served on the small rung
        assert all(r.variant == "x0.5" for r in responses
                   if r.slo == DEFERRABLE)
        assert all(r.variant == "x1" for r in responses
                   if r.slo == INTERACTIVE)
        served[name] = {r.rid: (r.variant, r.accuracy, list(r.tokens))
                        for r in responses}
    assert served["port"] == served["ref"]
