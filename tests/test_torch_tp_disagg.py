"""Prefill/decode disaggregation on a rank mesh: ``DisaggEngine`` (one
prefill and one decode worker) on a (2, 2) mesh of 4 gloo ranks on the
CPU (``launch/ranks.py``; the rank side is ``tests/torch_tp_scenarios.py``
``disagg_group``, run once for the file), held to the contracts of the
reference's ``tests/multidev_scenarios.py:215-283``, whose own sharded
runs fail in this JAX (ROADMAP queue C):

* ``scenario_disagg_vs_monolithic_parity``: a starved decode arena (14
  blocks, preemption) serving 4 prompts over a shared 16-token prefix, 16
  new tokens each — streams equal to the unsharded monolithic engine's
  (33 blocks, no preemption), the port's and the reference's on the
  reference's weights (through ``models/bridge.py``), a handoff a prompt, at least one
  preemption and one page saved by a partial swap-in from the decode
  worker's radix tree, and the role joules conserved
  (``obs.validate.check_disagg_conservation``);
* ``scenario_disagg_smoke``: 3 prompts, 4 new tokens — all served, a
  handoff each, streams equal to the unsharded engine's (both), joules
  conserved.

Each rank swaps and hands off its own heads' pages with no collective;
every rank's streams, stats and data replicas' arenas are checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_scenarios as S
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.core import config_graph as CGJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.launch import ranks
from repro_torch.obs.validate import check_disagg_conservation

MONO_KW = dict(n_slots=4, max_len=48, kv_layout="paged", block_size=8,
               max_seqs=4, n_blocks=33)
SMOKE_MONO_KW = dict(n_slots=2, max_len=32, kv_layout="paged")
CFG_J = get_smoke_config_j("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)


@pytest.fixture(scope="module")
def run():
    """(each rank's results, the port's unsharded monolithic engines'
    sessions, the reference's), all on the reference's seeded weights."""
    fam_j = ENGJ.build_engine_family(CFG_J, fracs=(1.0,))
    flat = _flatten(fam_j[0].params)
    results = ranks.spawn(S.disagg_group, 4, "cpu", args=(flat,),
                          timeout=300)
    whole, ref = {}, {}
    for key, prompts, n_new, kw in (
            ("starved", S.starved_prompts(), 16, MONO_KW),
            ("smoke", S.smoke_prompts(), 4, SMOKE_MONO_KW)):
        whole[key] = S.serve(S.CFG, None, prompts, n_new, flat=flat, **kw)
        eng = ENGJ.RealEngine(fam_j, **kw)
        eng.configure(CGJ.ConfigGraph.from_dict(CFG_J.name, {("x1", 16): 1}))
        stats = eng._serve_prompts(prompts, n_new=n_new)
        ref[key] = {"outputs": dict(eng.last_outputs), "stats": stats}
    return results, whole, ref


def _same_streams(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_starved_disagg_matches_monolithic(run):
    results, whole, _ = run
    assert whole["starved"]["stats"]["preemptions"] == 0
    for r in results:
        p = r["starved"]
        m = p["stats"]
        _same_streams(p["outputs"], whole["starved"]["outputs"])
        assert m["handoffs"] == len(S.starved_prompts())
        assert m["preemptions"] >= 1
        assert m["swapin_pages_copied"] + m["partial_swapin_pages_saved"] >= 1
        assert m["partial_swapin_pages_saved"] >= 1
        check_disagg_conservation(m)
        assert m["prefill_energy_j"] > 0 and m["decode_energy_j"] > 0
        assert m == results[0]["starved"]["stats"]


def test_disagg_smoke_serves_and_conserves(run):
    results, whole, _ = run
    for r in results:
        p = r["smoke"]
        m = p["stats"]
        assert m["served"] == len(S.smoke_prompts())
        assert m["handoffs"] == len(S.smoke_prompts())
        _same_streams(p["outputs"], whole["smoke"]["outputs"])
        check_disagg_conservation(m)


@pytest.mark.parametrize("scenario", ("starved", "smoke"))
def test_disagg_streams_equal_reference_monolithic(run, scenario):
    """Every rank's streams equal the reference's unsharded monolithic
    engine's on the same weights, and the port's unsharded monolithic
    engine took the reference's prefix hits."""
    results, whole, ref = run
    assert whole[scenario]["stats"]["prefix_hit_tokens"] == \
        ref[scenario]["stats"]["prefix_hit_tokens"]
    for r in results:
        _same_streams(r[scenario]["outputs"], ref[scenario]["outputs"])


@pytest.mark.parametrize("scenario", ("starved", "smoke"))
def test_disagg_workers_arenas_replicated_over_data(run, scenario):
    """Both workers' arenas hold K/2 heads a rank, bit-equal across the
    two data replicas of each model coordinate."""
    by_model = {}
    for r in run[0]:
        p = r[scenario]
        roles = [a[0] for a in p["arenas"]]
        assert sorted(roles) == ["decode", "prefill"]
        by_model.setdefault(p["coords"][1], []).append(p["arenas"])
    assert len(by_model) == 2
    for replicas in by_model.values():
        assert len(replicas) == 2
        for (ra, ka, va), (rb, kb, vb) in zip(*replicas):
            assert ra == rb and ka.shape[3] == S.CFG.n_kv_heads // 2
            np.testing.assert_array_equal(ka, kb)
            np.testing.assert_array_equal(va, vb)
