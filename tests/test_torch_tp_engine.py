"""The paged engine on rank meshes: ``RealEngine(kv_layout="paged",
mesh=...)`` on a CPU process group of 8 gloo ranks (``launch/ranks.py``;
the rank side is ``tests/torch_tp_scenarios.py`` ``engine_group``, run
once for the file), against the port's unsharded engine and the
reference's unsharded engine on the reference's weights (carried over
through ``models/bridge.py``), on the workload of the reference's
``tests/multidev_scenarios.py:166-212`` (``scenario_sharded_paged_decode_
parity``: qwen3-1.7b SMOKE at 2 layers, f32; prompts of 6-22 tokens over a
shared 12-token prefix, block size 8, 4 rows, 10 new tokens).  The
reference's own sharded engine fails in this JAX (ROADMAP queue C), so
its contract is what is held:

* on meshes (1, 2), (2, 1), (2, 2) and the reference's (4, 2) every rank's
  streams equal the unsharded engine's, with equal prefix-hit tokens
  above 0 and equal counters, and equal the reference's unsharded
  engine's, with its prefix-hit tokens;
* the arena: every data replica's is bit-equal (the new K/V rows are
  all-gathered over "data" and every replica writes them all), and each
  rank's holds the unsharded arena's slice of KV heads within 1e-5;
* the session's stats are rank 0's on every rank, with its collectives
  counted;
* qwen3-moe SMOKE (2 layers, 8 experts over "model") on (1, 2): streams
  equal to the unsharded engine's; at a drop-free copy of the config
  (where a row's output no longer depends on its batch) every stream is
  the reference model's greedy decode — the reference's own MoE engine
  is not an oracle here: in one process its streams change from run to
  run;
* glm4 SMOKE (2 KV heads) on a real (1, 4) mesh: the arena and the
  engine raise the arena rule's ``n_kv_heads`` error; on (1, 2) a family
  that does not live on the host raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_scenarios as S
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.core import config_graph as CGJ
from repro.models import registry as RJ
from repro.serving import engine as ENGJ
from repro.train.checkpoint import _flatten
from repro_torch.launch import ranks

TP_TOL = 1e-5
COUNTERS = ("served", "tokens", "decode_steps", "prefill_chunks",
            "prefix_hit_tokens", "preemptions", "decode_dispatches",
            "host_syncs", "h2d_transfers")


# the reference's counterparts of S.CFG and S.MOE_CFG
CFGS_J = {"engine": get_smoke_config_j("qwen3-1.7b").with_(
              n_layers=2, dtype=jnp.float32),
          "moe": get_smoke_config_j("qwen3-moe-30b-a3b").with_(n_layers=2)}


@pytest.fixture(scope="module")
def run():
    """(the ranks' results, the port's unsharded engines' sessions, the
    reference's: its unsharded engine's session on the dense config and
    its MoE model's params and drop-free config), all on the reference's
    seeded weights."""
    fams_j = {k: ENGJ.build_engine_family(c, fracs=(1.0,))
              for k, c in CFGS_J.items()}
    flats = {k: _flatten(f[0].params) for k, f in fams_j.items()}
    results = ranks.spawn(S.engine_group, 8, "cpu", args=(flats,),
                          timeout=300)
    whole = {key: S.serve(cfg, None, S.paged_workload(cfg, S.ENGINE_LENS,
                                                      seed=1),
                          S.N_NEW, flat=flats[key], **S.ENGINE_KW)
             for key, cfg in (("engine", S.CFG), ("moe", S.MOE_CFG))}
    eng = ENGJ.RealEngine(fams_j["engine"], **S.ENGINE_KW)
    eng.configure(CGJ.ConfigGraph.from_dict(CFGS_J["engine"].name,
                                            {("x1", 16): 1}))
    stats = eng._serve_prompts(S.paged_workload(S.CFG, S.ENGINE_LENS,
                                                seed=1), n_new=S.N_NEW)
    ref = {"engine": {"outputs": dict(eng.last_outputs), "stats": stats},
           "moe": (fams_j["moe"][0].params, S.drop_free(CFGS_J["moe"]))}
    return results, whole, ref


def _members(results, key):
    got = [r[key] for r in results if key in r]
    return sorted(got, key=lambda r: r["coords"])


def _same_streams(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("d,m", S.ENGINE_MESHES)
def test_sharded_engine_streams_equal_unsharded(run, d, m):
    """Every rank's streams equal the unsharded engine's, with equal
    prefix-hit tokens (> 0) and counters; every rank reports rank 0's
    stats, its collectives counted."""
    results, whole, _ = run
    parts = _members(results, ("engine", d, m))
    assert len(parts) == d * m
    want = whole["engine"]
    for p in parts:
        _same_streams(p["outputs"], want["outputs"])
        for key in COUNTERS:
            assert p["stats"][key] == want["stats"][key], key
        assert p["stats"]["prefix_hit_tokens"] > 0
        assert p["stats"] == parts[0]["stats"]
    assert parts[0]["stats"]["collective_calls"] > 0
    assert "collective_calls" not in want["stats"]


@pytest.mark.parametrize("d,m", S.ENGINE_MESHES)
def test_sharded_engine_streams_equal_reference(run, d, m):
    """Every rank's streams equal the reference's unsharded engine's on
    the same weights, with its prefix-hit tokens (> 0)."""
    results, _, ref = run
    parts = _members(results, ("engine", d, m))
    assert len(parts) == d * m
    want = ref["engine"]
    for p in parts:
        _same_streams(p["outputs"], want["outputs"])
        assert p["stats"]["prefix_hit_tokens"] == \
            want["stats"]["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("d,m", S.ENGINE_MESHES)
def test_sharded_arena_is_the_unsharded_head_slice(run, d, m):
    """Each rank's arena holds its K/m KV heads of the unsharded arena
    (within 1e-5), and the data replicas of one model coordinate hold
    bit-equal arenas."""
    results, whole, _ = run
    parts = _members(results, ("engine", d, m))
    (_, k_all, v_all), = whole["engine"]["arenas"]
    K = k_all.shape[3]
    kl = K // m
    by_model = {}
    for p in parts:
        (_, k, v), = p["arenas"]
        j = p["coords"][1]
        assert k.shape == k_all.shape[:3] + (kl,) + k_all.shape[4:]
        np.testing.assert_allclose(k, k_all[:, :, :, j * kl:(j + 1) * kl],
                                   rtol=TP_TOL, atol=TP_TOL)
        np.testing.assert_allclose(v, v_all[:, :, :, j * kl:(j + 1) * kl],
                                   rtol=TP_TOL, atol=TP_TOL)
        by_model.setdefault(j, []).append((k, v))
    assert len(by_model) == m
    for replicas in by_model.values():
        assert len(replicas) == d
        for k, v in replicas[1:]:
            np.testing.assert_array_equal(k, replicas[0][0])
            np.testing.assert_array_equal(v, replicas[0][1])


def test_sharded_moe_engine_streams_equal_unsharded(run):
    """qwen3-moe SMOKE on (1, 2), its 8 experts 4 a rank: the streams and
    prefix hits of the unsharded engine."""
    results, whole, _ = run
    parts = _members(results, ("moe", 1, 2))
    assert len(parts) == 2
    for p in parts:
        _same_streams(p["outputs"], whole["moe"]["outputs"])
        assert p["stats"]["prefix_hit_tokens"] == \
            whole["moe"]["stats"]["prefix_hit_tokens"] > 0


def test_sharded_moe_engine_at_drop_free_capacity_is_reference_greedy(run):
    """qwen3-moe SMOKE on (1, 2) at a drop-free copy of its config: every
    rank's stream is the reference model's greedy decode on the same
    weights (each token the argmax of the reference's forward over the
    prompt and the tokens before it; one forward over every request,
    zero-padded: with nothing dropped, the padding changes no earlier
    position)."""
    results, _, ref = run
    p_j, cfg_j = ref["moe"]
    parts = _members(results, ("moe drop-free", 1, 2))
    assert len(parts) == 2
    prompts = S.paged_workload(S.MOE_CFG, S.ENGINE_LENS, seed=1)
    outs = parts[0]["outputs"]
    seqs = np.zeros((len(prompts), 48), np.int32)
    for rid, prompt in enumerate(prompts):
        assert len(outs[rid]) == S.N_NEW
        seqs[rid, :len(prompt) + S.N_NEW] = np.concatenate([prompt,
                                                            outs[rid]])
    lg = np.asarray(RJ.forward(p_j, {"tokens": jnp.asarray(seqs)},
                               cfg_j)[0])
    for p in parts:
        assert p["stats"]["prefix_hit_tokens"] > 0
        for rid, prompt in enumerate(prompts):
            n = len(prompt)
            np.testing.assert_array_equal(
                p["outputs"][rid], lg[rid, n - 1:n - 1 + S.N_NEW].argmax(-1))


def test_rank_mesh_engine_takes_its_family_from_the_host(run):
    """On a rank mesh the whole weights stay on the host and each rank
    copies its shard to its device: a family elsewhere (here on meta)
    raises before anything is placed."""
    errors = [r[("family off the host", 1, 2)] for r in run[0]
              if ("family off the host", 1, 2) in r]
    assert len(errors) == 2
    for err in errors:
        assert err is not None and "on the CPU" in err and "meta" in err


def test_glm4_arena_on_a_real_model_axis_of_4_raises(run):
    """glm4 SMOKE's 2 KV heads on a (1, 4) rank mesh: the arena and the
    engine both raise the arena rule's error, naming ``n_kv_heads``."""
    errors = [r[("glm4", 1, 4)] for r in run[0] if ("glm4", 1, 4) in r]
    assert len(errors) == 4
    for arena_err, engine_err in errors:
        assert arena_err is not None and "n_kv_heads" in arena_err
        assert engine_err is not None and "n_kv_heads" in engine_err
