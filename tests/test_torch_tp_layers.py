"""The port's tensor-parallel modules on a CPU process group of 4 gloo
ranks (``launch/ranks.py``; the rank side is
``tests/torch_tp_scenarios.py`` ``layers_group``, run once for the file):

* qwen3-1.7b SMOKE (2 layers, f32, the reference's weights through
  ``models/bridge.py``) cut by ``registry.shard_params`` on (1, 2) and
  (1, 4) meshes — at m = 4 the 2 KV heads do not divide, so the KV
  projections stay whole and each rank keeps the head its queries read —
  layer 0's attention (column-parallel q/k/v, row-parallel wo and its
  all-reduce), its MLP, the vocab-parallel embedding, the readout's vocab
  slices and their greedy pick, and the whole forward;
* ``layers.greedy_token`` on planted ties across and inside the vocab
  slices of (1, 2), (1, 3) and (1, 4) meshes (at m = 3 the 256-id vocab
  pads to 3 x 86 and the padding rows read -inf);
* ``moe_apply`` with the experts over "model" (qwen3-moe SMOKE, 8 experts,
  m = 2 and 4; qwen2-moe SMOKE, 6 experts and 2 shared, m = 2) and with
  each expert's FF width over "model" (qwen3-moe SMOKE with
  ``d_expert_ff`` 48 at m = 3, which does not divide 8 experts; qwen2-moe
  SMOKE at m = 4), on a prefill that drops pairs and a decode step;
* the meshes' errors inside the group, the backend rule, and ``spawn``
  raising a failing rank's exception.

Tolerances: each rank's output against the unsharded port on the same
weights at f32 rtol/atol 1e-5 (the row-parallel sums add in another
order; the embedding's masked sum is exact), the forward and the MoE
against the reference at the model tests' 2e-4 (``tests/
test_torch_model.py``), greedy picks equal."""
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_scenarios as S
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import moe as MJ
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.launch import ranks
from repro_torch.models import bridge
from repro_torch.models import registry as R

ROOT = pathlib.Path(__file__).resolve().parents[1]
TP_TOL = 1e-5
REF_TOL = 2e-4
CFG_J = get_smoke_config_j("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
# the reference's MoE, compiled once per shape (eager JAX dispatches each
# op on its own)
MOE_J = jax.jit(MJ.moe_apply, static_argnums=2)


def _moe_params(i: int, arch: str, kw: dict):
    """(reference config, its MoE layer's weights as numpy arrays)."""
    cfg_j = get_smoke_config_j(arch).with_(n_layers=1, dtype=jnp.float32,
                                           **kw)
    p = MJ.init_moe(jax.random.PRNGKey(10 + i), cfg_j)
    flat = {k: np.asarray(p[k], np.float32)
            for k in ("router", "w_gate", "w_up", "w_down")}
    for name in ("wi_gate", "wi_up", "wo"):
        if "shared" in p:
            flat[f"shared/{name}"] = np.asarray(p["shared"][name]["w"],
                                                np.float32)
    return cfg_j, p, flat


@pytest.fixture(scope="module")
def run():
    """The ranks' results, the unsharded port's outputs on the same
    weights and inputs, and the reference's."""
    p_j = RJ.init_params(jax.random.PRNGKey(0), CFG_J)
    flat = _flatten(p_j)
    moe = {name: _moe_params(i, arch, kw)
           for i, (name, arch, kw, _) in enumerate(S.MOE_CASES)}
    results = ranks.spawn(S.layers_group, 4, "cpu",
                          args=(flat, {k: v[2] for k, v in moe.items()}),
                          timeout=300)
    model = R.init_params(S.CFG, device="cpu")
    bridge.load_reference(model, flat)
    tokens, x = S.layer_inputs(S.CFG)
    whole = S.layer_outputs(model, S.CFG, tokens, x)
    ref = {"forward": np.asarray(RJ.forward(
        p_j, {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)}, CFG_J)[0])}
    moe_whole, moe_ref = {}, {}
    for name, arch, kw, _ in S.MOE_CASES:
        cfg_t, m_t = S.moe_model(arch, kw, moe[name][2])
        xs = S.moe_inputs(cfg_t)
        moe_whole[name] = S.moe_outputs(m_t, cfg_t, xs)
        moe_ref[name] = [[np.asarray(t) for t in MOE_J(
            moe[name][1], jnp.asarray(x.numpy()), moe[name][0])] for x in xs]
    return results, whole, ref, moe_whole, moe_ref


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _members(results, key):
    """(coords, result) of every rank that ran scenario ``key``, in
    coordinate order."""
    got = [(r[key]["coords"], r[key]) for r in results if key in r]
    return sorted(got, key=lambda cr: cr[0])


def _vocab_cat(parts, name):
    return np.concatenate([p[name] for _, p in parts], -1)


@pytest.mark.parametrize("m", S.LAYER_MODEL)
@pytest.mark.parametrize("module", ("attention", "mlp"))
def test_row_parallel_module_matches_unsharded(run, m, module):
    """Layer 0's attention / MLP on every rank of (1, m): the all-reduced
    output equals the unsharded module's."""
    results, whole, *_ = run
    parts = _members(results, ("layers", m))
    assert len(parts) == m
    for _, p in parts:
        np.testing.assert_allclose(p[module], whole[module], rtol=TP_TOL,
                                   atol=TP_TOL)


@pytest.mark.parametrize("m", S.LAYER_MODEL)
def test_vocab_parallel_embedding_is_exact(run, m):
    """The masked lookups summed over "model" are the whole table's rows,
    bit for bit."""
    results, whole, *_ = run
    for _, p in _members(results, ("layers", m)):
        np.testing.assert_array_equal(p["embedding"], whole["embedding"])


@pytest.mark.parametrize("m", S.LAYER_MODEL)
def test_readout_slices_and_greedy(run, m):
    """The ranks' readouts, side by side, are the unsharded logits; their
    greedy pick is the unsharded argmax on every rank."""
    results, whole, *_ = run
    parts = _members(results, ("layers", m))
    np.testing.assert_allclose(_vocab_cat(parts, "logits"), whole["logits"],
                               rtol=TP_TOL, atol=TP_TOL)
    for _, p in parts:
        np.testing.assert_array_equal(p["greedy"], whole["greedy"])


@pytest.mark.parametrize("m", S.LAYER_MODEL)
def test_sharded_forward_matches_unsharded_and_reference(run, m):
    """The whole forward on (1, m): logits within 1e-5 of the unsharded
    port's and 2e-4 of the reference's, greedy tokens equal."""
    results, whole, ref, *_ = run
    parts = _members(results, ("layers", m))
    lg = _vocab_cat(parts, "forward")
    np.testing.assert_allclose(lg, whole["forward"], rtol=TP_TOL,
                               atol=TP_TOL)
    np.testing.assert_allclose(lg, ref["forward"], rtol=REF_TOL, atol=REF_TOL)
    for _, p in parts:
        np.testing.assert_array_equal(p["forward_greedy"],
                                      whole["forward_greedy"])
        np.testing.assert_array_equal(p["forward_greedy"],
                                      ref["forward"].argmax(-1))


@pytest.mark.parametrize("m", S.LAYER_MODEL)
def test_training_a_shard_is_refused(run, m):
    """The training forward of a rank's shard — refused until its
    collectives carried gradients — now runs: the ranks' logits side by
    side are the unsharded forward's (its training across devices is
    held in ``tests/test_torch_tp_train*.py``)."""
    results, whole, *_ = run
    parts = _members(results, ("layers", m))
    assert len(parts) == m
    np.testing.assert_allclose(_vocab_cat(parts, "train_forward"),
                               whole["forward"], rtol=TP_TOL, atol=TP_TOL)


@pytest.mark.parametrize("m", (2, 3, 4))
def test_greedy_token_ties_go_to_the_lowest_id(run, m):
    """Planted maxima tied across slices, inside one slice, at the last id
    and over a constant row: every rank picks what ``argmax`` picks on the
    whole row (the lowest id)."""
    results = run[0]
    want = S.tie_logits(S.CFG.padded_vocab).argmax(-1)
    assert list(want[:5]) == [3, 130, 60, 10, S.CFG.padded_vocab - 1]
    parts = _members(results, ("ties", m))
    assert len(parts) == m
    for _, p in parts:
        np.testing.assert_array_equal(p["greedy"], want)


def test_vocab_padding_reads_minus_inf(run):
    """At m = 3 the last slice holds 2 padding rows past the 256-id
    vocab: their logits are -inf, the rest finite."""
    parts = _members(run[0], ("ties", 3))
    last = parts[-1][1]["readout"]
    assert last.shape[-1] == 86
    assert np.isneginf(last[..., -2:]).all()
    assert np.isfinite(last[..., :-2]).all()
    assert all(np.isfinite(p["readout"]).all() for _, p in parts[:-1])


@pytest.mark.parametrize("case", [c[0] for c in S.MOE_CASES])
def test_tensor_parallel_moe(run, case):
    """Every rank's MoE output and aux equal the unsharded port's (1e-5)
    and the reference's (2e-4), on a prefill that drops pairs and a
    decode step; the cut is the rule's: whole experts when the model axis
    divides the expert count, else each expert's FF width."""
    results, _, _, moe_whole, moe_ref = run
    name, arch, kw, m = next(c for c in S.MOE_CASES if c[0] == case)
    parts = _members(results, ("moe", case))
    assert len(parts) == m
    cfg = S.get_smoke_config(arch).with_(**kw)
    E, F = cfg.padded_experts, cfg.d_expert_ff
    for coords, p in parts:
        if E % m == 0:
            assert p["experts"] == (coords[1] * E // m, E // m)
            assert p["w_gate"] == (E // m, cfg.d_model, F)
        else:
            assert p["experts"] == (0, E)
            assert p["w_gate"] == (E, cfg.d_model, F // m)
        for got, whole, ref in zip(p["outputs"], moe_whole[case],
                                   moe_ref[case]):
            for g, w, r in zip(got, whole, ref):
                np.testing.assert_allclose(g, w, rtol=TP_TOL, atol=TP_TOL)
                np.testing.assert_allclose(g, r, rtol=REF_TOL, atol=REF_TOL)


def test_rank_mesh_errors(run):
    """Inside a group of 4 ranks: a mesh of 8 is too large, and a model
    axis of 3 does not divide 4 devices."""
    errors = run[0][0]["mesh_errors"]
    assert len(errors) == 2
    assert "only 4 ranks" in errors[0]
    assert "does not divide" in errors[1]


def test_rank_test_and_slice_meshes(run):
    """``make_test_mesh`` and ``make_slice_mesh`` inside the group are rank
    meshes: (2, 2) over the 4 ranks, and (1, 2) over ranks 0 and 1."""
    for rank, r in enumerate(run[0]):
        assert r["test_mesh"] == (True, (rank // 2, rank % 2),
                                  {"data": 2, "model": 2})
        assert r["slice_mesh"] == (True, (0, rank) if rank < 2 else None,
                                   {"data": 1, "model": 2})


def test_spawn_under_torchrun_runs_this_process_as_its_rank():
    """With torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK and the
    rendezvous address) ``spawn`` starts nothing: this process is rank 0
    of a world of one and runs the function itself."""
    code = ("import torch_tp_scenarios as S\n"
            "from repro_torch.launch import ranks\n"
            "print(ranks.spawn(S.world_of_one, 1, 'cpu'))\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "[[0, 1, 'gloo', True, (0, 0)]]"


def test_backend_rule():
    """NCCL only when each rank owns a GPU; gloo on shared GPUs or the
    CPU."""
    assert ranks.backend_for(4, "cpu") == "gloo"
    assert ranks.backend_for(2, "cuda", n_gpus=1) == "gloo"
    assert ranks.backend_for(2, "cuda", n_gpus=2) == "nccl"
    assert ranks.backend_for(4, "cuda", n_gpus=8) == "nccl"


def test_spawn_raises_a_failing_ranks_error():
    """No fallback: rank 1's exception reaches the caller, with its
    traceback, while rank 0 waits in a barrier that never completes."""
    with pytest.raises(KeyError, match="rank 1 fails") as info:
        ranks.spawn(S.failing_rank, 2, "cpu", timeout=120)
    assert any("in rank 1 of 2" in note
               for note in getattr(info.value, "__notes__", []))
