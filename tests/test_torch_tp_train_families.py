"""Training across devices for every family, on a CPU process group of 4
gloo ranks (``launch/ranks.py``; the rank side is
``tests/torch_tp_train_scenarios.py`` ``families_group``, run once for
the file): the SMOKE configs through ``steps.build_train`` with ZeRO-1,
two steps each, on the reference's weights (``models/bridge.py``), held
to the reference's ``lm_loss`` and its ``jax.grad`` on the whole batch
and to the port's unsharded step on the same weights:

* MoE: qwen3-moe-30b-a3b (8 experts over "model") on (1, 2), and on
  (2, 2), where each data replica routes its rows with the global
  batch's groups and load-balance statistics (8 rows of 16: a replica's
  64 tokens are one routing group); qwen2-moe-a2.7b on (1, 4) (6 experts
  and 2 shared, which 4 does not divide: each expert's FF width is cut);
* mamba2-2.7b (every Mamba2 block cut by head; ``wB`` / ``wC`` whole,
  the gate norm over the whole ``d_inner``) and zamba2-2.7b (its blocks
  and the shared attention and MLP cut) on (1, 2);
* seamless-m4t-large-v2 (encoder, decoder and cross-attention cut) on
  (1, 2);
* qwen2-vl-7b's forward on (1, 2) (M-RoPE), against the unsharded port's
  and the reference's logits;
* qwen3-moe on (2, 2) given 4 rows of 16, whose routing group of 64
  tokens would span both replicas' rows: the step refuses.

Tolerances: against the reference, the loss 5e-4 relative (the contract
of ``tests/multidev_scenarios.py:101-126``) and each gradient within
1e-4 of its leaf's largest magnitude (``tests/test_torch_train_families.
py``); against the port, as ``tests/test_torch_tp_train.py``'s: losses
1e-5 relative, gradients rtol 1e-4 / atol 1e-6, parameters rtol 2e-4 /
atol 2e-5 (2 ``lr`` for fewer than 1% of the elements); the VLM's
logits 1e-5 against the port, 2e-4 against the reference
(``tests/test_torch_model.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_train_scenarios as S
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train import train_loop as TLJ
from repro.train.checkpoint import _flatten
from repro_torch.launch import ranks
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.train import train_loop as TL

TRAIN = [key for key, _, _, fwd in S.FAMILIES if not fwd]
ARCH = {key: arch for key, arch, _, _ in S.FAMILIES}
MESH = {key: mesh for key, _, mesh, _ in S.FAMILIES}
GRAD_TOL = (1e-4, 1e-6)
REF_LOSS_TOL = 5e-4
REF_GRAD_TOL = 1e-4


def _batch(cfg, seed: int, rows: int = 4) -> dict:
    """(rows, 16) tokens and labels (16: a multiple of the SSM families'
    chunk of 8), and an enc-dec's (rows, 8, d) source frames."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, size=(rows, 17))
    out = {"tokens": t[:, :-1].astype(np.int64),
           "labels": t[:, 1:].astype(np.int64)}
    if cfg.n_enc_layers:
        out["src_embeds"] = rng.standard_normal(
            (rows, 8, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        out["mrope_positions"] = np.broadcast_to(
            np.arange(16)[None, None], (3, rows, 16)).astype(np.int64).copy()
    return out


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def run():
    """The ranks' results, and for each scenario the reference's loss and
    gradients (or logits) and the unsharded port's numbers."""
    init = jax.jit(RJ.init_params, static_argnums=1)
    params, batches, ref, whole = {}, {}, {}, {}
    for i, (key, arch, mesh, fwd) in enumerate(S.FAMILIES):
        cfg = S.family_cfg(arch)
        cfg_j = get_smoke_config_j(arch).with_(dtype=jnp.float32)
        batches[key] = [_batch(cfg, 10 * i + k, 4 * mesh[0])
                        for k in range(2)]
        p_j = init(jax.random.PRNGKey(i), cfg_j)
        params[key] = _flatten(p_j)
        b = _jax(batches[key][0])
        if fwd:
            lg = jax.jit(lambda p, b, c=cfg_j: RJ.forward(p, b, c)[0])(
                p_j, {k: v for k, v in b.items() if k != "labels"})
            ref[key] = np.asarray(lg)
            continue
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b, c=cfg_j: TLJ.lm_loss(p, b, c), has_aux=True))(
                p_j, b)
        ref[key] = (float(loss), _flatten(g))
    spanning = _batch(S.family_cfg("qwen3-moe-30b-a3b"), 99)
    results = ranks.spawn(S.families_group, 4, "cpu",
                          args=({"params": params, "batches": batches,
                                 "spanning": spanning},),
                          timeout=300)
    for key, arch, _, fwd in S.FAMILIES:
        cfg = S.family_cfg(arch)
        model = S.load(cfg, params[key])
        if fwd:
            lg, _ = R.forward(model, S.to_batch(batches[key][0]), cfg)
            whole[key] = {"logits": lg.numpy()}
            continue
        state = TL.make_train_state(model, S.OPT)
        loss, _ = TL.lm_loss(model, S.to_batch(batches[key][0]), cfg)
        out = {"loss0": float(loss.detach()), "loss": [], "params": [],
               "grads": {n: g.numpy() for n, g in
                         TL._grads(model, loss).items()}}
        step = TL.make_train_step(cfg, S.OPT)
        for b in batches[key]:
            state, m = step(state, S.to_batch(b))
            out["loss"].append(float(m["loss"]))
            out["params"].append({n: p.detach().numpy().copy()
                                  for n, p in model.named_parameters()})
        whole[key] = out
    return results, ref, whole, params


def _parts(results, key: str) -> list:
    return sorted((r[key] for r in results if key in r),
                  key=lambda p: p["coords"])


def _close_params(got: dict, want: dict, lr: float) -> None:
    n = off = 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2 * lr,
                                   err_msg=k)
        n += v.size
        off += int((np.abs(got[k] - v) > 2e-5 + 2e-4 * np.abs(v)).sum())
    assert off < 0.01 * n, (off, n)


@pytest.mark.parametrize("arch", TRAIN)
def test_family_loss_and_gradients_match_unsharded(run, arch):
    """The first batch's loss and every gradient, reduced over the mesh
    and gathered whole, are the unsharded port's."""
    results, _, whole, _ = run
    parts = _parts(results, arch)
    assert len(parts) == int(np.prod(MESH[arch]))
    for p in parts:
        loss, grads = p["grads"]
        assert loss == pytest.approx(whole[arch]["loss0"], rel=1e-5)
        assert set(grads) == set(whole[arch]["grads"])
        for n, g in whole[arch]["grads"].items():
            np.testing.assert_allclose(grads[n], g, rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1], err_msg=n)


@pytest.mark.parametrize("arch", TRAIN)
def test_family_loss_and_gradients_match_reference(run, arch):
    """The sharded first-batch loss is the reference's ``lm_loss`` on the
    whole batch within 5e-4 relative, and the reduced whole gradients,
    in the reference's layout, its ``jax.grad`` within 1e-4 of each
    leaf's largest magnitude."""
    results, ref, _, params = run
    want_loss, want = ref[arch]
    model = S.load(S.family_cfg(ARCH[arch]), params[arch])
    for p in _parts(results, arch):
        loss, grads = p["grads"]
        assert loss == pytest.approx(want_loss, rel=REF_LOSS_TOL)
        assert p["loss"][0] == pytest.approx(want_loss, rel=REF_LOSS_TOL)
        got = bridge.to_reference(model, {n: torch.as_tensor(g)
                                          for n, g in grads.items()})
        assert set(got) == set(want)
        for k, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[k] / scale, w / scale, rtol=0,
                                       atol=REF_GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("arch", TRAIN)
def test_family_steps_match_unsharded(run, arch):
    """Two ``build_train`` steps on the mesh: the losses and the
    parameters after each are the unsharded steps', and the ranks agree
    on the whole parameters."""
    results, _, whole, _ = run
    parts = _parts(results, arch)
    for p in parts:
        for i in range(2):
            assert p["loss"][i] == pytest.approx(whole[arch]["loss"][i],
                                                 rel=1e-5)
            _close_params(p["params"][i], whole[arch]["params"][i],
                          S.OPT.lr)
    for p in parts[1:]:
        for n, v in parts[0]["params"][-1].items():
            np.testing.assert_array_equal(p["params"][-1][n], v)


def test_moe_data_replicas_stay_equal(run):
    """qwen3-moe on (2, 2): after each step the two data replicas' shards
    of the same "model" coordinate are bit-equal, and the ZeRO-1 moments
    are cut over "data"."""
    parts = _parts(run[0], "qwen3-moe-30b-a3b-2x2")
    by_model = {}
    for p in parts:
        by_model.setdefault(p["coords"][1], []).append(p)
    for pair in by_model.values():
        assert len(pair) == 2
        assert pair[0]["digest"] == pair[1]["digest"]
    for p in parts:
        held = sum(int(np.prod(s)) for s in p["moments"].values())
        assert held < p["shard_numel"], (held, p["shard_numel"])


def test_moe_group_spanning_replicas_is_refused(run):
    """A routing group that would span two data replicas' rows (4 rows of
    16 on (2, 2): 32 tokens a replica, a group of 64) is refused on every
    rank, not routed apart."""
    for r in run[0]:
        assert "spans the rows of 2 data replicas" in r["spanning"]


def test_vlm_forward_on_a_mesh(run):
    """qwen2-vl SMOKE's forward with M-RoPE positions on (1, 2): the
    ranks' vocab slices side by side are the unsharded port's logits and
    the reference's."""
    results, ref, whole, _ = run
    parts = _parts(results, "qwen2-vl-7b")
    assert len(parts) == 2
    lg = np.concatenate([p["logits"] for p in parts], -1)
    np.testing.assert_allclose(lg, whole["qwen2-vl-7b"]["logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lg, ref["qwen2-vl-7b"], rtol=2e-4,
                               atol=2e-4)
