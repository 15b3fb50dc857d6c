"""Training across devices on a CPU process group of 8 gloo ranks
(``launch/ranks.py``; the rank side is ``tests/torch_tp_train_scenarios.py``
``train_group``, run once for the file), against the reference and the
port's unsharded step:

* ``make_ddp_train_step`` on 8 data ranks, the reference's qwen2-0.5b
  tiny config and batch (``tests/multidev_scenarios.py:40-70``): in f32
  the loss, the averaged gradients and the parameters after the step
  against the reference's single-device step on the whole batch (its
  ``lm_loss`` gradients and ``adamw_update``, as ``make_train_step``
  takes them); bf16 and int8 within the scenario's contract of the f32 step
  (loss 1e-2, parameters rtol 0.1 / atol 2e-3);
* ``ErrorFeedback`` on 2 ranks against its single-process emulation;
* checkpoints (``:73-98``): qwen3-1.7b SMOKE saved from a (2, 4) mesh,
  restored onto an (8,) "model" mesh and onto one device, bit-equal —
  its initial weights, and its parameters and ZeRO-1 moments after a
  step;
* tensor-parallel training of qwen3-1.7b SMOKE f32 on the reference's
  (2, 2, 2) ("pod", "data", "model") mesh through ``steps.build_train``
  (``:101-126``): the loss against the reference's ``lm_loss`` within
  5e-4 relative; the loss, every gradient and the parameters after two
  steps against the port's unsharded step on the same weights; ZeRO-1 on
  and off and ``seq_parallel`` giving equal parameters; every data
  replica's parameters bit-equal after each step; the step with 2
  microbatches of each replica's rows likewise;
* the vocab-parallel loss with planted near-ties on a (1, 3) mesh, whose
  last slice of the 256 ids holds 2 columns of shard padding.

Tolerances: losses 1e-5 relative against the port (the mesh adds its
sums in another order), gradients rtol 1e-4 / atol 1e-6; parameters
after a step as the port's step tests (``tests/test_torch_train_optim.py``:
rtol 2e-4, atol 2e-5, or 2 ``lr`` where a gradient is near zero, for
fewer than 1% of the elements)."""
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_train_scenarios as S
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train import data as DJ
from repro.train import optimizer as OJ
from repro.train import train_loop as TLJ
from repro.train.checkpoint import _flatten
from repro_torch.launch import mesh as MESH
from repro_torch.launch import ranks
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.sharding import rules
from repro_torch.train import checkpoint as CK
from repro_torch.train import train_loop as TL

LOSS_TOL = 1e-5
GRAD_TOL = (1e-4, 1e-6)
REF_LOSS_TOL = 5e-4


def _ef_grads(steps: int = 3, ranks: int = 2) -> list:
    rng = np.random.default_rng(9)
    return [{"a": (rng.standard_normal((ranks, 5, 7)) * 3).astype(np.float32),
             "b": (rng.standard_normal((ranks, 11)) * 1e-3).astype(
                 np.float32)} for _ in range(steps)]


def _xent_inputs():
    """Hidden states (2, 8, 16), a head (16, 256) and labels whose logits
    hold near-ties across and inside the (1, 3) mesh's vocab slices."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((16, 256))).astype(np.float32)
    # columns equal up to one rounding: 3 and 200 (slices 0 and 2), 90
    # and 91 (inside slice 1), 85 and 86 (across the first boundary)
    for a, b in ((3, 200), (90, 91), (85, 86)):
        w[:, b] = w[:, a] * np.float32(1 + 2 ** -20)
        w[:, a] *= 4.0
        w[:, b] *= 4.0
    labels = rng.integers(0, 256, size=(2, 8))
    labels[0, :3] = (3, 200, 255)
    return x, w, labels


@pytest.fixture(scope="module")
def run():
    """The ranks' results and the reference's and the unsharded port's
    numbers; the checkpoints' directory is removed after the file's
    tests."""
    ref = {}
    # DDP: the reference's single-device step on the whole batch
    # (jitted, as the reference runs them: one compilation each, not an
    # eager dispatch an operation)
    init = jax.jit(RJ.init_params, static_argnums=1)
    cfg_d = get_smoke_config_j("qwen2-0.5b").with_(dtype=jnp.float32,
                                                   **S.DDP_TINY)
    p_d = init(jax.random.PRNGKey(0), cfg_d)
    b_d = DJ.SyntheticLM(DJ.DataConfig(cfg_d.vocab_size, 16, 16)).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in b_d.items()}
    opt_j = OJ.AdamWConfig(lr=1e-3)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: TLJ.lm_loss(p, jb, cfg_d), has_aux=True))(p_d)
    # make_train_step's update of these gradients (its own arithmetic)
    p_1 = jax.jit(lambda g, p: OJ.adamw_update(
        opt_j, g, OJ.init_opt_state(p), p)[0])(g, p_d)
    ref["ddp"] = (float(loss), _flatten(g), _flatten(p_1))
    # qwen3 SMOKE: the reference's weights, batches and loss
    cfg_q = get_smoke_config_j("qwen3-1.7b").with_(dtype=jnp.float32)
    p_q = init(jax.random.PRNGKey(0), cfg_q)
    ds = DJ.SyntheticLM(DJ.DataConfig(cfg_q.vocab_size, 32, 8))
    batches = [ds.batch_at(i) for i in range(2)]
    ref["qwen3_loss"] = float(jax.jit(lambda p, b: TLJ.lm_loss(
        p, b, cfg_q)[0])(p_q, {k: jnp.asarray(v)
                               for k, v in batches[0].items()}))
    x, w, labels = _xent_inputs()
    inputs = {"ddp_params": _flatten(p_d), "ddp_batch": b_d,
              "ef_grads": _ef_grads(), "qwen3": _flatten(p_q),
              "tp_batches": batches, "xent_x": x, "xent_w": w,
              "xent_labels": labels}
    d = tempfile.mkdtemp(prefix="tp_ckpt_")
    results = ranks.spawn(S.train_group, 8, "cpu", args=(inputs, d),
                          timeout=300)
    # the port's unsharded qwen3 steps on the same weights
    model = S.load(S.QWEN3, inputs["qwen3"])
    state = TL.make_train_state(model, S.OPT)
    loss, _ = TL.lm_loss(model, S.to_batch(batches[0]), S.QWEN3)
    grads = {n: g.numpy() for n, g in TL._grads(model, loss).items()}
    whole = {"loss0": float(loss.detach()), "grads": grads, "loss": [],
             "params": []}
    step = TL.make_train_step(S.QWEN3, S.OPT)
    for b in batches:
        state, m = step(state, S.to_batch(b))
        whole["loss"].append(float(m["loss"]))
        whole["params"].append({n: p.detach().numpy().copy()
                                for n, p in model.named_parameters()})
    yield results, ref, whole, inputs, d
    shutil.rmtree(d, ignore_errors=True)


def _close_params(got: dict, want: dict, lr: float) -> None:
    """Parameters after a step: within rtol 2e-4 / atol 2e-5 but for
    fewer than 1% of the elements, which stay within 2 ``lr`` (an update
    of a near-zero gradient)."""
    n = off = 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=2 * lr,
                                   err_msg=k)
        n += v.size
        off += int((np.abs(got[k] - v) > 2e-5 + 2e-4 * np.abs(v)).sum())
    assert off < 0.01 * n, (off, n)


# ---------------------------------------------------------------------------
# DDP on 8 ranks
# ---------------------------------------------------------------------------
def test_ddp_f32_matches_reference_single_device(run):
    """f32 DDP on 8 ranks: the group's loss and averaged gradients are the
    reference's on the whole batch, and the parameters after the step
    its single-device step's."""
    results, ref = run[0], run[1]
    loss_r, grads_r, params_r = ref["ddp"]
    for r in results:
        loss, _, params = r["ddp"][None]
        assert loss == pytest.approx(loss_r, rel=LOSS_TOL)
        for k, v in grads_r.items():
            np.testing.assert_allclose(r["ddp"]["grads"][k], v,
                                       rtol=GRAD_TOL[0], atol=GRAD_TOL[1],
                                       err_msg=k)
        _close_params(params, params_r, 1e-3)


@pytest.mark.parametrize("comp", ["bf16", "int8"])
def test_ddp_compressed_holds_the_contract(run, comp):
    """bf16 and int8 DDP on 8 ranks track the f32 step after one step:
    the scenario's contract (``multidev_scenarios.py:63-66``), against the
    port's f32 DDP and the reference's single-device step."""
    results, ref = run[0], run[1]
    for r in results:
        loss, _, params = r["ddp"][comp]
        for want_loss, want in ((r["ddp"][None][0], r["ddp"][None][2]),
                                (ref["ddp"][0], ref["ddp"][2])):
            assert abs(loss - want_loss) < 1e-2
            for k, v in want.items():
                np.testing.assert_allclose(params[k], v, rtol=0.1,
                                           atol=2e-3, err_msg=k)
    # every rank took the same update
    for r in results[1:]:
        for k, v in results[0]["ddp"][comp][2].items():
            np.testing.assert_array_equal(r["ddp"][comp][2][k], v)


def test_error_feedback_on_two_ranks_matches_emulation(run):
    """Three int8 steps with error feedback on 2 ranks: each rank's mean
    and residual equal a single-process emulation of the two ranks (the
    scale the larger of theirs, the int8 sums, the quantisation error
    carried)."""
    results, inputs = run[0], run[3]
    res = [{k: np.zeros(v.shape[1:], np.float32) for k, v in
            inputs["ef_grads"][0].items()} for _ in range(2)]
    for step, g in enumerate(inputs["ef_grads"]):
        mean, new_res = {}, [{}, {}]
        for k, v in g.items():
            gf = [v[r] + res[r][k] for r in range(2)]
            scale = np.float32(max(max(np.abs(x).max() for x in gf),
                                   np.float32(1e-12)) / np.float32(127.0))
            q = [np.clip(np.round(x / scale), -127, 127) for x in gf]
            mean[k] = (q[0] + q[1]).astype(np.float32) * scale / np.float32(2)
            for r in range(2):
                new_res[r][k] = gf[r] - q[r] * scale
        res = new_res
        for r in range(2):
            got_mean, got_res = results[r]["ef"][step]
            for k in g:
                np.testing.assert_allclose(got_mean[k], mean[k], rtol=1e-6,
                                           atol=1e-9, err_msg=k)
                np.testing.assert_allclose(got_res[k], res[r][k],
                                           rtol=1e-6, atol=1e-9, err_msg=k)
    assert any(np.abs(v).max() > 0 for v in res[0].values())


# ---------------------------------------------------------------------------
# elastic checkpoints
# ---------------------------------------------------------------------------
def _file(d: str, tag: str, step: int) -> dict:
    with np.load(f"{d}/{tag}/step_{step:08d}/arrays.npz") as f:
        return {k: f[k] for k in f.files}


def _shards(whole: dict, cfg, mesh_sizes, names, coords, zero=None):
    """Each parameter's part on the rank at ``coords`` of an abstract mesh
    of ``mesh_sizes``: ``rules.local_shard`` under the mesh's specs."""
    mesh = MESH.Mesh(mesh_sizes, names)
    mesh.coords = coords
    meta = R.init_params(cfg, device="meta")
    specs = rules.param_specs(meta, cfg, mesh)
    out = {}
    for n, t in whole.items():
        spec = specs[n][1:] if len(specs[n]) == t.dim() + 1 else specs[n]
        out[n] = rules.local_shard(t, spec, mesh).numpy()
    return out


def test_checkpoint_from_2x4_restores_bit_equal(run):
    """The initial weights saved from (2, 4) are the reference's whole
    tensors bit for bit, on one device and as every (8,) "model" rank's
    shard; after a ZeRO-1 step the file's parameters and moments cut
    again under (2, 4) are what each rank held, and restored onto (8,)
    they are each rank's part of the file."""
    results, inputs, d = run[0], run[3], run[4]
    init = _file(d, "init", 1)
    for k, v in inputs["qwen3"].items():
        np.testing.assert_array_equal(init[f"params/{k}"], v, err_msg=k)
    assert not any(k.startswith("opt/") for k in init)
    cfg = S.QWEN3
    one = R.init_params(cfg, seed=5, device="cpu")
    CK.restore(f"{d}/init", {"params": one})
    for k, v in bridge.export_reference(one).items():
        np.testing.assert_array_equal(v, inputs["qwen3"][k], err_msg=k)
    trained = _file(d, "trained", 2)
    layout = R.init_params(cfg, device="meta")
    for part in ("params", "m"):
        whole = bridge.from_reference(layout, {
            k[len(part) + 1 if part == "params" else 6:]: v
            for k, v in trained.items()
            if k.startswith("params/" if part == "params" else "opt/m/")})
        for r in results:
            ck = r["ckpt"]
            mine = _shards(whole, cfg, (2, 4), ("data", "model"),
                           ck["saved"]["coords"])
            back = _shards(whole, cfg, (8,), ("model",), ck["coords_b"])
            for n, v in ck["saved"][part].items():
                want = mine[n]
                if part == "m" and v.shape != want.shape:   # a ZeRO slice
                    dim = [i for i, (a, b) in enumerate(zip(v.shape,
                                                            want.shape))
                           if a != b]
                    if v.size == 0:
                        continue
                    lo = ck["saved"]["coords"][0] * v.shape[dim[0]]
                    want = np.take(want, range(lo, lo + v.shape[dim[0]]),
                                   axis=dim[0])
                np.testing.assert_array_equal(v, want, err_msg=n)
            for n, v in ck["restored"]["trained"][part].items():
                np.testing.assert_array_equal(v, back[n], err_msg=n)
            for n, v in ck["restored"]["init"]["params"].items():
                np.testing.assert_array_equal(v, _shards(
                    bridge.from_reference(layout, inputs["qwen3"]), cfg,
                    (8,), ("model",), ck["coords_b"])[n], err_msg=n)
            assert ck["restored"]["trained"]["step"] == 1


def test_zero1_moments_are_cut_over_data(run):
    """On (2, 4) ZeRO-1 keeps a data shard's slice of the moments: some
    are half of the rank's parameter shard, and the (8,) restore, which
    has no data axis, holds them whole."""
    ck = run[0][0]["ckpt"]
    halves = [n for n, v in ck["saved"]["m"].items()
              if v.size * 2 == ck["saved"]["params"][n].size]
    assert halves
    for n, v in ck["restored"]["trained"]["m"].items():
        assert v.shape == ck["restored"]["trained"]["params"][n].shape


# ---------------------------------------------------------------------------
# tensor-parallel training on (2, 2, 2)
# ---------------------------------------------------------------------------
def _tp(results, zero1: bool, sp: bool):
    return [r[("tp", zero1, sp)] for r in results]


def test_tp_loss_matches_reference_lm_loss(run):
    """The (2, 2, 2) step's first loss is the reference's ``lm_loss`` on
    the whole batch within 5e-4 relative (the scenario's contract)."""
    results, ref = run[0], run[1]
    for r in _tp(results, *S.TP_SETTINGS[0]):
        assert abs(r["loss"][0] - ref["qwen3_loss"]) / ref["qwen3_loss"] \
            < REF_LOSS_TOL


def test_tp_loss_and_gradients_match_unsharded(run):
    """The loss and every gradient of the (2, 2, 2) mesh, gathered whole,
    are the port's unsharded ones on the same weights and batch."""
    results, whole = run[0], run[2]
    for r in _tp(results, *S.TP_SETTINGS[0]):
        loss, grads = r["grads"]
        assert loss == pytest.approx(whole["loss0"], rel=LOSS_TOL)
        assert set(grads) == set(whole["grads"])
        for n, g in whole["grads"].items():
            np.testing.assert_allclose(grads[n], g, rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1], err_msg=n)


@pytest.mark.parametrize("setting", S.TP_SETTINGS)
def test_tp_steps_match_unsharded(run, setting):
    """Two steps on (2, 2, 2) — ZeRO-1 on or off, ``seq_parallel`` or
    not — give the unsharded steps' losses and parameters."""
    results, whole = run[0], run[2]
    for r in _tp(results, *setting):
        for i in range(2):
            assert r["loss"][i] == pytest.approx(whole["loss"][i],
                                                 rel=LOSS_TOL)
            _close_params(r["params"][i], whole["params"][i], S.OPT.lr)


def test_grad_accumulation_on_a_mesh(run):
    """``build_train`` with 2 microbatches of each data replica's 2 rows
    on (2, 2, 2): the losses and parameters of the unsharded steps on the
    whole batch (the mean of the microbatches' means is the batch's)."""
    results, whole = run[0], run[2]
    for r in results:
        p = r["tp_accum"]
        for i in range(2):
            assert p["loss"][i] == pytest.approx(whole["loss"][i],
                                                 rel=LOSS_TOL)
            _close_params(p["params"][i], whole["params"][i], S.OPT.lr)


def test_zero1_and_seq_parallel_change_no_parameter(run):
    """ZeRO-1 on and off give equal parameters after each step (the same
    arithmetic on slices), and the sequence-parallel step the
    non-sequence-parallel one's within the step tolerance."""
    results = run[0]
    base = _tp(results, True, False)[0]
    for i in range(2):
        for n, v in base["params"][i].items():
            np.testing.assert_array_equal(
                _tp(results, False, False)[0]["params"][i][n], v)
        _close_params(_tp(results, True, True)[0]["params"][i],
                      base["params"][i], S.OPT.lr)


@pytest.mark.parametrize("setting", S.TP_SETTINGS)
def test_data_replicas_stay_bit_equal(run, setting):
    """After each step every rank holding the same model shard (the 4
    data replicas of each "model" coordinate) holds the same bits."""
    for i in range(2):
        by_model = {}
        for r in _tp(run[0], *setting):
            by_model.setdefault(r["coords"][-1], set()).add(r["digest"][i])
        assert len(by_model) == 2
        assert all(len(v) == 1 for v in by_model.values()), by_model


def test_zero1_moments_live_on_data_slices(run):
    """With ZeRO-1 on (2, 2, 2) some moments are a quarter of the rank's
    parameter shard (cut over ("pod", "data")); without it none is."""
    r_on = _tp(run[0], True, False)[0]
    r_off = _tp(run[0], False, False)[0]
    assert r_on["moments"] != r_off["moments"]
    model = S.load(S.QWEN3, run[3]["qwen3"])
    local_sizes = {n: int(np.prod(s)) for n, s in r_off["moments"].items()}
    quarter = [n for n, s in r_on["moments"].items()
               if 4 * int(np.prod(s)) == local_sizes[n]]
    assert quarter and len(local_sizes) == len(list(model.parameters()))


# ---------------------------------------------------------------------------
# the vocab-parallel loss
# ---------------------------------------------------------------------------
def test_vocab_parallel_loss_with_near_ties(run):
    """``chunked_xent`` over the (1, 3) mesh's slices of the head — near
    ties across and inside them, labels in every slice, 2 padding columns
    in the last — gives the unsharded loss and gradients: the padding
    left out of the log-sum-exp, the padded vocab's own columns in."""
    results, inputs = run[0], run[3]
    x = torch.as_tensor(inputs["xent_x"]).requires_grad_(True)
    w = torch.as_tensor(inputs["xent_w"]).requires_grad_(True)
    loss = TL.chunked_xent(x, w, torch.as_tensor(inputs["xent_labels"]),
                           256, chunk=4)
    gx, gw = torch.autograd.grad(loss, (x, w))
    parts = sorted((r["xent"] for r in results if r["xent"]),
                   key=lambda p: p["coords"])
    assert len(parts) == S.XENT_M
    gw_cat = np.concatenate([p["gw"] for p in parts], -1)
    assert gw_cat.shape[-1] == 258
    np.testing.assert_array_equal(gw_cat[:, 256:], 0)
    for p in parts:
        assert p["loss"] == pytest.approx(float(loss.detach()), rel=1e-6)
        np.testing.assert_allclose(p["gx"], gx.numpy(), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(gw_cat[:, :256], gw.numpy(), rtol=1e-5,
                               atol=1e-7)
