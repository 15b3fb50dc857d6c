"""Rank scenarios of the port's training and generic decode across
devices (``tests/test_torch_tp_train*.py``, ``tests/test_torch_tp_decode.py``).

Each ``*_group`` function runs on every rank of one CPU process group
(gloo, one thread a rank), started by ``repro_torch.launch.ranks.spawn``
once a test file, and returns a dict of numpy results, one entry a
scenario, for that file's tests to read.  A scenario on a mesh smaller
than the group runs on its ranks 0 .. n-1; the others make the mesh too
(group creation is collective) and leave the entry out.  This module
imports the port only: the reference runs in the test process, which
passes its weights and batches in as numpy arrays.
"""
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.sharding import rules
from repro_torch.train import checkpoint as CK
from repro_torch.train import compression as CP
from repro_torch.train import optimizer as O
from repro_torch.train import parallel as P
from repro_torch.train import train_loop as TL

# tests/multidev_scenarios.py:46-48 (scenario_ddp_compressed_training)
DDP_TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
                d_ff=64, vocab_size=64)
DDP_CFG = get_smoke_config("qwen2-0.5b").with_(dtype=torch.float32,
                                                **DDP_TINY)
QWEN3 = get_smoke_config("qwen3-1.7b").with_(dtype=torch.float32)
OPT = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
DDP_OPT = O.AdamWConfig(lr=1e-3)
# the TP training scenarios' (zero1, seq_parallel) settings
TP_SETTINGS = ((True, False), (False, False), (True, True))
# the families' scenarios: (key, arch, mesh, forward only).  qwen2-moe
# SMOKE's 6 experts do not split over 4 ranks, so each expert's FF width
# is cut; qwen3-moe on (2, 2) routes each data replica's rows with the
# global batch's groups and load-balance statistics
FAMILIES = (("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", (1, 2), False),
            ("qwen3-moe-30b-a3b-2x2", "qwen3-moe-30b-a3b", (2, 2), False),
            ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", (1, 4), False),
            ("mamba2-2.7b", "mamba2-2.7b", (1, 2), False),
            ("zamba2-2.7b", "zamba2-2.7b", (1, 2), False),
            ("seamless-m4t-large-v2", "seamless-m4t-large-v2", (1, 2), False),
            ("qwen2-vl-7b", "qwen2-vl-7b", (1, 2), True))
# the vocab-parallel loss on (1, 3): 256 ids in 3 slices of 86
XENT_M = 3
# the generic decode: glm4 SMOKE (2 KV heads) on (2, 4), batch 2, a
# 64-position cache in 8 segments of 8 (rows 0 .. N_DECODE - 1 fill two)
DECODE_MESH = (2, 4)
DECODE_B, DECODE_S, N_DECODE = 2, 64, 12
DECODE_WINDOW = 8
# the other families' decode on the same mesh, (arch, seq_shard): the
# enc-dec with its self and cross K/V (16 source frames) over ("data",
# "model"), and the hybrid with its shared attention's K/V heads over
# "model" and its SSM states by head
DECODE_FAMILIES = (("seamless-m4t-large-v2", True), ("zamba2-2.7b", False))


def family_cfg(arch: str):
    return get_smoke_config(arch).with_(dtype=torch.float32)


def mesh_of(sizes, names=("data", "model")):
    return MESH.make_mesh(sizes, names[-len(sizes):], device="cpu")


def load(cfg, flat):
    """The port's model of ``cfg`` on the CPU holding the reference's
    weights ``flat`` (numpy, the reference's layout), or when ``flat`` is
    an int the port's own from that seed."""
    if isinstance(flat, int):
        return R.init_params(cfg, seed=flat, device="cpu")
    return bridge.load_reference(R.init_params(cfg, seed=1, device="cpu"),
                                 flat)


def to_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def digest(model) -> str:
    """A hash of the bits of every parameter of a rank's shard."""
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        h.update(n.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def whole_params(model, plan) -> dict:
    """Every parameter of a rank's shard gathered whole (collective)."""
    return {n: plan.whole(n, p.detach()).numpy().copy()
            for n, p in model.named_parameters()}


def mesh_grads(model, cfg, batch, plan) -> tuple:
    """(the global batch's loss, every whole gradient) of a rank's shard,
    reduced as its train step reduces them (collective)."""
    loss, _ = TL.lm_loss(model, plan.rows(batch), cfg)
    grads = plan.reduce_grads(TL._grads(model, loss))
    loss = plan.data_mean(loss.detach())
    return float(loss), {n: plan.whole(n, g).numpy().copy()
                         for n, g in grads.items()}


def train_run(cfg, flat, batches, mesh, zero1: bool, grads: bool,
              accum: int = 1) -> dict:
    """A rank's shard of the weights ``flat`` trained by
    ``steps.build_train``'s step (``accum`` microbatches of a data
    replica's rows) on ``batches`` (one a step): each step's loss and
    grad norm, the whole parameters after each step and the digest of the
    rank's own, and with ``grads`` the first batch's loss and whole
    gradients."""
    local = R.shard_params(load(cfg, flat), cfg, mesh)
    step, _, specs = steps.build_train(cfg, mesh, "train_4k", opt_cfg=OPT,
                                       accum=accum, zero1=zero1)
    state = TL.make_train_state(local, OPT, zero1)
    plan = P.plan_for(local, zero1)
    out = {"coords": mesh.coords, "loss": [], "grad_norm": [],
           "params": [], "digest": []}
    if grads:
        out["grads"] = mesh_grads(local, cfg, to_batch(batches[0]), plan)
    for b in batches:
        state, m = step(state, to_batch(b))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["params"].append(whole_params(local, plan))
        out["digest"].append(digest(local))
    out["moments"] = {n: t.shape for n, t in state["opt"]["m"].items()}
    out["shard_numel"] = sum(p.numel() for p in local.parameters())
    return out


def forward_run(cfg, flat, batch, mesh) -> dict:
    """A rank's shard's forward logits (its vocab slice) on ``batch``."""
    local = R.shard_params(load(cfg, flat), cfg, mesh)
    logits, _ = R.forward(local, to_batch(batch), cfg)
    return {"coords": mesh.coords, "logits": logits.numpy()}


# =============================================================================
# test_torch_tp_train.py: DDP, ErrorFeedback, checkpoints, TP training on
# (2, 2, 2), the vocab-parallel loss
# =============================================================================
def ddp_scenario(inputs: dict) -> dict:
    """``make_ddp_train_step`` on the group's 8 ranks, each compressor:
    the step's loss and parameters after it, and for f32 the averaged
    gradients of the first step."""
    cfg, batch = DDP_CFG, to_batch(inputs["ddp_batch"])
    out = {}
    for comp in (None, "bf16", "int8"):
        model = load(cfg, inputs["ddp_params"])
        state = TL.make_train_state(model, DDP_OPT)
        if comp is None:
            rows = TL._split_rows(batch, dist.get_world_size(),
                                  dist.get_rank())
            loss, _ = TL.lm_loss(model, rows, cfg)
            grads = CP.all_reduce_mean(TL._grads(model, loss), None)
            out["grads"] = bridge.to_reference(model, grads)
        state, m = TL.make_ddp_train_step(cfg, DDP_OPT, None,
                                          compressor=comp)(state, batch)
        out[comp] = (float(m["loss"]), float(m["grad_norm"]),
                     bridge.export_reference(model))
    return out


def error_feedback_scenario(inputs: dict, group) -> dict:
    """Three steps of ``ErrorFeedback`` on 2 ranks (``group``), rank r's
    gradients ``inputs["ef_grads"][step][r]``: each step's mean and
    residual."""
    res = None
    out = []
    r = dist.get_rank()
    for g in inputs["ef_grads"]:
        grads = {k: torch.as_tensor(v[r]) for k, v in g.items()}
        if res is None:
            res = CP.ErrorFeedback.init(grads)
        mean, res = CP.ErrorFeedback.compress_with_feedback(grads, res,
                                                            group)
        out.append(({k: v.numpy() for k, v in mean.items()},
                    {k: v.numpy() for k, v in res.items()}))
    return out


def checkpoint_scenario(inputs: dict, d: str) -> dict:
    """qwen3-1.7b SMOKE saved from a (2, 4) mesh — its initial weights,
    and its state after one ZeRO-1 step — and restored onto an (8,)
    "model" mesh: the (2, 4) rank's own parameters and moment slices, and
    the (8,) rank's restored ones."""
    cfg, flat = QWEN3, inputs["qwen3"]
    mesh_a = mesh_of((2, 4))
    local = R.shard_params(load(cfg, flat), cfg, mesh_a)
    CK.save({"params": local}, 1, os.path.join(d, "init"))
    state = TL.make_train_state(local, OPT, zero1=True)
    state, _ = TL.make_train_step(cfg, OPT)(state,
                                            to_batch(inputs["tp_batches"][0]))
    CK.save(state, 2, os.path.join(d, "trained"))
    saved = {"coords": mesh_a.coords,
             "params": {n: p.detach().numpy().copy()
                        for n, p in local.named_parameters()},
             "m": {n: t.numpy().copy() for n, t in state["opt"]["m"].items()},
             "v": {n: t.numpy().copy() for n, t in state["opt"]["v"].items()}}
    mesh_b = mesh_of((8,), ("model",))
    restored = {}
    for tag in ("init", "trained"):
        shard = R.shard_params(R.init_params(cfg, seed=7, device="cpu"), cfg,
                               mesh_b)
        st = TL.make_train_state(shard, OPT, zero1=True)
        CK.restore(os.path.join(d, tag), st if tag == "trained"
                   else {"params": shard})
        restored[tag] = {
            "params": {n: p.detach().numpy().copy()
                       for n, p in shard.named_parameters()},
            "m": {n: t.numpy().copy() for n, t in st["opt"]["m"].items()},
            "step": int(st["opt"]["step"])}
    return {"saved": saved, "restored": restored, "coords_b": mesh_b.coords}


def xent_scenario(inputs: dict) -> dict:
    """``chunked_xent`` on a (1, 3) mesh: the rank's slice of the head
    (its last slice 2 columns past the 256 ids), its loss and the
    gradients of the hidden states and of its slice."""
    mesh = mesh_of((1, XENT_M))
    if not mesh.member:
        return {}
    x = torch.as_tensor(inputs["xent_x"]).requires_grad_(True)
    w_whole = torch.as_tensor(inputs["xent_w"])
    w = rules.local_shard(w_whole.T, ("model", None), mesh).T.contiguous()
    w.requires_grad_(True)
    loss = TL.chunked_xent(x, w, torch.as_tensor(inputs["xent_labels"]),
                           w_whole.shape[1], chunk=4, mesh=mesh)
    gx, gw = torch.autograd.grad(loss, (x, w))
    return {"coords": mesh.coords, "loss": float(loss.detach()),
            "gx": gx.numpy(),
            "gw": gw.numpy()}


def train_group(args, inputs: dict, d: str) -> dict:
    """test_torch_tp_train.py's scenarios on 8 ranks."""
    torch.set_num_threads(1)
    ef_group = dist.new_group([0, 1])
    out = {"ddp": ddp_scenario(inputs)}
    if dist.get_rank() < 2:
        out["ef"] = error_feedback_scenario(inputs, ef_group)
    out["ckpt"] = checkpoint_scenario(inputs, d)
    mesh = mesh_of((2, 2, 2), ("pod", "data", "model"))
    for zero1, sp in TP_SETTINGS:
        out[("tp", zero1, sp)] = train_run(
            QWEN3.with_(seq_parallel=sp), inputs["qwen3"],
            inputs["tp_batches"], mesh, zero1, grads=(zero1, sp) ==
            TP_SETTINGS[0])
    out["tp_accum"] = train_run(QWEN3, inputs["qwen3"], inputs["tp_batches"],
                                mesh, True, grads=False, accum=2)
    out["xent"] = xent_scenario(inputs)
    return out


# =============================================================================
# test_torch_tp_train_families.py: every family on (1, m)
# =============================================================================
def spanning_run(cfg, flat, batch, mesh) -> str:
    """A ``build_train`` step of an MoE whose routing groups span two
    data replicas' rows: the step's refusal (every rank raises at the
    same layer, before its first MoE collective)."""
    local = R.shard_params(load(cfg, flat), cfg, mesh)
    step, _, _ = steps.build_train(cfg, mesh, "train_4k", opt_cfg=OPT,
                                   accum=1, zero1=True)
    state = TL.make_train_state(local, OPT, zero1=True)
    try:
        step(state, to_batch(batch))
    except ValueError as e:
        return str(e)
    return ""


def families_group(args, inputs: dict) -> dict:
    """test_torch_tp_train_families.py's scenarios on 4 ranks: each
    ``FAMILIES`` entry's SMOKE config on its mesh (ranks 0 .. n-1),
    trained two steps by ``steps.build_train`` with ZeRO-1 or, for the
    VLM, its forward; and qwen3-moe on (2, 2) given a batch whose
    routing groups span the replicas."""
    torch.set_num_threads(1)
    out = {}
    meshes = {sh: mesh_of(sh) for sh in sorted({f[2] for f in FAMILIES})}
    for key, arch, shape, forward_only in FAMILIES:
        mesh = meshes[shape]
        if not mesh.member:
            continue
        cfg, flat = family_cfg(arch), inputs["params"][key]
        if forward_only:
            out[key] = forward_run(cfg, flat, inputs["batches"][key][0],
                                   mesh)
        else:
            out[key] = train_run(cfg, flat, inputs["batches"][key], mesh,
                                 True, grads=True)
    key = "qwen3-moe-30b-a3b-2x2"
    out["spanning"] = spanning_run(family_cfg("qwen3-moe-30b-a3b"),
                                   inputs["params"][key],
                                   inputs["spanning"], meshes[(2, 2)])
    return out


# =============================================================================
# test_torch_tp_decode.py: the generic decode on a rank mesh
# =============================================================================
def decode_tokens(i: int) -> np.ndarray:
    return np.random.default_rng(40 + i).integers(
        0, 256, size=(DECODE_B, 1)).astype(np.int64)


def decode_run(model, cfg, seq_shard: bool = False, n: int = N_DECODE):
    """``n`` decode steps from an empty cache of ``DECODE_S`` positions
    (an enc-dec's over 16 seeded source frames): each step's logits (on a
    rank, its rows and vocab slice) and the cache."""
    src = None
    if cfg.n_enc_layers:
        src = torch.as_tensor(np.random.default_rng(7).standard_normal(
            (DECODE_B, 16, cfg.d_model)).astype(np.float32))
    cache = R.make_cache(model, cfg, DECODE_B, DECODE_S, src_embeds=src,
                         dtype=torch.float32, device="cpu",
                         seq_shard=seq_shard)
    out = []
    for i in range(n):
        lg, cache = R.decode_step(model, cache, {"tokens": torch.as_tensor(
            decode_tokens(i))}, cfg)
        out.append(lg.numpy().copy())
    return out, cache


def decode_group(args, inputs: dict) -> dict:
    """test_torch_tp_decode.py's scenarios on 8 ranks: glm4 SMOKE (the
    reference's weights) on (2, 4) with the sequence over "model" (its 2
    KV heads do not split over 4) and over ("data", "model")
    (``seq_shard``), and with the append-buffer decode; mamba2 SMOKE's
    cut SSM cache on (1, 2)."""
    torch.set_num_threads(1)
    out = {}
    mesh = mesh_of(DECODE_MESH)
    glm4 = family_cfg("glm4-9b")
    local = R.shard_params(load(glm4, inputs["glm4"]), glm4, mesh)
    for seq_shard in (True, False):
        lg, cache = decode_run(local, glm4, seq_shard)
        cut = cache["layout"]["kv"]
        out[("glm4", seq_shard)] = {
            "coords": mesh.coords, "logits": lg,
            "rows": (cache["layout"]["rows"].lo, cache["layout"]["rows"].hi),
            "segment": (cut.offset, cut.S_l, cut.seq_axes),
            "k_shape": tuple(cache["k"].shape)}
    win = glm4.with_(decode_window=DECODE_WINDOW)
    local = R.shard_params(load(win, inputs["glm4"]), win, mesh)
    for seq_shard in (True, False):
        lg, _ = decode_run(local, win, seq_shard)
        out[("window", seq_shard)] = {"coords": mesh.coords, "logits": lg}
    for i, (arch, seq_shard) in enumerate(DECODE_FAMILIES):
        cfg = family_cfg(arch)
        local = R.shard_params(load(cfg, i), cfg, mesh)
        lg, _ = decode_run(local, cfg, seq_shard)
        out[arch] = {"coords": mesh.coords, "logits": lg}
    small = mesh_of((1, 2))
    if small.member:
        ssm = family_cfg("mamba2-2.7b")
        local = R.shard_params(load(ssm, inputs["mamba2"]), ssm, small)
        lg, cache = decode_run(local, ssm)
        out["mamba2"] = {"coords": small.coords, "logits": lg,
                         "shapes": {k: tuple(v.shape) for k, v in
                                    cache["ssm"].items()}}
    return out


def failing_backward(args) -> None:
    """A rank whose training backward raises: rank 1's loss is made to
    fail in its backward, after the forward's collectives."""
    torch.set_num_threads(1)
    mesh = mesh_of((1, 2))
    cfg = QWEN3
    local = R.shard_params(R.init_params(cfg, device="cpu"), cfg, mesh)
    local.requires_grad_(True)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int64),
             "labels": torch.zeros((2, 8), dtype=torch.int64)}
    loss, _ = TL.lm_loss(local, batch, cfg)

    class Boom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("backward failed on purpose")

    if mesh.coord("model") == 1:
        loss = Boom.apply(loss)
    loss.backward()
