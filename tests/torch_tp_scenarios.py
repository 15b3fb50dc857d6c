"""Rank scenarios of the port's tensor-parallel tests
(``tests/test_torch_tp_*.py``).

Each ``*_group`` function runs on every rank of one CPU process group
(gloo), started by ``repro_torch.launch.ranks.spawn`` once a test file,
and returns a dict of numpy results, one entry a scenario, for that
file's tests to read.  A scenario on a mesh smaller than the group runs
on its ranks 0 .. n-1; the others make the mesh too (group creation is
collective) and leave the entry out.  This module imports the port only:
the reference runs in the test process, which passes its weights in as
numpy arrays.
"""
import numpy as np
import torch

from repro_torch.configs import get_smoke_config, qwen3_1_7b
from repro_torch.core import config_graph as CG
from repro_torch.launch import mesh as MESH
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serving import engine as ENG
from repro_torch.serving.api import InferenceRequest, serve_workload

CFG = qwen3_1_7b.SMOKE.with_(n_layers=2, dtype=torch.float32)
MOE_CFG = get_smoke_config("qwen3-moe-30b-a3b").with_(n_layers=2)


def drop_free(cfg):
    """``cfg`` at a capacity where no MoE pair drops: a row's output no
    longer depends on the rows it shares a call with."""
    f = cfg.padded_experts / cfg.top_k
    return cfg.with_(capacity_factor=f, decode_capacity_factor=f)


def mesh_of(data: int, model: int):
    return MESH.make_mesh_for(data * model, model_parallel=model,
                              device="cpu")


def paged_workload(cfg, lens, seed=0, shared=12):
    """tests/multidev_scenarios.py's workload: a shared prefix, then random
    tokens."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, size=shared).astype(np.int32)
    return [np.concatenate(
        [pre, rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)])
        for n in lens]


# =============================================================================
# module level: layers, embedding, greedy pick, MoE
# =============================================================================
# model axes of the (1, m) meshes the dense modules run on, and the MoE
# cases: (name, arch, config overrides, m); qwen3-moe SMOKE has 8 experts
# (experts over "model" at m = 2 and 4; at m = 3 each expert's FF width,
# 48 = 3 x 16), qwen2-moe SMOKE 6 experts and 2 shared (experts over
# "model" at m = 2, the FF width at m = 4, 32 = 4 x 8)
LAYER_MODEL = (2, 4)
MOE_CASES = (("experts-m2", "qwen3-moe-30b-a3b", {}, 2),
             ("experts-m4", "qwen3-moe-30b-a3b", {}, 4),
             ("ff-m3", "qwen3-moe-30b-a3b", {"d_expert_ff": 48}, 3),
             ("shared-experts-m2", "qwen2-moe-a2.7b", {}, 2),
             ("shared-ff-m4", "qwen2-moe-a2.7b", {}, 4))
# MoE inputs (b, s): a prefill that drops pairs, a decode step
MOE_SHAPES = ((2, 48), (16, 1))


def layer_inputs(cfg, seed: int = 0):
    """(tokens (2, 12) int64, hidden states (2, 12, d) f32)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 12))
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    return torch.as_tensor(tokens), torch.as_tensor(x)


def layer_outputs(model, cfg, tokens, x) -> dict:
    """Every module's output on the same inputs: layer 0's attention and
    MLP, the embedding, the readout (this rank's vocab slice) and its
    greedy pick, and the forward's logits and greedy pick."""
    attn = model.layers[0].attn
    cos, sin = T._rope_tables(cfg, torch.arange(x.shape[1]))[0]
    with torch.no_grad():
        logits = model.logits(x)
        fwd, _ = T.forward_lm(model, tokens)
        return {"attention": L.attention_apply(attn, x, cos, sin).numpy(),
                "mlp": model.layers[0].mlp(x).numpy(),
                "embedding": model.embed_tokens(tokens).numpy(),
                "logits": logits.numpy(),
                "greedy": R.greedy_token(model, logits).numpy(),
                "forward": fwd.numpy(),
                "forward_greedy": R.greedy_token(model, fwd).numpy()}


def tie_logits(V: int = 256, seed: int = 1) -> np.ndarray:
    """(6, V) f32 logits with planted maxima: ties across shards (ids 3
    and 200; 130 and 250; 60 and 70 and 190), a tie inside one shard (10
    and 11), a lone maximum at the last id, and a row of one value."""
    lg = np.random.default_rng(seed).standard_normal((6, V)).astype(
        np.float32)
    for row, ids in enumerate(((3, 200), (250, 130), (190, 70, 60),
                               (10, 11), (V - 1,))):
        lg[row, list(ids)] = 9.0
    lg[5] = 0.5
    return lg


def moe_model(arch: str, kw: dict, moe_params: dict):
    """A one-layer LM of ``arch``'s SMOKE config whose MoE layer holds the
    reference's MoE weights (``moe_params``: router, w_gate, w_up,
    w_down, and the shared MLP's as (d_in, d_out) arrays)."""
    cfg = get_smoke_config(arch).with_(n_layers=1, **kw)
    model = R.init_params(cfg, device="cpu")
    moe = model.layers[0].moe
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(moe, name).copy_(torch.tensor(moe_params[name]))
        for name in ("wi_gate", "wi_up", "wo"):
            if f"shared/{name}" in moe_params:
                getattr(moe.shared, name).weight.copy_(
                    torch.tensor(moe_params[f"shared/{name}"]).T)
    return cfg, model


def moe_inputs(cfg, seed: int = 0):
    """f32 inputs of ``MOE_SHAPES`` with a direction common to every token
    (as tests/test_torch_moe.py's), so that capacities bind."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal((b, s, cfg.d_model))
                             + 1.5 * rng.standard_normal(cfg.d_model)
                             ).astype(np.float32)) for b, s in MOE_SHAPES]


def moe_outputs(model, cfg, xs) -> list:
    with torch.no_grad():
        return [[t.numpy() for t in M.moe_apply(model.layers[0].moe, x, cfg)]
                for x in xs]


def layers_group(args, flat: dict, moe_params: dict) -> dict:
    """The module-level scenarios: the dense modules of qwen3-1.7b SMOKE
    (the reference's weights, ``flat``) on (1, 2) and (1, 4) meshes, the
    greedy pick of planted ties on (1, 2), (1, 3) and (1, 4), and the MoE
    cases of ``MOE_CASES``."""
    torch.set_num_threads(1)
    out = {"mesh_errors": []}
    for n, m in ((8, 2), (4, 3)):
        try:
            mesh_of(n // m, m) if n % m == 0 else MESH.make_mesh_for(
                n, model_parallel=m, device="cpu")
        except ValueError as e:
            out["mesh_errors"].append(str(e))
    for name, mesh in (("test_mesh", MESH.make_test_mesh(2, 2, device="cpu")),
                       ("slice_mesh", MESH.make_slice_mesh(["cpu", "cpu"],
                                                           2))):
        out[name] = (mesh.distributed, mesh.coords, mesh.shape)
    model = R.init_params(CFG, device="cpu")
    bridge.load_reference(model, flat)
    tokens, x = layer_inputs(CFG)
    lg = tie_logits(CFG.padded_vocab)
    meshes = {m: mesh_of(1, m) for m in (2, 3, 4)}
    for m, mesh in meshes.items():
        if not mesh.member:
            continue
        local = R.shard_params(model, CFG, mesh)
        if m in LAYER_MODEL:
            out[("layers", m)] = dict(layer_outputs(local, CFG, tokens, x),
                                      coords=mesh.coords)
            out[("layers", m)]["train_forward"] = T.forward_lm(
                local, tokens, train=True)[0].detach().numpy()
        n = -(-lg.shape[1] // m)
        lo = mesh.coord("model") * n
        part = np.full((lg.shape[0], n), -np.inf, np.float32)
        part[:, :max(0, min(n, lg.shape[1] - lo))] = lg[:, lo:lo + n]
        out[("ties", m)] = {
            "greedy": L.greedy_token(torch.as_tensor(part), mesh).numpy(),
            "readout": local.logits(x).numpy(), "coords": mesh.coords}
    for name, arch, kw, m in MOE_CASES:
        mesh = meshes[m]
        if mesh.member:
            cfg, whole = moe_model(arch, kw, moe_params[name])
            local = R.shard_params(whole, cfg, mesh)
            out[("moe", name)] = {
                "outputs": moe_outputs(local, cfg, moe_inputs(cfg)),
                "experts": local.layers[0].moe.experts,
                "w_gate": tuple(local.layers[0].moe.w_gate.shape),
                "coords": mesh.coords}
    return out


# =============================================================================
# the engines
# =============================================================================
ENGINE_MESHES = ((1, 2), (2, 1), (2, 2), (4, 2))
# tests/multidev_scenarios.py:183-184 (scenario_sharded_paged_decode_parity)
ENGINE_KW = dict(n_slots=4, max_len=64, kv_layout="paged", block_size=8,
                 max_seqs=4)
ENGINE_LENS = (6, 14, 9, 22, 6, 11)
N_NEW = 10


def graph(cfg):
    return CG.ConfigGraph.from_dict(cfg.name, {("x1", 16): 1})


def family(cfg, flat=None):
    """``cfg``'s family on the CPU: seeded, or holding the reference's
    weights ``flat`` (numpy arrays by the reference's leaf names)."""
    fam = ENG.build_engine_family(cfg, fracs=(1.0,), device="cpu")
    if flat is not None:
        bridge.load_reference(fam[0].params, flat)
    return fam


def serve(cfg, mesh, prompts, n_new: int, requests: bool = False,
          flat=None, **kw) -> dict:
    """One session of ``RealEngine(mesh=mesh, **kw)`` on ``cfg``'s family
    (:func:`family`): its streams, stats and every instance's arena (k,
    v)."""
    eng = ENG.RealEngine(family(cfg, flat), device="cpu", mesh=mesh, **kw)
    eng.configure(graph(cfg))
    if requests:
        serve_workload(eng, [InferenceRequest(rid=i, prompt=p,
                                              max_new_tokens=n_new)
                             for i, p in enumerate(prompts)])
        stats = eng.stats()
    else:
        stats = eng._serve_prompts(prompts, n_new=n_new)
    return {"outputs": dict(eng.last_outputs), "stats": stats,
            "arenas": [(i.role, i.arena["k"].numpy().copy(),
                        i.arena["v"].numpy().copy())
                       for i in eng.instances]}


def engine_group(args, flats: dict) -> dict:
    """The engine scenarios, on the reference's weights ``flats``
    ("engine", "moe"): qwen3-1.7b SMOKE (2 layers, f32) on every mesh of
    ``ENGINE_MESHES``, qwen3-moe SMOKE on (1, 2) at its own capacity and
    at a drop-free one (and the engine's error for a family that is not
    on the host), and glm4's SMOKE arena and
    engine on a (1, 4) mesh (its error)."""
    torch.set_num_threads(1)
    out = {}
    prompts = paged_workload(CFG, ENGINE_LENS, seed=1)
    for d, m in ENGINE_MESHES:
        mesh = mesh_of(d, m)
        if mesh.member:
            out[("engine", d, m)] = dict(
                serve(CFG, mesh, prompts, N_NEW, flat=flats["engine"],
                      **ENGINE_KW), coords=mesh.coords)
    mesh = mesh_of(1, 2)
    if mesh.member:
        # a rank mesh takes the whole weights from the host only
        try:
            ENG.RealEngine(ENG.build_engine_family(CFG, fracs=(1.0,),
                                                   device="meta"),
                           device="cpu", mesh=mesh, **ENGINE_KW)
            out[("family off the host", 1, 2)] = None
        except ValueError as e:
            out[("family off the host", 1, 2)] = str(e)
        moe_prompts = paged_workload(MOE_CFG, ENGINE_LENS, seed=1)
        for key, cfg in (("moe", MOE_CFG), ("moe drop-free",
                                            drop_free(MOE_CFG))):
            out[(key, 1, 2)] = dict(
                serve(cfg, mesh, moe_prompts, N_NEW, flat=flats["moe"],
                      **ENGINE_KW), coords=mesh.coords)
    mesh = mesh_of(1, 4)
    if mesh.member:
        glm4 = get_smoke_config("glm4-9b")
        errors = []
        for build in (lambda: R.make_block_arena(glm4, 8, 8, mesh=mesh),
                      lambda: ENG.RealEngine(family(glm4), device="cpu",
                                             mesh=mesh, **ENGINE_KW)):
            try:
                build()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        out[("glm4", 1, 4)] = errors
    return out


# =============================================================================
# disaggregation
# =============================================================================
# tests/multidev_scenarios.py:226-241 and :273-281
STARVED_KW = dict(n_slots=4, max_len=48, kv_layout="paged", block_size=8,
                  max_seqs=4, n_blocks=14, preemption=True,
                  roles={"prefill": 1, "decode": 1})
SMOKE_KW = dict(n_slots=2, max_len=32, kv_layout="paged", roles=(1, 1))


def starved_prompts():
    return paged_workload(CFG, (6, 6, 6, 6), seed=5, shared=16)


def smoke_prompts():
    return paged_workload(CFG, (5, 9, 7), seed=0, shared=0)


def disagg_group(args, flat: dict) -> dict:
    """Both disaggregation scenarios on a (2, 2) mesh, on the reference's
    weights ``flat``: the starved decode arena (preemption, a partial
    swap-in) through ``serve_workload``, and the small smoke serve."""
    torch.set_num_threads(1)
    mesh = mesh_of(2, 2)
    return {"starved": dict(serve(CFG, mesh, starved_prompts(), 16,
                                  requests=True, flat=flat, **STARVED_KW),
                            coords=mesh.coords),
            "smoke": dict(serve(CFG, mesh, smoke_prompts(), 4, flat=flat,
                                **SMOKE_KW),
                          coords=mesh.coords)}


def world_of_one(args) -> list:
    """What a rank started by torchrun sees: its rank, the world, the
    backend and a (1, 1) rank mesh."""
    mesh = mesh_of(1, 1)
    return [args.rank, args.world_size, args.backend, mesh.distributed,
            mesh.coords]


def failing_rank(args) -> int:
    """Rank 1 raises; the others wait in a collective that never
    completes."""
    if args.rank == 1:
        raise KeyError("rank 1 fails")
    torch.distributed.barrier()
    return args.rank
