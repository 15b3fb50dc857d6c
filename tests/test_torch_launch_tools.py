"""The port's launch tooling against the reference's, on the CPU:

* ``configs/shapes.py``: ``input_specs`` (meta tensors) against the
  reference's ``ShapeDtypeStruct``s for every arch and cell, shapes and
  dtypes, and ``cell_applicable``;
* ``launch/roofline.py``: ``model_flops_per_device`` equal to the
  reference's for every applicable cell and both production meshes;
* ``configs.get_optimized_config`` for every arch;
* ``launch/dryrun.py``: two cells at a small arch (qwen2-0.5b), a decode
  cell and a train cell, whose per-device bytes (parameters, ZeRO-1
  moments, cache, inputs) equal those that the reference's own specs
  imply on its own shapes — a shard being ``ceil(dim / axis sizes)`` —
  with their FLOP ratios printed and their counted collectives filling
  the roofline's collective term; and the CLI on one cell;
* ``RealEngine(mesh=make_mesh_for(1, device="cpu"))``, paged and
  disaggregated: streams and counters equal to the port's unsharded
  engine's and to the reference's unsharded engine's, on the workloads of
  the reference's mesh tests (``tests/test_disagg.py``
  ``test_single_device_mesh_paged_parity``, ``tests/multidev_scenarios.py``
  ``scenario_sharded_paged_decode_parity`` and
  ``scenario_disagg_vs_monolithic_parity``; 2 layers, f32, the
  reference's weights carried over).  The reference's sharded engine
  cannot be the oracle here: its ``mesh=`` fails in this JAX
  (``ShardingTypeError`` at the vocab-sharded embedding gather), so the
  contract those tests state — token-identical to the unsharded engine —
  is what is held.

Bytes and streams are compared exactly."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.configs import get_config as get_config_j
from repro.configs import get_optimized_config as get_optimized_config_j
from repro.configs import get_smoke_config
from repro.configs import shapes as SHJ
from repro.core import config_graph as CGJ
from repro.launch import roofline as RLJ
from repro.models import registry as RJ
from repro.serving import engine as ENGJ
from repro.sharding import rules as SRJ
from repro.train import optimizer as OJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_config, get_optimized_config, qwen3_1_7b
from repro_torch.configs import shapes as SHT
from repro_torch.core import config_graph as CGT
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as RLT
from repro_torch.models import bridge
from repro_torch.serving import engine as ENG
from repro_torch.serving.api import InferenceRequest, serve_workload

DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
      jnp.float32: torch.float32}


class _FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


# =============================================================================
# shapes, model FLOPs, optimized configs
# =============================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg_j, cfg_t = get_config_j(arch), get_config(arch)
    assert set(SHT.SHAPES) == set(SHJ.SHAPES)
    for shape, cell in SHJ.SHAPES.items():
        assert SHT.SHAPES[shape].__dict__ == cell.__dict__
        assert SHT.cell_applicable(cfg_t, shape) == \
            SHJ.cell_applicable(cfg_j, shape)
        want = SHJ.input_specs(cfg_j, shape)
        got = SHT.input_specs(cfg_t, shape)
        assert set(got) == set(want)
        for k, sds in want.items():
            assert got[k].is_meta and tuple(got[k].shape) == sds.shape
            assert got[k].dtype == DT[sds.dtype.type], (k, got[k].dtype)
        src_j, src_t = (SHJ.src_embeds_spec(cfg_j, shape),
                        SHT.src_embeds_spec(cfg_t, shape))
        assert (src_j is None) == (src_t is None)
        if src_j is not None:
            assert tuple(src_t.shape) == src_j.shape


def test_model_flops_per_device_match_reference():
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHT.SHAPES:
            if not SHT.cell_applicable(cfg, shape):
                continue
            for devices in (256, 512):
                assert RLT.model_flops_per_device(arch, shape, devices) == \
                    RLJ.model_flops_per_device(arch, shape, devices)


def test_get_optimized_config_every_arch():
    """Every arch's optimized config is its FULL config with the
    reference's overrides."""
    for arch in ARCHS:
        cfg, ref = get_optimized_config(arch), get_optimized_config_j(arch)
        assert cfg.decode_window == ref.decode_window
        assert cfg.remat_policy == ref.remat_policy
        assert cfg.with_(decode_window=0, remat_policy="full") == \
            get_config(arch).with_(decode_window=0, remat_policy="full")


# =============================================================================
# the dry run's per-device bytes against the reference's specs
# =============================================================================
def _ref_device_bytes(tree, specs, mesh) -> int:
    """One device's bytes of a reference tree of ShapeDtypeStructs under
    its PartitionSpecs, each dim ``ceil(dim / axes)``."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
        n = 1
        for d, ax in zip(leaf.shape, dims):
            axes = (ax,) if isinstance(ax, str) else (ax or ())
            n *= -(-d // SRJ.axes_size(mesh, axes)) if axes else d
        total += n * leaf.dtype.itemsize
    return total


@pytest.fixture
def small_train_cell(monkeypatch):
    """train_4k at 256 tokens x 32 rows in both packages, so the cell runs
    in a test's time (one microbatch on the 16 x 16 mesh)."""
    monkeypatch.setitem(SHJ.SHAPES, "train_4k",
                        SHJ.ShapeCell("train_4k", 256, 32, "train"))
    monkeypatch.setitem(SHT.SHAPES, "train_4k",
                        SHT.ShapeCell("train_4k", 256, 32, "train"))


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_dryrun_cell_bytes_match_reference_specs(shape, small_train_cell):
    arch = "qwen2-0.5b"
    cfg = get_config_j(arch)
    rec = DRY.run_cell(arch, shape, multi_pod=False, verbose=False)
    mesh = _FakeMesh(data=16, model=16)
    params = jax.eval_shape(functools.partial(RJ.init_params, cfg=cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {"param_bytes": _ref_device_bytes(
        params, SRJ.param_specs(params, cfg, mesh), mesh)}
    batch = SHJ.input_specs(cfg, shape)
    want["input_bytes"] = _ref_device_bytes(
        batch, SRJ.batch_specs(batch, mesh), mesh)
    if shape == "train_4k":
        opt = jax.eval_shape(OJ.init_opt_state, params)
        mv = SRJ.opt_state_specs(params, cfg, mesh)
        want["opt_bytes"] = (_ref_device_bytes(opt["m"], mv, mesh)
                             + _ref_device_bytes(opt["v"], mv, mesh) + 4)
        want["cache_bytes"] = 0
    else:
        cell = SHJ.SHAPES[shape]
        cache = jax.eval_shape(
            lambda p: RJ.make_cache(p, cfg, cell.global_batch, cell.seq_len),
            params)
        want["cache_bytes"] = _ref_device_bytes(
            cache, SRJ.cache_specs(cache, mesh, cfg, seq_shard=False), mesh)
        want["opt_bytes"] = 0
    got = {k: rec["memory"][k] for k in want}
    assert got == want
    coll = rec["collectives"]
    assert set(coll) == {"collective_wire_bytes", "collective_counts",
                         "total_collective_bytes"}
    assert coll["total_collective_bytes"] > 0 and rec["devices"] == 256
    assert rec["dot_flops_per_device"] > 0
    assert rec["model_flops_per_device"] == \
        RLJ.model_flops_per_device(arch, shape, 256)
    row = RLT.roofline_row(rec)
    assert row["t_collective_s"] > 0 and row["fits_hbm"]
    print(f"dryrun {arch} {shape}: FLOPs a device "
          f"{rec['dot_flops_per_device']:.4g}, model/counted "
          f"{rec['useful_flops_ratio']:.4f}, bytes {got}")


def test_dryrun_cli_skips_as_the_reference_and_writes(tmp_path, capsys):
    """The CLI on one cell and on a skipped one (a full-attention arch's
    long_500k), exit code 0; the roofline reads what it wrote."""
    out = tmp_path / "dry.json"
    assert DRY.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--single-pod-only", "--out", str(out)]) == 0
    assert DRY.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                     "--multi-pod-only", "--out",
                     str(tmp_path / "skip.json")]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 1 and recs[0]["mesh"] == "16x16"
    skipped = json.loads((tmp_path / "skip.json").read_text())
    assert skipped[0]["skipped"]
    assert RLT.main(["--in", str(out)]) == 0
    assert "qwen2-0.5b | decode_32k" in capsys.readouterr().out


# =============================================================================
# mesh= on one rank: the engines' streams
# =============================================================================
CFG = get_smoke_config("qwen3-1.7b").with_(n_layers=2, dtype=jnp.float32)
CFG_T = qwen3_1_7b.SMOKE.with_(n_layers=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def families():
    """(reference family, port family with the same weights)."""
    fam_j = ENGJ.build_engine_family(CFG, fracs=(1.0,))
    fam_t = ENG.build_engine_family(CFG_T, fracs=(1.0,), device="cpu")
    bridge.load_reference(fam_t[0].params, _flatten(fam_j[0].params))
    return fam_j, fam_t


def _paged_workload(lens, seed=0, shared=12):
    """tests/multidev_scenarios.py's workload: a shared prefix, then
    random tokens."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, CFG.vocab_size, size=shared).astype(np.int32)
    return [np.concatenate(
        [pre, rng.integers(0, CFG.vocab_size, size=int(n)).astype(np.int32)])
        for n in lens]


def _engines(families, **kw):
    """(reference engine, port engine, port engine on a (1, 1) mesh), each
    configured with one x1 instance."""
    ref = ENGJ.RealEngine(families[0], **kw)
    ref.configure(CGJ.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    out = [ref]
    for mesh in (None, MESH.make_mesh_for(1, device="cpu")):
        eng = ENG.RealEngine(families[1], device="cpu", mesh=mesh, **kw)
        eng.configure(CGT.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
        out.append(eng)
    return out


def _requests(prompts, n_new):
    return [InferenceRequest(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


COUNTERS = ("served", "tokens", "decode_steps", "prefill_chunks",
            "prefix_hit_tokens", "preemptions", "handoffs", "handoff_pages",
            "swapin_pages_copied", "partial_swapin_pages_saved")


def _same_counters(a: dict, b: dict) -> None:
    for key in COUNTERS:
        if key in a or key in b:
            assert a[key] == b[key], key


def test_single_device_mesh_paged_parity(families):
    """tests/test_disagg.py's workload: prompts of 7, 13, 5 tokens, 6 new."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
               for n in (7, 13, 5)]
    ref, flat, meshed = _engines(families, n_slots=2, max_len=32,
                                 kv_layout="paged")
    from repro.serving.api import serve_workload as serve_workload_j
    serve_workload_j(ref, _requests_j(prompts, 6))
    outs = [dict(ref.last_outputs)]
    for eng in (flat, meshed):
        serve_workload(eng, _requests(prompts, 6))
        outs.append(dict(eng.last_outputs))
    _same(outs[2], outs[1])
    _same(outs[2], outs[0])
    _same_counters(meshed.stats(), flat.stats())
    inst = meshed.instances[0]
    assert inst.mesh.size == 1 and inst.params is families[1][0].params


def _requests_j(prompts, n_new):
    from repro.serving.api import InferenceRequest as Req
    return [Req(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]


def test_sharded_paged_decode_parity_one_rank(families):
    """multidev_scenarios.py's sharded_paged_decode_parity workload on a
    (1, 1) mesh: mixed lengths over a shared prefix, block size 8, 4 rows,
    10 new tokens; prefix hits equal and above 0."""
    prompts = _paged_workload((6, 14, 9, 22, 6, 11), seed=1)
    ref, flat, meshed = _engines(families, n_slots=4, max_len=64,
                                 kv_layout="paged", block_size=8, max_seqs=4)
    m = [ref._serve_prompts(prompts, n_new=10)]
    for eng in (flat, meshed):
        m.append(eng._serve_prompts(prompts, n_new=10))
    _same(meshed.last_outputs, ref.last_outputs)
    _same(meshed.last_outputs, flat.last_outputs)
    assert m[2]["prefix_hit_tokens"] == m[1]["prefix_hit_tokens"] == \
        m[0]["prefix_hit_tokens"] > 0
    _same_counters(m[2], m[1])


def test_disagg_vs_monolithic_parity_one_rank(families):
    """multidev_scenarios.py's disagg_vs_monolithic_parity on a (1, 1)
    mesh: one prefill and one decode worker on a starved decode arena (14
    blocks, preemption, a partial swap-in from the decode worker's radix
    tree) token-identical to the reference's monolithic engine and to the
    port's disaggregated engine without a mesh, with equal handoffs,
    preemptions and swap-in pages."""
    prompts = _paged_workload((6, 6, 6, 6), seed=5, shared=16)
    n_new = 16
    ref = ENGJ.RealEngine(families[0], n_slots=4, max_len=48,
                          kv_layout="paged", block_size=8, max_seqs=4,
                          n_blocks=33)
    ref.configure(CGJ.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
    ref._serve_prompts(prompts, n_new=n_new)
    assert ref.stats()["preemptions"] == 0
    stats = []
    for mesh in (None, MESH.make_mesh_for(1, device="cpu")):
        eng = ENG.RealEngine(families[1], n_slots=4, max_len=48,
                             kv_layout="paged", block_size=8, max_seqs=4,
                             n_blocks=14, preemption=True, mesh=mesh,
                             roles={"prefill": 1, "decode": 1}, device="cpu")
        eng.configure(CGT.ConfigGraph.from_dict(CFG.name, {("x1", 16): 1}))
        serve_workload(eng, _requests(prompts, n_new))
        stats.append(eng.stats())
        _same(eng.last_outputs, ref.last_outputs)
    m = stats[1]
    assert m["handoffs"] == len(prompts)
    assert m["preemptions"] >= 1
    assert m["partial_swapin_pages_saved"] >= 1
    _same_counters(stats[1], stats[0])
    assert all(inst.mesh is not None for inst in eng.instances)
