"""The port's sharding rules (``sharding/rules.py``) and meshes
(``launch/mesh.py``) against the reference's, on the same configs:

* ``param_specs`` and ``opt_state_specs`` (ZeRO-1) of all ten FULL configs
  — the port's model on the meta device, the reference's params through
  ``jax.eval_shape`` — on meshes of (16, 16), (2, 16, 16), (4, 2) and
  (8, 1), each port parameter's spec mapped back to the reference's leaf
  through ``bridge.leaf_map`` (the layer axis put back, a dense weight's
  two entries reversed) and compared entry for entry;
* ``batch_specs`` and ``cache_specs`` (with and without ``seq_shard``) on
  each package's own batch and cache, for every family;
* the three ``arena_spec`` cases (divisible, a model axis of 1, the
  explicit error naming ``n_kv_heads``);
* ``make_mesh_for``'s sizes and errors.

The reference's rules read only ``mesh.shape`` (and ``axis_names``), so a
fake mesh with those stands in for its devices, as
``tests/test_disagg.py`` does.  Specs are compared exactly."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.configs import get_config as get_config_j
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.configs import shapes as SHJ
from repro.models import registry as RJ
from repro.sharding import rules as SRJ
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs import shapes as SHT
from repro_torch.launch import mesh as MESH
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.sharding import rules as SRT


class _FakeMesh:
    """What the rules read of a mesh: its axes and their sizes."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "4x2": dict(data=4, model=2),
          "8x1": dict(data=8, model=1)}


def _entries(spec) -> tuple:
    return tuple(spec)


def _flat(d: dict, prefix: str = "") -> dict:
    """{'a/b': leaf} of the port's nested dicts (spec tuples are leaves)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_leaves(tree) -> dict:
    """{reference path: leaf} of a params or spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {SRJ._path_str(path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _abstract(arch: str):
    """(reference params' shapes, the port's model on the meta device)."""
    cfg = get_config_j(arch)
    sds = jax.eval_shape(functools.partial(RJ.init_params, cfg=cfg),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    return sds, RT.init_params(get_config(arch), device="meta")


def _back_to_reference(model, specs: dict) -> dict:
    """The port's per-parameter specs in the reference's layout, keyed by
    its leaf paths; every layer of a stacked leaf must share one spec."""
    out = {}
    for key, names, dense, stacked in bridge.leaf_map(model):
        got = {specs[n] for n in names}
        assert len(got) == 1, f"{key}: layers differ {got}"
        spec = next(iter(got))
        head, dims = (spec[:1], spec[1:]) if stacked else ((), spec)
        out[key] = head + (dims[::-1] if dense else dims)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, mesh):
    sds, model = _abstract(arch)
    fake = _FakeMesh(**MESHES[mesh])
    cfg_j, cfg_t = get_config_j(arch), get_config(arch)
    shapes = {k: tuple(v.shape) for k, v in _ref_leaves(sds).items()}
    for ref_fn, port_fn in ((SRJ.param_specs, SRT.param_specs),
                            (SRJ.opt_state_specs, SRT.opt_state_specs)):
        want = {k: _entries(v)
                for k, v in _ref_leaves(ref_fn(sds, cfg_j, fake)).items()}
        got = _back_to_reference(model, port_fn(model, cfg_t, fake))
        assert set(got) == set(want)
        for key in want:
            assert got[key] == want[key], (key, shapes[key], got[key],
                                           want[key])
    # the port's shapes are the reference's, in its layout
    params = dict(model.named_parameters())
    for key, names, dense, stacked in bridge.leaf_map(model):
        shape = tuple(params[names[0]].shape)
        shape = shape[::-1] if dense else shape
        assert ((len(names),) + shape if stacked else shape) == shapes[key]


def test_param_specs_shard_what_the_rules_say():
    """Spot checks in the port's own layout: a q projection's output dim
    (PyTorch's dim 0) over model, the embedding's vocab, an MoE's experts,
    and a ZeRO-1 moment widened over the data axes."""
    _, model = _abstract("qwen3-moe-30b-a3b")
    cfg = get_config("qwen3-moe-30b-a3b")
    mesh = MESH.make_production_mesh()
    specs = SRT.param_specs(model, cfg, mesh)
    # (the layer entry, then PyTorch's (out, in): q's heads over model)
    assert specs["layers.0.attn.wq.weight"] == (None, "model", None)
    assert specs["layers.0.attn.wo.weight"] == (None, None, "model")
    assert specs["embed"] == ("model", None)
    assert specs["layers.3.moe.w_gate"] == (None, "model", None, None)
    opt = SRT.opt_state_specs(model, cfg, mesh)
    assert opt["embed"][0] == ("model", "data")
    assert opt["layers.0.moe.router"] == (None, "data", None)
    # ZeRO-1 cuts mamba2's 64-layer stack of A_log over the 16 data shards
    _, m2 = _abstract("mamba2-2.7b")
    opt2 = SRT.opt_state_specs(m2, get_config("mamba2-2.7b"), mesh)
    assert opt2["layers.5.mamba.A_log"] == ("data", "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    """``batch_specs`` on every cell's inputs and ``cache_specs`` (with
    and without ``seq_shard``) on a decode cache, each package on its own
    tensors; the cache's shapes and keys are the reference's."""
    cfg_j, cfg_t = get_smoke_config_j(arch), get_smoke_config(arch)
    for mesh in ({"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2},
                 {"data": 1, "model": 1}):
        fake = _FakeMesh(**mesh)
        for shape in SHJ.SHAPES:
            want = SRJ.batch_specs(SHJ.input_specs(get_config_j(arch), shape),
                                   fake)
            got = SRT.batch_specs(SHT.input_specs(get_config(arch), shape),
                                  fake)
            assert got == {k: _entries(v) for k, v in want.items()}
        b, max_len = 4, 16
        p_j = jax.eval_shape(functools.partial(RJ.init_params, cfg=cfg_j),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
        src_j = src_t = None
        if cfg_j.n_enc_layers:
            src_j = jax.ShapeDtypeStruct((b, 8, cfg_j.d_model), jnp.float32)
            src_t = torch.empty((b, 8, cfg_t.d_model), device="meta")
        cache_j = jax.eval_shape(
            lambda p, s: RJ.make_cache(p, cfg_j, b, max_len, src_embeds=s),
            p_j, src_j)
        model = RT.init_params(cfg_t, device="meta")
        cache_t = RT.make_cache(model, cfg_t, b, max_len, src_embeds=src_t,
                                device="meta")
        ref_shapes = {k: tuple(v.shape)
                      for k, v in _ref_leaves(cache_j).items()}
        port_flat = _flat(cache_t)
        assert {k: tuple(v.shape) for k, v in port_flat.items()} == \
            ref_shapes
        for seq_shard in (False, True):
            want = _ref_leaves(SRJ.cache_specs(cache_j, fake, cfg_j,
                                               seq_shard=seq_shard))
            got = _flat(SRT.cache_specs(cache_t, fake, cfg_t,
                                        seq_shard=seq_shard))
            assert got == {k: _entries(v) for k, v in want.items()}


def test_split_cache_specs_match_reference():
    """The append-buffer decode's cache (``sk``, ``sv``, ``prefix_len``)."""
    cfg_j = get_smoke_config_j("glm4-9b").with_(decode_window=8)
    cfg_t = get_smoke_config("glm4-9b").with_(decode_window=8)
    p_j = jax.eval_shape(functools.partial(RJ.init_params, cfg=cfg_j),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    cache_j = jax.eval_shape(lambda p: RJ.make_cache(p, cfg_j, 4, 16), p_j)
    cache_t = RT.make_cache(RT.init_params(cfg_t, device="meta"), cfg_t, 4,
                            16, device="meta")
    assert set(cache_t) == set(cache_j)
    fake = _FakeMesh(data=4, model=2)
    for seq_shard in (False, True):
        want = SRJ.cache_specs(cache_j, fake, cfg_j, seq_shard=seq_shard)
        got = SRT.cache_specs(cache_t, fake, cfg_t, seq_shard=seq_shard)
        assert got == {k: _entries(v) for k, v in want.items()}


def test_arena_spec_three_cases():
    """Divisible: KV heads over model; a model axis of 1: replicated; not
    divisible: an explicit error naming ``n_kv_heads`` — as the
    reference's, on the same fake meshes."""
    glm4_t, glm4_j = get_smoke_config("glm4-9b"), get_smoke_config_j(
        "glm4-9b")
    assert glm4_t.n_kv_heads == 2
    for mesh, want in ((dict(data=4, model=2),
                        (None, None, None, "model", None)),
                       (dict(data=8, model=1), (None,) * 5)):
        assert SRT.arena_spec(_FakeMesh(**mesh), glm4_t) == want
        assert _entries(SRJ.arena_spec(_FakeMesh(**mesh), glm4_j)) == want
    with pytest.raises(ValueError, match="n_kv_heads"):
        SRT.arena_spec(_FakeMesh(data=2, model=4), glm4_t)
    with pytest.raises(ValueError, match="n_kv_heads"):
        SRJ.arena_spec(_FakeMesh(data=2, model=4), glm4_j)
    assert SRT.logits_spec(_FakeMesh(pod=2, data=2, model=2)) == \
        _entries(SRJ.logits_spec(_FakeMesh(pod=2, data=2, model=2)))


def test_make_mesh_for_sizing_and_errors():
    """The reference's cases: a one-device mesh's axes and sizes, and
    "does not divide" for a model axis that does not divide the devices;
    more devices than exist is an error too.  The production meshes are
    abstract, with the reference's shapes."""
    mesh = MESH.make_mesh_for(1, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.device == torch.device("cpu")
    assert MESH.make_mesh_for(device="cpu").size == 1
    with pytest.raises(ValueError, match="does not divide"):
        MESH.make_mesh_for(8, model_parallel=3)
    with pytest.raises(ValueError, match="does not divide"):
        MESH.make_mesh_for(4, model_parallel=8)
    with pytest.raises(ValueError, match="only 1 cpu device"):
        MESH.make_mesh_for(2, device="cpu")
    prod, multi = (MESH.make_production_mesh(),
                   MESH.make_production_mesh(multi_pod=True))
    assert prod.abstract and prod.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    sl = MESH.make_slice_mesh(["cpu"], 1)
    assert sl.shape == {"data": 1, "model": 1}
    assert MESH.make_test_mesh(1, 1, device="cpu").size == 1


def test_shard_shape_pads_as_gspmd():
    """A shard of a dim its axes do not divide is the ceiling (GSPMD
    pads): 14 heads over 16 -> 1, a 256206 vocab over 16 -> 16013."""
    mesh = MESH.make_production_mesh()
    assert SRT.shard_shape((256206, 1024), ("model", None), mesh) == \
        (16013, 1024)
    assert SRT.shard_shape((4, 14, 64), (("data",), "model"), mesh) == \
        (1, 1, 64)
    assert SRT.shard_bytes((32, 8), ((("data", "model")), None), mesh,
                           2) == 8 * 2
