"""Weight bridge: the reference's params, flattened as its checkpoints
flatten them, load into the port's per-layer modules and export back
bit-equal — tied and untied heads, with and without qkv bias, f32 and
bf16.  Tolerance: exact (every value is copied, never recomputed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import qwen3_1_7b
from repro_torch.models import bridge
from repro_torch.models import registry as RT

VARIANTS = {
    "tied-f32": ({}, {}),
    "bf16": ({"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16}),
    "untied-bias": ({"tie_embeddings": False, "qkv_bias": True},
                    {"tie_embeddings": False, "qkv_bias": True}),
    "three-layers": ({"n_layers": 3}, {"n_layers": 3}),
}


def _pair(name):
    jkw, tkw = VARIANTS[name]
    cfg_j = get_smoke_config("qwen3-1.7b").with_(**jkw)
    cfg_t = qwen3_1_7b.SMOKE.with_(**tkw)
    arrays = _flatten(RJ.init_params(jax.random.PRNGKey(7), cfg_j))
    return arrays, RT.init_params(cfg_t, seed=1, device="cpu")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_reference_params_round_trip_exactly(name):
    arrays, model = _pair(name)
    bridge.load_reference(model, arrays)
    back = bridge.export_reference(model)
    assert set(back) == set(arrays)
    for key, ref in arrays.items():
        got = back[key]
        assert got.shape == ref.shape, key
        np.testing.assert_array_equal(got, np.asarray(ref, np.float32),
                                      err_msg=key)


def test_port_init_matches_reference_layout():
    """A model the port initialised itself exports under exactly the
    reference's keys and shapes, and loads back to the same tensors."""
    arrays, model = _pair("tied-f32")
    own = bridge.export_reference(model)
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in arrays.items()}
    fresh = RT.init_params(qwen3_1_7b.SMOKE, seed=2, device="cpu")
    bridge.load_reference(fresh, own)
    for (n1, p1), (n2, p2) in zip(model.named_parameters(),
                                  fresh.named_parameters()):
        assert n1 == n2
        assert torch.equal(p1, p2), n1


def test_load_rejects_missing_extra_and_misshapen_leaves():
    arrays, model = _pair("tied-f32")
    with pytest.raises(KeyError):
        bridge.load_reference(model, {k: v for k, v in arrays.items()
                                      if k != "embed/table"})
    with pytest.raises(ValueError, match="no place"):
        bridge.load_reference(model, {**arrays, "extra/w": np.zeros(3)})
    bad = dict(arrays)
    bad["layers/attn/wq/w"] = bad["layers/attn/wq/w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        bridge.load_reference(model, bad)
