"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's ``models/moe.py`` at SMOKE widths on the CPU, on the same
numpy-seeded inputs and weights: ``moe_apply`` (outputs and aux) on
prefill shapes where the reference drops (token, expert) pairs, on
``s == 1`` decode shapes with and without drops, on a token count that
halves the group size, with padding experts, with shared experts and in
bf16; ``moe_apply_dense_ref``; at a drop-free capacity ``moe_apply``
equals the dense oracle.  Also the weight bridge's round trip for both MoE
configs.

Routing is compared first: every token's set of chosen experts must equal
the reference's, or the k-th and (k+1)-th probabilities must be a near-tie
(1e-6); outputs are compared over the groups whose routing agrees.
Tolerances: f32 2e-4 (as ``tests/test_torch_dense_archs.py``), bf16 2e-2
(``tests/test_kernels.py::_tols``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import moe as MJ
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import bridge
from repro_torch.models import moe as MT
from repro_torch.models import registry as RT

ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TIE = 1e-6
# the reference's functions, compiled once per shape (eager JAX dispatches
# each op on its own)
MOE_J = jax.jit(MJ.moe_apply, static_argnums=2)
DENSE_J = jax.jit(MJ.moe_apply_dense_ref, static_argnums=2)

# (id, arch, SMOKE overrides, x shape (b, s)): qwen3-moe SMOKE has 8
# experts, top-2, groups of 64; qwen2-moe SMOKE 6 experts, top-2 and 2
# shared experts
CASES = [
    # prefill: 96 tokens halve the group to 32 (C = 10), pairs drop
    ("prefill-halved", "qwen3-moe-30b-a3b", {}, (2, 48)),
    ("prefill-one-row", "qwen3-moe-30b-a3b", {}, (1, 64)),
    # decode: C = min(gsz, max(int(gsz k / E * 4), k)) = gsz (drop-free)
    ("decode-drop-free", "qwen3-moe-30b-a3b", {}, (16, 1)),
    # top-1 decode: C = gsz / 2, pairs drop
    ("decode-drops", "qwen3-moe-30b-a3b", {"top_k": 1}, (16, 1)),
    ("decode-halved", "qwen3-moe-30b-a3b", {"top_k": 1}, (96, 1)),
    # 20 experts padded to 32: the padding experts are masked
    ("padded-experts", "qwen3-moe-30b-a3b", {"n_experts": 20}, (2, 40)),
    ("shared-experts", "qwen2-moe-a2.7b", {}, (2, 48)),
    ("shared-decode", "qwen2-moe-a2.7b", {"top_k": 1}, (8, 1)),
    ("bf16", "qwen3-moe-30b-a3b", {"dtype": "bfloat16"}, (2, 48)),
    ("bf16-decode", "qwen3-moe-30b-a3b",
     {"dtype": "bfloat16", "top_k": 1}, (16, 1)),
]


def _configs(arch, kw):
    kw = dict(kw)
    dt = kw.pop("dtype", "float32")
    return (get_smoke_config_j(arch).with_(dtype=getattr(jnp, dt), **kw),
            get_smoke_config(arch).with_(dtype=getattr(torch, dt), **kw))


def _layer(cfg_j, cfg_t, seed: int = 0):
    """The reference's MoE params (router and weights from its init) and
    the port's ``MoE`` holding the same values."""
    p_j = MJ.init_moe(jax.random.PRNGKey(seed), cfg_j)
    m = MT.MoE(cfg_t, "cpu", torch.Generator().manual_seed(seed))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(m, name).copy_(t(p_j[name]))
        if m.shared is not None:
            for name in ("wi_gate", "wi_up", "wo"):
                getattr(m.shared, name).weight.copy_(
                    t(p_j["shared"][name]["w"]).T)
    return p_j, m


def _x(cfg_t, shape, seed: int = 1):
    """Inputs with a direction common to every token, as hidden states
    have: the router favours some experts, so capacities bind."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape + (cfg_t.d_model,))
         + 1.5 * rng.standard_normal(cfg_t.d_model)).astype(np.float32)
    x_t = torch.tensor(x).to(cfg_t.dtype)
    return jnp.asarray(x_t.float().numpy()).astype(
        jnp.bfloat16 if cfg_t.dtype == torch.bfloat16 else jnp.float32), x_t


@functools.partial(jax.jit, static_argnums=2)
def _reference_routing(p_j, x_j, cfg_j):
    """The reference's router probabilities and top-k (its own ops)."""
    logits = x_j.astype(jnp.float32) @ p_j["router"]
    E = cfg_j.padded_experts
    if E > cfg_j.n_experts:
        logits = jnp.where(jnp.arange(E) >= cfg_j.n_experts, -1e30, logits)
    probs = jax.nn.softmax(logits, -1)
    return probs, jax.lax.top_k(probs, cfg_j.top_k)[1]


def _dropped(idx: np.ndarray, gsz: int, C: int, E: int) -> int:
    """(token, expert) pairs beyond their expert's capacity, counted the
    reference's way (token-major positions within each group)."""
    b, s, k = idx.shape
    g = idx.reshape(-1, gsz * k)
    n = 0
    for row in g:
        counts = np.zeros(E, int)
        for e in row:
            n += counts[e] >= C
            counts[e] += 1
    return n


def _agreeing_groups(p_j, x_j, cfg_j, m, x_t, cfg_t, gsz):
    """Groups whose tokens chose the same expert sets in both packages;
    every token that differs must be a near-tie."""
    probs, idx_j = map(np.asarray, _reference_routing(p_j, x_j, cfg_j))
    _, _, idx_t = MT._route(m, x_t, cfg_t)
    idx_t = idx_t.numpy()
    k = cfg_t.top_k
    same = (np.sort(idx_j, -1) == np.sort(idx_t, -1)).all(-1)   # (b, s)
    srt = -np.sort(-probs, -1)
    for tok in zip(*np.nonzero(~same)):
        gap = srt[tok][k - 1] - srt[tok][k]
        assert gap <= TIE, f"token {tok}: routing differs, gap {gap:.3g}"
    return same.reshape(-1, gsz).all(-1), idx_j


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_matches_reference(case):
    """Outputs and aux of ``moe_apply`` against the reference's on the
    same weights and inputs; the drop-exercising cases must drop."""
    _, arch, kw, shape = case
    cfg_j, cfg_t = _configs(arch, kw)
    p_j, m = _layer(cfg_j, cfg_t)
    x_j, x_t = _x(cfg_t, shape)
    gsz, C = MT.group_and_capacity(*shape, cfg_t)
    ok, idx = _agreeing_groups(p_j, x_j, cfg_j, m, x_t, cfg_t, gsz)
    assert ok.mean() >= 0.5
    n_drop = _dropped(idx, gsz, C, cfg_t.padded_experts)
    if case[0] in ("prefill-halved", "decode-drops", "padded-experts",
                   "shared-experts", "shared-decode"):
        assert n_drop > 0, "the case drops no pair"
    if case[0] == "decode-drop-free":
        assert C == gsz and n_drop == 0
    if case[0] in ("prefill-halved", "decode-halved"):
        assert gsz == 32 and gsz < cfg_t.moe_group_size
    y_j, aux_j = MOE_J(p_j, x_j, cfg_j)
    with torch.no_grad():
        y_t, aux_t = MT.moe_apply(m, x_t, cfg_t)
    assert y_t.dtype == cfg_t.dtype and y_t.shape == x_t.shape
    tol = TOL[str(cfg_t.dtype).replace("torch.", "")]
    got = y_t.float().numpy().reshape(-1, gsz, cfg_t.d_model)[ok]
    want = np.asarray(y_j, np.float32).reshape(-1, gsz, cfg_t.d_model)[ok]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


@pytest.mark.parametrize("case", [c for c in CASES if "bf16" not in c[0]],
                         ids=[c[0] for c in CASES if "bf16" not in c[0]])
def test_drop_free_capacity_equals_dense_oracle(case):
    """With ``capacity_factor`` and ``decode_capacity_factor`` at E / k
    (C = the group size) no pair drops, and ``moe_apply`` equals both
    packages' ``moe_apply_dense_ref``; at the config's own capacity the
    drop cases differ from it."""
    _, arch, kw, shape = case
    cfg_j, cfg_t = _configs(arch, kw)
    p_j, m = _layer(cfg_j, cfg_t)
    x_j, x_t = _x(cfg_t, shape)
    with torch.no_grad():
        dense_t = MT.moe_apply_dense_ref(m, x_t, cfg_t)
    dense_j = DENSE_J(p_j, x_j, cfg_j)
    np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j),
                               rtol=TOL["float32"], atol=TOL["float32"])
    f = cfg_t.padded_experts / cfg_t.top_k
    free = cfg_t.with_(capacity_factor=f, decode_capacity_factor=f)
    gsz, C = MT.group_and_capacity(*shape, free)
    assert C == gsz
    with torch.no_grad():
        y_free, _ = MT.moe_apply(m, x_t, free)
        y_own, _ = MT.moe_apply(m, x_t, cfg_t)
    np.testing.assert_allclose(y_free.numpy(), dense_t.numpy(),
                               rtol=TOL["float32"], atol=TOL["float32"])
    gsz, C = MT.group_and_capacity(*shape, cfg_t)
    idx = np.asarray(_reference_routing(p_j, x_j, cfg_j)[1])
    if _dropped(idx, gsz, C, cfg_t.padded_experts):
        assert not torch.allclose(y_own, dense_t, rtol=1e-3, atol=1e-3)


def test_group_and_capacity_follow_the_reference_rule():
    """Group sizes and capacities of the full-width configs at the shapes
    the engines give them: decode is drop-free up to 8 rows a group for
    qwen3-moe and up to 4 for qwen2-moe (C = 8 at 16 rows, 4 at 8)."""
    q3, q2 = get_config("qwen3-moe-30b-a3b"), get_config("qwen2-moe-a2.7b")
    assert q2.padded_experts == 64
    assert MT.group_and_capacity(8, 1, q3) == (8, 8)
    assert MT.group_and_capacity(16, 1, q3) == (16, 8)
    assert MT.group_and_capacity(4, 1, q2) == (4, 4)
    assert MT.group_and_capacity(8, 1, q2) == (8, 4)
    assert MT.group_and_capacity(1, 128, q3) == (128, 10)
    assert MT.group_and_capacity(1, 1024, q3) == (512, 40)
    assert MT.group_and_capacity(1, 1400, q3) == (8, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_moe_leaves(arch):
    """Every leaf of the reference's MoE params (router, expert weights
    stacked on L and not transposed, the shared experts' dense weights)
    lands in the port's model and comes back unchanged."""
    cfg_j = get_smoke_config_j(arch)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    model = RT.init_params(get_smoke_config(arch), device="cpu")
    want = _flatten(p_j)
    bridge.load_reference(model, want)
    got = bridge.export_reference(model)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    moe = model.layers[1].moe
    np.testing.assert_array_equal(moe.w_down.numpy(),
                                  np.asarray(want["layers/moe/w_down"])[1])
    assert model.layers[0].mlp is None
    assert ("layers/moe/shared/wo/w" in want) == (arch == "qwen2-moe-a2.7b")
