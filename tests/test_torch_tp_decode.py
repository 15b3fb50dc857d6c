"""The generic decode on a rank mesh, the dry run's collectives, and a
failing rank, on the CPU.

* ``registry.make_cache`` / ``decode_step`` on a process group of 8 gloo
  ranks (``launch/ranks.py``; the rank side is
  ``tests/torch_tp_train_scenarios.py`` ``decode_group``, run once for
  the file): glm4-9b SMOKE (the reference's weights; 2 KV heads, which
  do not split over 4) on a (2, 4) mesh, its 64-position cache cut into
  8 segments over ("data", "model") (``seq_shard``) or into 4 over
  "model" with the rows over "data" (the few-KV-head fallback), 12 steps
  from an empty cache — so that most segments stay empty throughout —
  against the reference's single-device ``decode_step`` at the
  scenario's 2e-4 (``tests/multidev_scenarios.py:129-155``, a scenario
  the reference itself fails) and the port's unsharded decode at 1e-5;
  the append-buffer decode (``decode_window``) likewise against the
  port; seamless's (sequence-sharded) and zamba2's decode on (2, 4)
  against the port;
  mamba2-2.7b SMOKE's SSM cache cut by head and channel on (1, 2);
* the dry run's counted collectives on the abstract 16 x 16 mesh, by
  hand from the layer count and widths: qwen3-1.7b's decode_32k and
  train_4k cells; the roofline's collective term filled from them;
* a rank that raises in its backward makes ``spawn`` raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_train_scenarios as S
from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.configs import shapes as SH
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MESH
from repro_torch.launch import ranks
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps
from repro_torch.models import registry as R
from repro_torch.sharding import rules

REF_TOL = 2e-4
TP_TOL = 1e-5


def _ref_decode(p_j, cfg_j) -> list:
    """The reference's single-device decode: ``N_DECODE`` steps' logits."""
    step = jax.jit(lambda p, c, t: RJ.decode_step(p, c, {"tokens": t},
                                                  cfg_j))
    cache = RJ.make_cache(p_j, cfg_j, S.DECODE_B, S.DECODE_S,
                          dtype=jnp.float32)
    out = []
    for i in range(S.N_DECODE):
        lg, cache = step(p_j, cache, jnp.asarray(S.decode_tokens(i),
                                                 jnp.int32))
        out.append(np.asarray(lg))
    return out


@pytest.fixture(scope="module")
def run():
    cfg_j = get_smoke_config_j("glm4-9b").with_(dtype=jnp.float32)
    p_j = jax.jit(RJ.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg_j)
    inputs = {"glm4": _flatten(p_j), "mamba2": 1}
    results = ranks.spawn(S.decode_group, 8, "cpu", args=(inputs,),
                          timeout=300)
    whole = {"ref": _ref_decode(p_j, cfg_j)}
    glm4 = S.family_cfg("glm4-9b")
    whole["glm4"] = S.decode_run(S.load(glm4, inputs["glm4"]), glm4)[0]
    win = glm4.with_(decode_window=S.DECODE_WINDOW)
    whole["window"] = S.decode_run(S.load(win, inputs["glm4"]), win)[0]
    ssm = S.family_cfg("mamba2-2.7b")
    whole["mamba2"] = S.decode_run(S.load(ssm, inputs["mamba2"]), ssm)[0]
    for i, (arch, _) in enumerate(S.DECODE_FAMILIES):
        cfg = S.family_cfg(arch)
        whole[arch] = S.decode_run(S.load(cfg, i), cfg)[0]
    return results, whole


def _assemble(parts, b: int) -> list:
    """The ranks' (rows, vocab slice) logits of each step as the whole
    (b, V) logits: the slices of "model" side by side, the rows of the
    data coordinates stacked when they are cut."""
    out = []
    for i in range(S.N_DECODE):
        rows = {}
        for p in parts:
            d, m = p["coords"][0], p["coords"][-1]
            rows.setdefault(d, {})[m] = p["logits"][i]
        blocks = [np.concatenate([rows[d][m] for m in sorted(rows[d])], -1)
                  for d in sorted(rows)]
        lg = (np.concatenate(blocks, 0) if blocks[0].shape[0] < b
              else blocks[0])
        for blk in blocks[1:]:
            if blocks[0].shape[0] == b:
                np.testing.assert_array_equal(blk, blocks[0])
        out.append(lg[:, :256])
    return out


@pytest.mark.parametrize("seq_shard", [True, False])
def test_sequence_sharded_decode_matches_reference(run, seq_shard):
    """glm4 SMOKE's decode on (2, 4), the cache's sequence over ("data",
    "model") or over "model": every step's logits equal the reference's
    single-device ``decode_step`` at 2e-4 and the port's unsharded decode
    at 1e-5."""
    results, whole = run
    parts = [r[("glm4", seq_shard)] for r in results]
    got = _assemble(parts, S.DECODE_B)
    for i in range(S.N_DECODE):
        np.testing.assert_allclose(got[i], whole["ref"][i][:, :256],
                                   rtol=REF_TOL, atol=REF_TOL)
        np.testing.assert_allclose(got[i], whole["glm4"][i][:, :256],
                                   rtol=TP_TOL, atol=TP_TOL)


def test_sequence_cut_layouts_and_empty_segments(run):
    """With ``seq_shard`` every rank holds both rows and 8 of the 64
    positions, segment (data, model) in order; without it its data
    coordinate's row and 16 positions.  The 12 decoded positions fill
    the first segments only: most ranks' segments stayed empty (length
    0) at every step, and their merge weighed them out."""
    results = run[0]
    empty = 0
    for r in results:
        d, m = r[("glm4", True)]["coords"]
        on = r[("glm4", True)]
        assert on["rows"] == (0, S.DECODE_B)
        assert on["segment"] == ((d * 4 + m) * 8, 8, ("data", "model"))
        assert on["k_shape"][1:3] == (S.DECODE_B, 8)
        off = r[("glm4", False)]
        assert off["rows"] == (d, d + 1)
        assert off["segment"] == (m * 16, 16, ("model",))
        empty += on["segment"][0] >= S.N_DECODE
    assert empty == 6


@pytest.mark.parametrize("seq_shard", [True, False])
def test_append_buffer_decode_on_a_mesh(run, seq_shard):
    """The append-buffer decode (``decode_window`` 8: every token in the
    suffix ring, replicated over "model", which wraps after 8 steps)
    merged with the cut prefix's segments: the unsharded port's
    logits."""
    results, whole = run
    got = _assemble([r[("window", seq_shard)] for r in results], S.DECODE_B)
    for i in range(S.N_DECODE):
        np.testing.assert_allclose(got[i], whole["window"][i][:, :256],
                                   rtol=TP_TOL, atol=TP_TOL)


@pytest.mark.parametrize("arch", [a for a, _ in S.DECODE_FAMILIES])
def test_family_decode_on_a_mesh(run, arch):
    """seamless with its self and cross K/V over ("data", "model"), and
    zamba2 with its shared attention's KV heads over "model" and its SSM
    states by head, on (2, 4): the unsharded port's logits."""
    results, whole = run
    got = _assemble([r[arch] for r in results], S.DECODE_B)
    for i in range(S.N_DECODE):
        np.testing.assert_allclose(got[i], whole[arch][i][:, :256],
                                   rtol=TP_TOL, atol=TP_TOL)


def test_ssm_cache_cut_on_a_mesh(run):
    """mamba2 SMOKE on (1, 2): each rank's SSM cache holds half the
    heads' states and half the conv_x channels (B and C whole), and the
    decode's logits are the unsharded port's."""
    results, whole = run
    parts = sorted((r["mamba2"] for r in results if "mamba2" in r),
                   key=lambda p: p["coords"])
    assert len(parts) == 2
    cfg = S.family_cfg("mamba2-2.7b")
    L, b, k = cfg.n_layers, S.DECODE_B, cfg.ssm_conv
    GN = cfg.ssm_groups * cfg.ssm_state
    for p in parts:
        assert p["shapes"] == {
            "state": (L, b, cfg.n_ssm_heads // 2, cfg.ssm_head_dim,
                      cfg.ssm_state),
            "conv_x": (L, b, k - 1, cfg.d_inner // 2),
            "conv_B": (L, b, k - 1, GN), "conv_C": (L, b, k - 1, GN)}
    got = _assemble(parts, S.DECODE_B)
    for i in range(S.N_DECODE):
        np.testing.assert_allclose(got[i], whole["mamba2"][i][:, :256],
                                   rtol=TP_TOL, atol=TP_TOL)


# ---------------------------------------------------------------------------
# the dry run's collectives
# ---------------------------------------------------------------------------
G = 16                      # each axis of the abstract 16 x 16 mesh
F = (G - 1) / G


def _ar(n: float) -> float:
    return 2 * n * F


@pytest.fixture(scope="module")
def decode_cell():
    """The dry run's record of qwen3-1.7b's decode_32k cell (16 x 16)."""
    return DRY.run_cell("qwen3-1.7b", "decode_32k", False, verbose=False)


def test_dryrun_decode_collectives_by_hand(decode_cell):
    """qwen3-1.7b decode_32k as the (16, 16) mesh's representative rank:
    8 rows a data shard; 8 KV heads do not split over 16, so the cache's
    sequence is cut over "model" and each of the 28 layers all-gathers
    every head's query (bf16) and the segments' (out, lse) (f32, 16 x 128
    + 16 a row), then all-reduces its attention's and its MLP's outputs;
    the embedding all-reduces once."""
    cfg = get_config("qwen3-1.7b")
    cell = SH.SHAPES["decode_32k"]
    b = cell.global_batch // G
    H, dh, d = cfg.n_heads, cfg.d_head, cfg.d_model
    q = G * b * dh * (H // G) * 2 * F
    merge = G * b * (H * dh + H) * 4 * F
    act = _ar(b * d * 2)
    want = cfg.n_layers * (q + merge + 2 * act) + act
    rec = decode_cell["collectives"]
    assert rec["total_collective_bytes"] == pytest.approx(want, rel=1e-12)
    assert rec["collective_counts"] == {
        "all-gather": 2 * cfg.n_layers, "all-reduce": 2 * cfg.n_layers + 1,
        "reduce-scatter": 0}


def test_dryrun_train_collectives_by_hand():
    """qwen3-1.7b train_4k as the representative rank: 16 rows a data
    shard in 4 microbatches of 4 x 4096.  A microbatch all-reduces a
    (4, 4096, 2048) bf16 activation 5 times a layer (the attention's and
    the MLP's outputs, the attention's again in the backward's recompute,
    which stops before the MLP's, and the two inputs' gradients) and
    twice more (the embedding, the head's input gradient), and each of
    the loss's 8 chunks all-reduces its (4, 512) f32 maximum, sum and
    label logit, twice (the recompute).  A step then sums the replicated
    gradients a rank computes a part of (the qk-norm scales and the whole
    K/V projections, 8 KV heads not splitting over 16), reduce-scatters
    the ZeRO-1-cut gradients and all-gathers their parameters (bf16),
    all-reduces the others over "data", and all-reduces the clip norm
    and three metrics."""
    cfg = get_config("qwen3-1.7b")
    mesh = MESH.make_production_mesh()
    accum = steps.default_accum(cfg, mesh, "train_4k")
    cell = SH.SHAPES["train_4k"]
    b, s, L = cell.global_batch // G // accum, cell.seq_len, cfg.n_layers
    nc = s // 512
    want = accum * ((5 * L + 2) * _ar(b * s * cfg.d_model * 2)
                    + 6 * nc * _ar(b * (s // nc) * 4))
    want += L * (2 * _ar(cfg.d_head * 4)
                 + 2 * _ar(cfg.n_kv_heads * cfg.d_head * cfg.d_model * 4))
    meta = R.init_params(cfg, device="meta")
    p_specs = rules.param_specs(meta, cfg, mesh)
    o_specs = rules.opt_state_specs(meta, cfg, mesh)
    for n, p in meta.named_parameters():
        shape = ((1,) if len(p_specs[n]) == p.dim() + 1 else ()) + \
            tuple(p.shape)
        local = float(np.prod(rules.shard_shape(shape, p_specs[n], mesh)))
        want += ((4 + 2) * local * F if o_specs[n] != p_specs[n]
                 else _ar(4 * local))
    want += 4 * _ar(4)
    rec = DRY.count_collectives(cfg, mesh, "train_4k")
    assert accum == 4
    assert rec["total_collective_bytes"] == pytest.approx(want, rel=1e-12)


def test_roofline_collective_term_is_filled(decode_cell):
    """A dry-run record's collectives give the roofline its NVLink term."""
    rec = decode_cell
    row = RL.roofline_row(rec)
    assert row["t_collective_s"] == pytest.approx(
        rec["collectives"]["total_collective_bytes"] / RL.NVLINK_BW)
    assert row["t_collective_s"] > 0


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------
def test_a_rank_failing_in_its_backward_makes_spawn_raise():
    """Rank 1 of a (1, 2) mesh raises in its backward, after the
    forward's collectives: ``spawn`` raises its error (the waiting rank
    is stopped), no rank carries on."""
    with pytest.raises(RuntimeError, match="backward failed on purpose"):
        ranks.spawn(S.failing_backward, 2, "cpu", timeout=120)
