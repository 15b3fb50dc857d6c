"""The append-buffer decode (``cfg.decode_window``) on the port against the
reference's, on the same numpy inputs and carried-over weights:

* the plain contiguous decode with a window end and its log-sum-exp
  (``kernels/ref.py`` ``decode_attention_ref``) against the reference's
  ``decode_attention_parts`` (out = acc / l, lse = m + log l);
* the port's ``decode_attention_parts`` / ``combine_attention_parts`` and
  ``attention_decode_split_apply`` against the reference's at prefix
  lengths 0 and > 0, with and without a window, f32 and bf16, and the ring
  write clamped at ``pos >= W``;
* ``decode_step`` with the split cache for qwen3-1.7b, gemma3-27b and
  glm4-9b SMOKE against the reference's split decode and the port's
  regular decode (the counterpart of ``tests/test_models.py``'s
  ``test_split_cache_decode_matches_regular``), and with
  ``get_optimized_config``'s overrides;
* the kernel's arithmetic (``csrc/decode_split.cuh`` with ``ContigKV``,
  a window end and an lse), emulated on the CPU: each row's left edge
  ``lo = max(window_end - window, 0)``, its live splits, the merge's (m,
  l) and the lse from them.

Tolerances: 2e-4 in f32 (sums in another order, as the other model
tests), 2e-2 in bf16 (the two packages round bf16 at other places); the
kernel emulation against the plain version at ``chip_smoke.TOL``."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.configs import OPTIMIZED_OVERRIDES as OVR_J
from repro.models import layers as LJ
from repro.models import registry as RJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import OPTIMIZED_OVERRIDES, get_optimized_config, \
    get_smoke_config, ARCHS
from repro_torch.kernels import decode_attention as DAT
from repro_torch.kernels import paged_attention as PAT
from repro_torch.kernels import ref as REFT
from repro_torch.models import bridge
from repro_torch.models import layers as LT
from repro_torch.models import registry as RT

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-3, 1e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOG2E = 1.4426950408889634


def _rand(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _close(got, want, tol: float) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# =============================================================================
# the plain decode's window end and lse against decode_attention_parts
# =============================================================================
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,query_pos,window", [
    (40, 40, 0), (40, 47, 16), (40, 60, 16), (0, 10, 0), (40, 100, 16),
    (64, 63, 64)])
def test_plain_decode_lse_matches_reference_parts(dtype, length, query_pos,
                                                  window):
    """out = acc / l and lse = m + log l of the reference's segment, with the
    window ending at ``query_pos + 1`` (the prefix segment's window end);
    a segment that sees nothing (length 0, or a window past it) gives 0
    and -inf."""
    b, S, H, K, dh = 2, 64, 8, 2, 32
    qn, kn, vn = (_rand((b, 1, H, dh), 1), _rand((b, S, K, dh), 2),
                  _rand((b, S, K, dh), 3))
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, dtype) for x in (qn, kn, vn))
    acc, m, l = LJ.decode_attention_parts(
        qj, kj, vj, jnp.int32(length), pos_offset=0,
        query_pos=jnp.int32(query_pos), window=window or None)
    out, lse = REFT.decode_attention_ref(
        LT._scaled_q(qt[:, 0], kt), kt, vt,
        torch.tensor(length, dtype=torch.int32), sm_scale=1.0,
        window=window, window_end=torch.tensor(query_pos + 1,
                                               dtype=torch.int32),
        return_lse=True)
    l = np.asarray(l, np.float32).reshape(b, H)
    seen = l > 0
    want = (np.asarray(acc, np.float32).reshape(b, H, dh)
            / np.maximum(l, 1e-30)[..., None])
    _close(out.numpy(), want, TOL[dtype])
    lse = lse.numpy()
    want_lse = np.asarray(m, np.float32).reshape(b, H) + np.log(
        np.where(seen, l, 1.0))
    assert np.all(np.isneginf(lse[~seen])) and np.all(np.isfinite(lse[seen]))
    _close(lse[seen], want_lse[seen], TOL[dtype])
    assert np.all(out.numpy()[~seen] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parts_and_combine_match_reference(dtype):
    """The port's plain ``decode_attention_parts`` and
    ``combine_attention_parts`` against the reference's on a prefix and a
    suffix segment (offset, window), and ``combine_lse_parts`` of the
    normalised segments against the same merge."""
    b, S, W, H, K, dh = 2, 48, 16, 8, 4, 32
    prefix_len, pos, window = 30, 40, 20
    arrs = [_rand(sh, i) for i, sh in enumerate(
        [(b, 1, H, dh), (b, S, K, dh), (b, S, K, dh), (b, W, K, dh),
         (b, W, K, dh)])]
    (qj, qt), (pkj, pkt), (pvj, pvt), (skj, skt), (svj, svt) = (
        _both(x, dtype) for x in arrs)
    slot = pos - prefix_len
    seg_j = [LJ.decode_attention_parts(qj, pkj, pvj, jnp.int32(prefix_len),
                                       query_pos=jnp.int32(pos),
                                       window=window),
             LJ.decode_attention_parts(qj, skj, svj, jnp.int32(slot + 1),
                                       pos_offset=jnp.int32(prefix_len),
                                       query_pos=jnp.int32(pos),
                                       window=window)]
    seg_t = [LT.decode_attention_parts(qt, pkt, pvt, prefix_len,
                                       query_pos=pos, window=window),
             LT.decode_attention_parts(qt, skt, svt, slot + 1,
                                       pos_offset=prefix_len, query_pos=pos,
                                       window=window)]
    for pj, pt in zip(seg_j, seg_t):
        for a, c in zip(pj, pt):
            _close(c.numpy(), a, TOL[dtype])
    want = LJ.combine_attention_parts(seg_j)
    _close(LT.combine_attention_parts(seg_t).numpy(), want, TOL[dtype])
    normed = [((acc / l.clamp(min=1e-30)[..., None]).reshape(b, H, dh),
               (m + torch.log(l)).reshape(b, H)) for acc, m, l in seg_t]
    _close(LT.combine_lse_parts(normed).numpy(),
           np.asarray(want, np.float32).reshape(b, H, dh), TOL[dtype])


# =============================================================================
# attention_decode_split_apply on one layer, against the reference's
# =============================================================================
# the reference's split apply, compiled once per config and window (eager
# jax compiles each of its ops on first use, most of a test's time)
_split_apply_j = jax.jit(LJ.attention_decode_split_apply,
                         static_argnums=(2,), static_argnames=("window",))


@functools.lru_cache(maxsize=None)
def _one_layer(arch: str, dtype: str):
    cfg_j = get_smoke_config_j(arch).with_(n_layers=1, dtype=DT[dtype][0])
    cfg_t = get_smoke_config(arch).with_(n_layers=1, dtype=DT[dtype][1])
    p_j = jax.jit(RJ.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(3), cfg_j)
    model = RT.init_params(cfg_t, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    attn_j = jax.tree.map(lambda a: a[0], p_j["layers"]["attn"])
    return cfg_j, attn_j, model.layers[0].attn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefix_len,pos,window,W", [
    (0, 5, 0, 16),       # the reference's own flow: an empty prefix
    (0, 5, 4, 16),
    (24, 30, 0, 16),     # a prefix, the ring partly written
    (24, 30, 8, 16),     # the window ends past the prefix
    (24, 44, 0, 16),     # slot >= W: the write clamps to W - 1
    (0, 20, 6, 16)])
def test_split_apply_matches_reference(dtype, prefix_len, pos, window, W):
    """Output and ring of the port's split apply against the reference's
    on one qwen3 SMOKE attention layer (prefix and ring random)."""
    cfg_j, attn_j, attn_t = _one_layer("qwen3-1.7b", dtype)
    b, S = 2, 32
    K, dh = cfg_j.n_kv_heads, cfg_j.d_head
    arrs = [_rand((b, 1, cfg_j.d_model), 10), _rand((b, S, K, dh), 11),
            _rand((b, S, K, dh), 12), _rand((b, W, K, dh), 13),
            _rand((b, W, K, dh), 14)]
    (xj, xt), (pkj, pkt), (pvj, pvt), (skj, skt), (svj, svt) = (
        _both(x, dtype) for x in arrs)
    d_rot = int(cfg_j.d_head * cfg_j.partial_rotary)
    cos_j, sin_j = LJ.rope_table(jnp.asarray([pos], jnp.int32), d_rot,
                                 cfg_j.rope_theta)
    cos_t, sin_t = LT.rope_table(torch.tensor([pos], dtype=torch.int32),
                                 d_rot, cfg_j.rope_theta)
    out_j, skj2, svj2 = _split_apply_j(
        attn_j, xj, cfg_j, cos_j, sin_j, pkj, pvj, skj, svj, jnp.int32(pos),
        jnp.int32(prefix_len), window=window or None)
    i32 = dict(dtype=torch.int32)
    out_t = LT.attention_decode_split_apply(
        attn_t, xt, cos_t, sin_t, pkt, pvt, skt, svt,
        torch.tensor(pos, **i32), torch.tensor(prefix_len, **i32),
        window=window)
    _close(out_t.float().numpy(), out_j, TOL[dtype])
    _close(skt.float().numpy(), skj2, TOL[dtype])
    _close(svt.float().numpy(), svj2, TOL[dtype])
    assert torch.equal(pkt, _both(arrs[1], dtype)[1])      # read only


# =============================================================================
# decode_step with the split cache, three SMOKE configs
# =============================================================================
B, S = 2, 6
# the reference's decode step, compiled once per config (eager jax takes
# most of a test's time otherwise)
_dec_j = jax.jit(RJ.decode_step, static_argnums=(3,))


def _models(arch: str, **kw):
    cfg_j = get_smoke_config_j(arch).with_(dtype=jnp.float32, **kw)
    cfg_t = get_smoke_config(arch).with_(dtype=torch.float32, **kw)
    p_j = RJ.init_params(jax.random.PRNGKey(0), cfg_j)
    model = RT.init_params(cfg_t, device="cpu")
    bridge.load_reference(model, _flatten(p_j))
    return cfg_j, p_j, model


def _decode_both(cfg_j, p_j, model, toks, max_len, window):
    """Logits of every step: the reference's and the port's split decode
    (window ``window``) and the port's regular decode."""
    cfg_w = cfg_j.with_(decode_window=window)
    cache_j = RJ.make_cache(p_j, cfg_w, B, max_len, dtype=jnp.float32)
    cfg_t = model.cfg
    cfg_wt = cfg_t.with_(decode_window=window)
    cache_r = RT.make_cache(model, cfg_t, B, max_len, dtype=torch.float32,
                            device="cpu")
    model.cfg = cfg_wt
    cache_s = RT.make_cache(model, cfg_wt, B, max_len, dtype=torch.float32,
                            device="cpu")
    out = []
    for t in range(toks.shape[1]):
        col = toks[:, t:t + 1]
        lj, cache_j = _dec_j(p_j, cache_j,
                                     {"tokens": jnp.asarray(col)}, cfg_w)
        model.cfg = cfg_wt
        ls, cache_s = RT.decode_step(model, cache_s,
                                     {"tokens": torch.tensor(col)}, cfg_wt)
        model.cfg = cfg_t
        lr, cache_r = RT.decode_step(model, cache_r,
                                     {"tokens": torch.tensor(col)}, cfg_t)
        out.append((np.asarray(lj, np.float32), ls.numpy(), lr.numpy()))
    return out, cache_s, cache_r


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-27b", "glm4-9b"])
def test_split_cache_decode_matches_reference_and_regular(arch):
    """Append-buffer decode (``decode_window = S + 4``) == the reference's
    split decode == the port's regular decode, logits at 2e-4 and greedy
    tokens equal, on carried-over weights; the prefix is never written."""
    cfg_j, p_j, model = _models(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg_j.vocab_size, size=(B, S)).astype(np.int32)
    steps, cache_s, _ = _decode_both(cfg_j, p_j, model, toks, S + 4, S + 4)
    for lj, ls, lr in steps:
        _close(ls, lj, TOL["float32"])
        _close(ls, lr, TOL["float32"])
        assert np.array_equal(ls.argmax(-1), lj.argmax(-1))
        assert np.array_equal(ls.argmax(-1), lr.argmax(-1))
    assert not cache_s["k"].any() and int(cache_s["prefix_len"]) == 0
    assert int(cache_s["pos"]) == S


def test_ring_clamp_matches_reference():
    """A ring shorter than the context (W = 3 < 6 steps): once ``pos >=
    W`` the write clamps to slot W - 1 and the whole ring stays visible,
    as in the reference (which then departs from the regular decode)."""
    cfg_j, p_j, model = _models("qwen3-1.7b")
    toks = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, size=(B, S)).astype(np.int32)
    steps, _, _ = _decode_both(cfg_j, p_j, model, toks, S + 4, 3)
    for lj, ls, _ in steps:
        _close(ls, lj, TOL["float32"])
    assert not np.allclose(steps[-1][1], steps[-1][2], atol=1e-2)


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma3-27b"])
def test_split_decode_with_prefix_matches_reference(arch):
    """A prefix of 3 positions taken from a regular decode's cache, the
    rest in the ring: the port's and the reference's split decodes agree,
    and both equal the regular decode's logits and greedy tokens."""
    cfg_j, p_j, model = _models(arch)
    n_pre = 3
    toks = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, size=(B, S)).astype(np.int32)
    cfg_t = model.cfg
    cache_r = RT.make_cache(model, cfg_t, B, S, dtype=torch.float32,
                            device="cpu")
    for t in range(n_pre):
        _, cache_r = RT.decode_step(model, cache_r,
                                    {"tokens": torch.tensor(toks[:, t:t + 1])},
                                    cfg_t)
    W = 4
    cfg_wt, cfg_wj = cfg_t.with_(decode_window=W), cfg_j.with_(decode_window=W)
    model.cfg = cfg_wt
    cache_s = RT.make_cache(model, cfg_wt, B, S, dtype=torch.float32,
                            device="cpu")
    cache_s["k"].copy_(cache_r["k"])
    cache_s["v"].copy_(cache_r["v"])
    cache_s["prefix_len"] = torch.tensor(n_pre, dtype=torch.int32)
    cache_s["pos"] = torch.tensor(n_pre, dtype=torch.int32)
    cache_j = RJ.make_cache(p_j, cfg_wj, B, S, dtype=jnp.float32)
    cache_j = dict(cache_j, k=jnp.asarray(cache_r["k"].numpy()),
                   v=jnp.asarray(cache_r["v"].numpy()),
                   prefix_len=jnp.int32(n_pre), pos=jnp.int32(n_pre))
    for t in range(n_pre, S):
        col = toks[:, t:t + 1]
        model.cfg = cfg_t
        lr, cache_r = RT.decode_step(model, cache_r,
                                     {"tokens": torch.tensor(col)}, cfg_t)
        model.cfg = cfg_wt
        ls, cache_s = RT.decode_step(model, cache_s,
                                     {"tokens": torch.tensor(col)}, cfg_wt)
        lj, cache_j = _dec_j(p_j, cache_j,
                                     {"tokens": jnp.asarray(col)}, cfg_wj)
        _close(ls.numpy(), lj, TOL["float32"])
        _close(ls.numpy(), lr.numpy(), TOL["float32"])
        assert np.array_equal(ls.numpy().argmax(-1), lr.numpy().argmax(-1))
    model.cfg = cfg_t


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma3-27b", "qwen2-vl-7b"])
def test_optimized_overrides_decode_matches_reference(arch):
    """``get_optimized_config``'s overrides (``decode_window=256``,
    ``remat_policy``) on the SMOKE config: the port's decode equals the
    reference's, logits at 2e-4 and greedy tokens equal; the overrides
    are the reference's."""
    assert OPTIMIZED_OVERRIDES == OVR_J
    ov = OPTIMIZED_OVERRIDES[arch]
    assert ov["decode_window"] == 256
    cfg_j, p_j, model = _models(arch, **ov)
    toks = np.random.default_rng(5).integers(
        0, cfg_j.vocab_size, size=(B, 6)).astype(np.int32)
    cache_j = RJ.make_cache(p_j, cfg_j, B, 8, dtype=jnp.float32)
    cache_t = RT.make_cache(model, model.cfg, B, 8, dtype=torch.float32,
                            device="cpu")
    assert tuple(cache_t["sk"].shape) == tuple(cache_j["sk"].shape)
    for t in range(toks.shape[1]):
        col = toks[:, t:t + 1]
        lj, cache_j = _dec_j(p_j, cache_j,
                                     {"tokens": jnp.asarray(col)}, cfg_j)
        lt, cache_t = RT.decode_step(model, cache_t,
                                     {"tokens": torch.tensor(col)}, model.cfg)
        _close(lt.numpy(), lj, TOL["float32"])
        assert np.array_equal(lt.numpy().argmax(-1),
                              np.asarray(lj).argmax(-1))


def test_get_optimized_config_every_arch():
    """Every arch's optimized config is its FULL config with the
    reference's overrides (the same fields as the reference's)."""
    from repro.configs import get_optimized_config as goc_j
    for arch in ARCHS:
        cfg = get_optimized_config(arch)
        ref = goc_j(arch)
        assert cfg.decode_window == ref.decode_window
        assert cfg.remat_policy == ref.remat_policy
        assert cfg.n_layers == ref.n_layers and cfg.name == ref.name


# =============================================================================
# the kernel's window end and lse, emulated on the CPU
# =============================================================================
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_emulation(q, kc, vc, lengths, window, window_end, n_sm):
    """csrc/decode_split.cuh with ContigKV, a window end and an lse on the
    CPU: each row's lo = max(end - window, 0) (end = window_end, or its
    length), first page lo / 16, its visible pages cut into the host's
    splits (planned from S alone), one partial (acc, m in log2 units, l)
    per live split, merged with weight 0 for m = -inf; out = acc / l and
    lse = (M + log2 L) ln 2, -inf for a row that sees nothing.  Returns
    (out f32, lse f32, n_split)."""
    b, H, dh = q.shape
    S, K = kc.shape[1], kc.shape[2]
    g = H // K
    page = DAT.CONTIG_PAGE
    n_split, min_pages, ctas = PAT.split_plan(
        _cdiv(S, page), page, b * K, n_sm, PAT.DECODE_CTAS_PER_SM[q.dtype])
    lens = np.broadcast_to(np.asarray(lengths), (b,))
    ends = lens if window_end is None else \
        np.broadcast_to(np.asarray(window_end), (b,))

    def visible(length, end):
        lo = max(int(end) - window, 0) if window > 0 else 0
        pf = lo // page
        return lo, pf, max(_cdiv(min(int(length), S), page) - pf, 0)

    total = sum(visible(x, e)[2] for x, e in zip(lens, ends))
    out = torch.zeros(b, H, dh)
    lse = torch.zeros(b, H)
    for row in range(b):
        length = min(int(lens[row]), S)
        lo, pf, valid = visible(lens[row], ends[row])
        pps = max(min_pages, _cdiv(valid, n_split), _cdiv(total * K, ctas))
        n_live = max(_cdiv(valid, pps), 1)
        assert n_live <= n_split
        for kvh in range(K):
            qg = q[row, kvh * g:(kvh + 1) * g].float()
            parts = []
            for s in range(n_live):
                page0 = pf * page + s * pps * page
                p0, p1 = max(page0, lo), min(page0 + pps * page, length)
                if p1 <= p0:
                    parts.append((torch.zeros(g, dh),
                                  torch.full((g,), -math.inf),
                                  torch.zeros(g)))
                    continue
                sc = qg @ kc[row, p0:p1, kvh].float().T * (dh ** -0.5 * LOG2E)
                m = sc.max(-1).values
                p = torch.exp2(sc - m[:, None])
                parts.append((p @ vc[row, p0:p1, kvh].float(), m,
                              p.sum(-1)))
            M = torch.stack([m for _, m, _ in parts]).max(0).values
            Mz = torch.where(M == -math.inf, torch.zeros_like(M), M)
            acc, L = torch.zeros(g, dh), torch.zeros(g)
            for a, m, l in parts:
                c = torch.where(m == -math.inf, torch.zeros_like(m),
                                torch.exp2(m - Mz))
                acc += c[:, None] * a
                L += c * l
            out[row, kvh * g:(kvh + 1) * g] = acc / L.clamp_min(1e-30)[:, None]
            lse[row, kvh * g:(kvh + 1) * g] = torch.where(
                M == -math.inf, torch.full_like(M, -math.inf),
                (M + torch.log2(L.clamp_min(1e-30))) * math.log(2))
    return out, lse, n_split


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,H,K,dh,lengths,window,window_end,n_sm", [
    # the prefix segment: a shared length, the window's end past it
    (2, 256, 8, 2, 32, 200, 64, 230, 132),
    (2, 256, 8, 2, 32, 200, 64, 300, 132),     # window wholly past: empty
    (3, 1000, 4, 2, 64, 1000, 128, (1000, 40, 1020), 132),   # per-row end
    (2, 96, 8, 4, 32, 0, 16, 10, 132),          # length 0: out 0, lse -inf
    # the suffix ring: its length is slot + 1, its window end the default
    (4, 64, 16, 2, 32, 40, 24, None, 132),
    (4, 64, 16, 2, 32, 90, 24, None, 132),      # slot past the ring
    (2, 2048, 4, 1, 64, 2048, 1024, 2100, 2)])  # few SMs: long runs
def test_kernel_window_end_and_lse_emulation(dtype, b, S, H, K, dh, lengths,
                                             window, window_end, n_sm):
    """The emulated kernel (window end, lse) against the plain version."""
    td = DT[dtype][1]
    q = torch.tensor(_rand((b, H, dh), 20)).to(td)
    kc = torch.tensor(_rand((b, S, K, dh), 21)).to(td)
    vc = torch.tensor(_rand((b, S, K, dh), 22)).to(td)
    i32 = dict(dtype=torch.int32)
    ln = torch.tensor(lengths, **i32)
    we = None if window_end is None else torch.tensor(window_end, **i32)
    out, lse, _ = split_emulation(q, kc, vc, lengths, window, window_end,
                                  n_sm)
    want, want_lse = REFT.decode_attention_ref(q, kc, vc, ln, window=window,
                                               window_end=we,
                                               return_lse=True)
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(out, want, atol=atol, rtol=rtol)
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), empty)
    torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=atol,
                               rtol=rtol)
    assert not out[empty].any()


def test_decode_wrapper_passes_window_end_and_lse(monkeypatch):
    """The contiguous decode's wrapper, its device check and build patched
    out: with ``return_lse`` it hands the kernel an f32 output (b, H, dh)
    and an f32 lse (b, H) and returns both; the window end goes through
    as given, () or (b,), and without one an empty int32 tensor (the
    kernel's "none"); the plan is the one without them; per-row lengths
    with an lse are refused (the kernel's form takes one shared length)."""
    from repro_torch.kernels import _build
    calls = []

    class Ext:
        def decode(self, *args):
            calls.append(args)

    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "counters", lambda device, n: torch.zeros(
        max(n, 4096), dtype=torch.int32))
    monkeypatch.setattr(_build, "extension", lambda verbose=False: Ext())
    b, S, H, K, dh = 4, 256, 32, 2, 128
    q = torch.zeros(b, H, dh, dtype=torch.bfloat16)
    kc = torch.zeros(b, S, K, dh, dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)
    ln = torch.tensor(200, **i32)
    for we in (torch.tensor(230, **i32), torch.full((b,), 230, **i32)):
        out, lse = DAT.decode_attention(q, kc, kc, ln, window=64,
                                        window_end=we, return_lse=True)
        args = calls[-1]
        assert args[4] is we and args[5] is out and args[6] is lse
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == (b, H, dh) and lse.shape == (b, H)
        assert args[-1] == 64
    plain = DAT.decode_attention(q, kc, kc, ln)
    args = calls[-1]
    assert args[4].numel() == 0 and args[4].dtype == torch.int32
    assert args[6].numel() == 0 and plain.dtype == torch.bfloat16
    assert args[9:12] == calls[0][9:12]
    with pytest.raises(ValueError, match="window_end"):
        DAT.decode_attention(q, kc, kc, ln, window_end=torch.zeros(
            (b + 1,), **i32))
    with pytest.raises(ValueError, match="one shared"):
        DAT.decode_attention(q, kc, kc, torch.full((b,), 200, **i32),
                             return_lse=True)
