"""The plain versions of the port's attention kernels against the
reference's Pallas kernels (interpret mode) and jnp oracles, on the same
numpy inputs; and the CPU dispatch of ``kernels/ops.py``.

Tolerances are the reference's ``tests/test_kernels.py::_tols``: f32
3e-5 (the sums run in another order), bf16 2e-2 (bf16 rounding of the
output).  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against these plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels import decode_attention as DAJ
from repro.kernels import flash_attention as FAJ
from repro.kernels import paged_attention as PAJ
from repro.kernels import ref as REFJ
from repro.models import layers as LJ
from repro_torch.configs import qwen3_1_7b
from repro_torch.kernels import decode_attention as DAT
from repro_torch.kernels import flash_attention as FAT
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PAT
from repro_torch.kernels import ref as REFT
from repro_torch.models import layers as LT
from repro_torch.models import registry as RT

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(x: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# =============================================================================
# paged decode: plain version vs the Pallas kernel (the kvpool shape sweep)
# =============================================================================
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,nb,bs,H,K,dh,n_pages", [
    (3, 9, 16, 4, 2, 64, 4),
    (1, 5, 32, 8, 8, 64, 3),
    (2, 17, 16, 6, 1, 128, 8),
])
def test_paged_decode_plain_matches_pallas(b, nb, bs, H, K, dh, n_pages,
                                           dtype):
    rng = np.random.default_rng(0)
    q_j, q_t = _both(rng.standard_normal((b, H, dh), np.float32), dtype)
    ka_j, ka_t = _both(rng.standard_normal((nb, bs, K, dh), np.float32),
                       dtype)
    va_j, va_t = _both(rng.standard_normal((nb, bs, K, dh), np.float32),
                       dtype)
    tables = np.zeros((b, n_pages), np.int32)
    lengths = np.zeros((b,), np.int32)
    for i in range(b):
        used = rng.integers(1, n_pages + 1)
        tables[i, :used] = rng.choice(np.arange(1, nb), size=used,
                                      replace=False)
        lengths[i] = rng.integers(1, used * bs + 1)
    want = PAJ.paged_decode_attention(q_j, ka_j, va_j, jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    got = REFT.paged_decode_attention_ref(q_t, ka_t, va_t,
                                          torch.tensor(tables),
                                          torch.tensor(lengths))
    assert got.dtype == q_t.dtype and got.shape == (b, H, dh)
    _close(got, want, DTYPES[dtype][2])


# =============================================================================
# contiguous decode: plain version vs the Pallas kernel
# =============================================================================
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,S,H,K,dh,lengths", [
    (3, 96, 4, 2, 64, (1, 40, 96)),        # per-row, S not a multiple of 256
    (2, 80, 8, 8, 32, (80, 17)),
    (1, 128, 6, 1, 128, (100,)),
    (2, 72, 4, 2, 16, 33),                 # one length shared by every row
])
def test_decode_plain_matches_pallas(b, S, H, K, dh, lengths, dtype):
    """The port takes any S; the Pallas kernel needs S % block_k == 0, so
    it is given block_k = S."""
    rng = np.random.default_rng(S + b)
    q_j, q_t = _both(rng.standard_normal((b, H, dh), np.float32), dtype)
    k_j, k_t = _both(rng.standard_normal((b, S, K, dh), np.float32), dtype)
    v_j, v_t = _both(rng.standard_normal((b, S, K, dh), np.float32), dtype)
    ln = np.asarray(lengths, np.int32)
    want = DAJ.decode_attention(q_j, k_j, v_j, jnp.asarray(ln), block_k=S,
                                interpret=True)
    got = REFT.decode_attention_ref(q_t, k_t, v_t, torch.tensor(ln))
    assert got.dtype == q_t.dtype and got.shape == (b, H, dh)
    _close(got, want, DTYPES[dtype][2])
    want_ref = REFJ.decode_attention_ref(q_j, k_j, v_j, jnp.asarray(ln))
    _close(got, want_ref, DTYPES[dtype][2])


def test_decode_plain_length_past_the_cache_sees_the_whole_row():
    """A row whose length exceeds S (a full slot's ``lengths + 1``) attends
    over every position, as the reference's mask does."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((2, 4, 16), np.float32))
    kc = torch.tensor(rng.standard_normal((2, 24, 2, 16), np.float32))
    vc = torch.tensor(rng.standard_normal((2, 24, 2, 16), np.float32))
    got = REFT.decode_attention_ref(q, kc, vc, torch.tensor([25, 24]))
    want = REFT.decode_attention_ref(q, kc, vc, torch.tensor([24, 24]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# =============================================================================
# contiguous flash attention: plain version vs the Pallas kernel
# =============================================================================
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,H,K,dh,window", [
    (2, 128, 4, 2, 64, 0),
    (1, 256, 8, 8, 32, 0),
    (2, 128, 4, 1, 128, 48),
    (1, 256, 6, 2, 16, 100),
])
def test_flash_plain_matches_pallas(b, s, H, K, dh, window, dtype):
    rng = np.random.default_rng(s + window)
    q_j, q_t = _both(rng.standard_normal((b, s, H, dh), np.float32), dtype)
    k_j, k_t = _both(rng.standard_normal((b, s, K, dh), np.float32), dtype)
    v_j, v_t = _both(rng.standard_normal((b, s, K, dh), np.float32), dtype)
    want = FAJ.flash_attention(q_j, k_j, v_j, causal=True, window=window,
                               interpret=True)
    got = REFT.flash_attention_ref(q_t, k_t, v_t, causal=True, window=window)
    assert got.dtype == q_t.dtype and got.shape == (b, s, H, dh)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_blocked_attention_matches_reference_model_path(dtype):
    """The model's full-sequence attention (q scaled in its type and cast to
    k's; probabilities kept f32 through P·V, as the kernels keep them)
    against the reference's ``blocked_attention``, which casts them to v's
    type: the bf16 tolerance covers that rounding."""
    b, s, H, K, dh = 2, 64, 4, 2, 16
    rng = np.random.default_rng(9)
    q_j, q_t = _both(rng.standard_normal((b, s, H, dh), np.float32), dtype)
    k_j, k_t = _both(rng.standard_normal((b, s, K, dh), np.float32), dtype)
    v_j, v_t = _both(rng.standard_normal((b, s, K, dh), np.float32), dtype)
    want = LJ.blocked_attention(q_j, k_j, v_j, causal=True, block_q=16)
    got = LT.blocked_attention(q_t, k_t, v_t, causal=True)
    assert got.dtype == q_t.dtype
    _close(got, want, DTYPES[dtype][2])


# =============================================================================
# paged chunked prefill: plain version vs the reference's model attention
# =============================================================================
@pytest.mark.parametrize("n_past,true_c", [(0, 8), (8, 5), (16, 8), (3, 2)])
def test_paged_prefill_plain_matches_reference_layer(n_past, true_c):
    """The port's ``attention_prefill_paged_apply`` (plain paged prefill on
    the CPU) against the reference's, with the reference's attention
    weights: same output, same arena writes."""
    cfg_j = get_smoke_config("qwen3-1.7b")
    cfg_t = qwen3_1_7b.SMOKE
    C, bs, nb, span = 8, 4, 12, 8
    H, K, dh, d = cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.d_head, cfg_t.d_model
    rng = np.random.default_rng(n_past * 31 + true_c)
    attn_t = RT.init_params(cfg_t, seed=0, device="cpu").layers[0].attn
    p_j = {"wq": {"w": rng.standard_normal((d, H * dh)) * d ** -0.5},
           "wk": {"w": rng.standard_normal((d, K * dh)) * d ** -0.5},
           "wv": {"w": rng.standard_normal((d, K * dh)) * d ** -0.5},
           "wo": {"w": rng.standard_normal((H * dh, d)) * (H * dh) ** -0.5},
           "q_norm": {"scale": 1 + 0.1 * rng.standard_normal(dh)},
           "k_norm": {"scale": 1 + 0.1 * rng.standard_normal(dh)}}
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(attn_t, name).weight.copy_(
                torch.tensor(p_j[name]["w"].T, dtype=torch.float32))
        for name in ("q_norm", "k_norm"):
            getattr(attn_t, name).scale.copy_(
                torch.tensor(p_j[name]["scale"], dtype=torch.float32))
    p_j = {k: {kk: jnp.asarray(vv, jnp.float32) for kk, vv in v.items()}
           for k, v in p_j.items()}
    x = rng.standard_normal((1, C, d)).astype(np.float32)
    ak = rng.standard_normal((nb, bs, K, dh)).astype(np.float32)
    av = rng.standard_normal((nb, bs, K, dh)).astype(np.float32)
    table = np.zeros((span,), np.int32)
    need = -(-(n_past + true_c) // bs)
    table[:need] = rng.permutation(np.arange(1, nb))[:need]
    positions = (n_past + np.arange(C)).astype(np.int32)
    valid = positions < n_past + true_c
    write_bid = np.where(valid, table[np.clip(positions // bs, 0, span - 1)],
                         0).astype(np.int32)
    write_off = (positions % bs).astype(np.int32)
    cos_j, sin_j = LJ.rope_table(jnp.asarray(positions), dh, cfg_j.rope_theta)
    out_j, ak_j, av_j = LJ.attention_prefill_paged_apply(
        p_j, jnp.asarray(x), cfg_j, cos_j, sin_j, jnp.asarray(ak),
        jnp.asarray(av), jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(write_bid), jnp.asarray(write_off))
    ak_t, av_t = torch.tensor(ak), torch.tensor(av)
    cos_t, sin_t = LT.rope_table(torch.tensor(positions), dh,
                                 cfg_t.rope_theta)
    with torch.no_grad():
        out_t = LT.attention_prefill_paged_apply(
            attn_t, torch.tensor(x), cos_t, sin_t, ak_t, av_t,
            torch.tensor(table), torch.tensor(positions),
            torch.tensor(write_bid).long(), torch.tensor(write_off).long())
    # rows of the padded tail are junk by contract (never read)
    _close(out_t[:, :true_c], np.asarray(out_j)[:, :true_c], 3e-5)
    written = np.unique(write_bid[valid])
    _close(ak_t[written], np.asarray(ak_j)[written], 3e-5)
    _close(av_t[written], np.asarray(av_j)[written], 3e-5)


# =============================================================================
# identity table, n_past = 0: the paged prefill IS contiguous flash attention
# =============================================================================
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [0, 48])
def test_paged_prefill_plain_matches_pallas_flash(window, dtype):
    C, H, K, dh, bs = 128, 4, 2, 64, 16
    rng = np.random.default_rng(window)
    q = rng.standard_normal((C, H, dh), np.float32)
    k = rng.standard_normal((C, K, dh), np.float32)
    v = rng.standard_normal((C, K, dh), np.float32)
    q_j, q_t = _both(q, dtype)
    k_j, _ = _both(k, dtype)
    v_j, _ = _both(v, dtype)
    n_pages = C // bs
    pad = np.zeros((1, bs, K, dh), np.float32)      # junk block 0
    _, ka_t = _both(np.concatenate([pad, k.reshape(n_pages, bs, K, dh)]),
                    dtype)
    _, va_t = _both(np.concatenate([pad, v.reshape(n_pages, bs, K, dh)]),
                    dtype)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32)
    positions = torch.arange(C, dtype=torch.int32)
    got = REFT.paged_prefill_attention_ref(q_t, ka_t, va_t, table, positions,
                                           window=window)
    tol = DTYPES[dtype][2]
    want = FAJ.flash_attention(q_j[None], k_j[None], v_j[None], causal=True,
                               window=window, interpret=True)[0]
    _close(got, want, tol)
    want_ref = REFJ.flash_attention_ref(q_j[None], k_j[None], v_j[None],
                                        causal=True, window=window)[0]
    _close(got, want_ref, tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_flash_attention_ref_matches_reference_ref(causal, window):
    b, sq, skv, H, K, dh = 2, 32, 32, 4, 2, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, sq, H, dh), np.float32)
    k = rng.standard_normal((b, skv, K, dh), np.float32)
    v = rng.standard_normal((b, skv, K, dh), np.float32)
    want = REFJ.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    got = REFT.flash_attention_ref(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=causal,
                                   window=window)
    _close(got, want, 3e-5)


# =============================================================================
# dispatch: CPU tensors take the plain version; the kernels take CUDA only
# =============================================================================
def _decode_inputs(device="cpu"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    ka = torch.randn(5, 8, 2, 16, generator=g)
    va = torch.randn(5, 8, 2, 16, generator=g)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lengths = torch.tensor([10, 3], dtype=torch.int32)
    return [t.to(device) for t in (q, ka, va, tables, lengths)]


def test_ops_on_cpu_take_the_plain_versions_and_launch_nothing():
    counters = (PAT.paged_decode_attention, FAT.paged_prefill_attention,
                DAT.decode_attention, FAT.flash_attention)
    before = [f.launches for f in counters]
    args = _decode_inputs()
    torch.testing.assert_close(ops.paged_decode_attention(*args),
                               REFT.paged_decode_attention_ref(*args),
                               rtol=0, atol=0)
    q, ka, va = torch.randn(6, 4, 16), args[1], args[2]
    table = torch.tensor([2, 1], dtype=torch.int32)
    pos = torch.arange(6, dtype=torch.int32) + 4
    torch.testing.assert_close(
        ops.paged_prefill_attention(q, ka, va, table, pos),
        REFT.paged_prefill_attention_ref(q, ka, va, table, pos),
        rtol=0, atol=0)
    qd, kc = torch.randn(2, 4, 16), torch.randn(2, 12, 2, 16)
    ln = torch.tensor([5, 12], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(qd, kc, kc, ln),
                               REFT.decode_attention_ref(qd, kc, kc, ln),
                               rtol=0, atol=0)
    qf, kf = torch.randn(1, 12, 4, 16), torch.randn(1, 12, 2, 16)
    torch.testing.assert_close(ops.flash_attention(qf, kf, kf, window=4),
                               REFT.flash_attention_ref(qf, kf, kf, window=4),
                               rtol=0, atol=0)
    assert [f.launches for f in counters] == before


def test_contiguous_kernel_wrappers_refuse_what_they_do_not_take():
    """The contiguous kernels' wrappers check before they build: CPU
    tensors, a type the kernels do not take, a head dim the flash kernel
    cannot read four at a time, and shapes that do not match, raise.
    Meta tensors (the dry run's abstract steps) take the plain versions
    through ``ops``, which give meta outputs of the kernels' shapes and
    launch nothing."""
    counters = (DAT.decode_attention, FAT.flash_attention)
    before = [f.launches for f in counters]
    qd, kc = torch.randn(2, 4, 16), torch.randn(2, 12, 2, 16)
    ln = torch.tensor([5, 12], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        DAT.decode_attention(qd, kc, kc, ln)
    qf, kf = torch.randn(1, 12, 4, 16), torch.randn(1, 12, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FAT.flash_attention(qf, kf, kf)
    meta = [t.to("meta") for t in (qf, kf, kf)]
    out = ops.flash_attention(*meta)
    assert out.is_meta and out.shape == qf.shape
    out = ops.decode_attention(*[t.to("meta") for t in (qd, kc, kc, ln)])
    assert out.is_meta and out.shape == qd.shape
    assert [f.launches for f in counters] == before


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """The CUDA wrappers check before they build or launch: CPU tensors
    raise.  Meta tensors take the plain version through ``ops``, a meta
    output of the kernel's shape, and launch nothing."""
    n_dec = PAT.paged_decode_attention.launches
    n_pre = FAT.paged_prefill_attention.launches
    args = _decode_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        PAT.paged_decode_attention(*args)
    q = torch.randn(6, 4, 16)
    table = torch.tensor([2, 1], dtype=torch.int32)
    pos = torch.arange(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        FAT.paged_prefill_attention(q, args[1], args[2], table, pos)
    meta = [t.to("meta") for t in args]
    out = ops.paged_decode_attention(*meta)
    assert out.is_meta and out.shape == args[0].shape
    assert PAT.paged_decode_attention.launches == n_dec
    assert FAT.paged_prefill_attention.launches == n_pre


@pytest.mark.parametrize("g,want", [(1, 64), (2, 32), (3, 21), (8, 8)])
def test_contiguous_prefill_tile_holds_64_query_rows(g, want):
    """Queries per CTA of the contiguous kernel: as many as fit its 64
    query rows, so a CTA reuses each staged K/V block across 64 rows."""
    assert FAT.flash_queries_per_cta(g) == want


# =============================================================================
# the bf16 tensor-core flash body (csrc/flash_attention.cu), emulated in
# torch: f32 scores of bf16 operands, f32 online softmax over 64-key
# blocks, P rounded to bf16 for P.V
# =============================================================================
# chip_smoke.TOL["bfloat16"]: the kernel against its plain version
FLASH_BF16_TOL = (4e-3, 1e-2)


def flash_bf16_emulation(q, k, v, *, causal=True, window=0, block=64):
    """The kernel's arithmetic: q.k^T in f32 from bf16 operands, scaled to
    log2 units; per 64-key block the running max, the rescale of l and
    the accumulator, and P = exp2(s - m) rounded to bf16 before P.V with
    f32 sums; out = acc / l in q's type."""
    b, sq, H, dh = q.shape
    skv, K = k.shape[1], k.shape[2]
    g = H // K
    qf = q.float().reshape(b, sq, K, g, dh).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (b, K, 1, skv, dh)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((b, K, g, sq), float("-inf"))
    l = torch.zeros(b, K, g, sq)
    acc = torch.zeros(b, K, g, sq, dh)
    qpos = torch.arange(sq)[:, None]
    for kb in range(0, skv, block):
        kpos = torch.arange(kb, min(kb + block, skv))[None, :]
        s = qf @ kf[..., kb:kb + block, :].transpose(-1, -2)
        s = s * (dh ** -0.5 * 1.4426950408889634)
        ok = torch.ones_like(kpos - qpos, dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= qpos - kpos < window
        s = torch.where(ok, s, torch.tensor(float("-inf")))
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                           m_new)
        p = torch.exp2(s - base[..., None])
        alpha = torch.exp2(m - base)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + \
            p.to(torch.bfloat16).float() @ vf[..., kb:kb + block, :]
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, H, dh).to(q.dtype)


@pytest.mark.parametrize("b,s,H,K,dh,window", [
    (2, 128, 4, 2, 64, 0),
    (1, 256, 4, 4, 80, 0),
    (2, 128, 4, 1, 128, 48),
    (1, 256, 6, 2, 16, 100),
])
def test_flash_bf16_p_rounding_stays_within_the_kernel_tolerance(
        b, s, H, K, dh, window):
    """P rounded to bf16 before P.V, in f32 online-softmax order, stays
    within chip_smoke's bf16 TOL of the Pallas kernel (interpret) and of
    the port's plain version, which keep P in f32."""
    rng = np.random.default_rng(dh + window)
    q_j, q_t = _both(rng.standard_normal((b, s, H, dh), np.float32),
                     "bfloat16")
    k_j, k_t = _both(rng.standard_normal((b, s, K, dh), np.float32),
                     "bfloat16")
    v_j, v_t = _both(rng.standard_normal((b, s, K, dh), np.float32),
                     "bfloat16")
    got = flash_bf16_emulation(q_t, k_t, v_t, window=window).float()
    atol, rtol = FLASH_BF16_TOL
    want = torch.tensor(np.asarray(FAJ.flash_attention(
        q_j, k_j, v_j, causal=True, window=window, interpret=True),
        np.float32))
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    plain = REFT.flash_attention_ref(q_t, k_t, v_t, window=window).float()
    torch.testing.assert_close(got, plain, atol=atol, rtol=rtol)
