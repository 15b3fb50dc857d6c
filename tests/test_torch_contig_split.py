"""The arithmetic of the slotted engine's two redesigned kernels, emulated in
PyTorch on the CPU and held against the reference's Pallas kernels
(interpret mode) and the port's plain versions, on the same numpy inputs.

* The contiguous decode (``csrc/decode_attention.cu``) is the split-KV body
  of the paged decode (``csrc/decode_split.cuh``) with a contiguous
  address: the host's split plan from S alone
  (:func:`~repro_torch.kernels.paged_attention.split_plan` over cdiv(S, 16)
  pages of 16 positions), each row's runs of pages cut on the device from
  its own length (or the one length every row shares), one partial (acc,
  m, l) per live split with scores in log2 units, and the merge that gives
  an empty partial (m = -inf) weight exactly 0.
* The contiguous flash attention (``csrc/flash_attention.cu``) multiplies
  f32 inputs on the tensor cores as split bf16 pairs: q, K, V and P each
  split into hi + lo, every product hi·hi + hi·lo + lo·hi with f32 sums,
  and two f32 online softmaxes a row, one over each half of every 64-key
  block, merged at the end.

Tolerances are ``chip_smoke.TOL``'s, the kernels' own against their plain
versions on the card: f32 1e-4, bf16 4e-3 / 1e-2."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as DAJ
from repro.kernels import flash_attention as FAJ
from repro_torch.kernels import decode_attention as DAT
from repro_torch.kernels import paged_attention as PAT
from repro_torch.kernels import ref as REFT

# chip_smoke.TOL: (atol, rtol) of a kernel against its plain version
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-3, 1e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOG2E = 1.4426950408889634
KEYS = 64            # keys of a staged flash block (kFaKeys)


def _both(x: np.ndarray, dtype: str):
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    atol, rtol = TOL[dtype]
    if not isinstance(want, torch.Tensor):
        want = torch.tensor(np.asarray(want, np.float32))
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# =============================================================================
# contiguous decode: the split-KV body with a contiguous address
# =============================================================================
def contig_plan(S: int, lengths, b: int, K: int, n_sm: int, dtype):
    """The kernel's splits of each row: the host's (n_split, min_pages,
    ctas) from S alone, then on the device each row's pps and its live
    splits' position ranges [p0, p1), from its own length clipped to S."""
    page = DAT.CONTIG_PAGE
    n_split, min_pages, ctas = PAT.split_plan(_cdiv(S, page), page, b * K,
                                              n_sm,
                                              PAT.DECODE_CTAS_PER_SM[dtype])
    lens = [min(int(x), S) for x in np.broadcast_to(np.asarray(lengths),
                                                    (b,))]
    total = sum(_cdiv(x, page) for x in lens)
    rows = []
    for length in lens:
        valid = _cdiv(length, page)
        pps = max(min_pages, _cdiv(valid, n_split), _cdiv(total * K, ctas))
        n_live = max(_cdiv(valid, pps), 1)
        rows.append([(s * pps * page, min((s + 1) * pps * page, length))
                     for s in range(n_live)])
    return n_split, rows


def contig_decode_emulation(q, kc, vc, lengths, n_sm):
    """csrc/decode_split.cuh with ContigKV on the CPU (scores q·k dh**-0.5
    in log2 units).  Returns (out in q's type, the live partials of every
    (row, KV head), n_split)."""
    b, H, dh = q.shape
    S, K = kc.shape[1], kc.shape[2]
    g = H // K
    n_split, rows = contig_plan(S, lengths, b, K, n_sm, q.dtype)
    out = torch.zeros(b, H, dh)
    partials = {}
    for row, splits in enumerate(rows):
        for kvh in range(K):
            qg = q[row, kvh * g:(kvh + 1) * g].float()     # (g, dh)
            parts = []
            for p0, p1 in splits:
                kr = kc[row, p0:p1, kvh].float()
                vr = vc[row, p0:p1, kvh].float()
                if p1 <= p0:                # a row of length 0: split 0
                    parts.append((torch.zeros(g, dh),
                                  torch.full((g,), -math.inf),
                                  torch.zeros(g)))
                    continue
                sc = qg @ kr.T * (dh ** -0.5 * LOG2E)
                m = sc.max(-1).values
                p = torch.exp2(sc - m[:, None])
                parts.append((p @ vr, m, p.sum(-1)))
            partials[row, kvh] = parts
            out[row, kvh * g:(kvh + 1) * g] = merge(parts)
    return out.to(q.dtype), partials, n_split


def merge(parts):
    """The kernels' merge of [(acc (rows, dh), m (rows,), l (rows,)), ...]
    — m in log2 units, weight exactly 0 where m is -inf (a row that saw
    nothing comes back 0)."""
    m_all = torch.stack([m for _, m, _ in parts])
    M = m_all.max(0).values
    out = torch.zeros_like(parts[0][0])
    L = torch.zeros_like(M)
    for acc, m, l in parts:
        c = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp2(m - torch.where(M == -math.inf,
                                                   torch.zeros_like(M), M)))
        out += c[:, None] * acc
        L += c * l
    return out / L.clamp_min(1e-30)[:, None]


CONTIG_DECODE_CASES = [
    # b, S, H, K, dh, lengths, n_sm: S a multiple of 16 (96) or not (72,
    # 1000), per-row and shared lengths, length 0, lengths above S, g = 1
    # and 2; rows split over several CTAs on a card of 132 SMs, and not on
    # one of 2, where a row's run is its even share of the batch's pages
    (3, 72, 4, 2, 64, (72, 1, 40), 132),
    (4, 96, 4, 4, 32, (0, 97, 96, 17), 132),
    (2, 72, 4, 2, 16, 33, 132),                 # one () length, shared
    (2, 96, 8, 8, 32, 200, 132),                # shared, above S
    (3, 1000, 4, 2, 64, (1000, 5, 999), 132),   # 16 splits a row
    (2, 1000, 2, 2, 128, (0, 1001), 132),
    (3, 1000, 4, 2, 64, (1000, 5, 999), 2),     # one split a row
]


def _contig_inputs(b, S, H, K, dh, lengths, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _both(rng.standard_normal((b, H, dh), np.float32), dtype)
    k = _both(rng.standard_normal((b, S, K, dh), np.float32), dtype)
    v = _both(rng.standard_normal((b, S, K, dh), np.float32), dtype)
    ln = np.asarray(lengths, np.int32)
    return q, k, v, ln


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,S,H,K,dh,lengths,n_sm", CONTIG_DECODE_CASES)
def test_contig_decode_split_emulation_matches_pallas(b, S, H, K, dh,
                                                      lengths, n_sm, dtype):
    """The split body's partials and merge over a contiguous row against
    the Pallas kernel (interpret, block_k = S) and the port's plain
    version; a row of length 0 comes back zero (the wrapper's contract),
    where both of those average V over the row."""
    (q_j, q_t), (k_j, k_t), (v_j, v_t), ln = _contig_inputs(
        b, S, H, K, dh, lengths, dtype, seed=S + b + dh)
    got, _, _ = contig_decode_emulation(q_t, k_t, v_t, torch.tensor(ln),
                                        n_sm)
    assert got.dtype == q_t.dtype and bool(torch.isfinite(got).all())
    want = torch.tensor(np.asarray(DAJ.decode_attention(
        q_j, k_j, v_j, jnp.asarray(ln), block_k=S, interpret=True),
        np.float32))
    plain = REFT.decode_attention_ref(q_t, k_t, v_t, torch.tensor(ln))
    empty = torch.as_tensor(np.broadcast_to(ln, (b,)) == 0)
    want[empty] = 0
    plain = plain.masked_fill(empty[:, None, None], 0)
    _close(got, want, dtype)
    _close(got, plain, dtype)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("S", [16, 72, 96, 1000, 2040, 2048])
@pytest.mark.parametrize("b,K,n_sm", [(1, 8, 132), (8, 8, 132), (4, 32, 132),
                                      (3, 2, 2)])
def test_contig_plan_reads_each_valid_position_once(S, b, K, n_sm):
    """Every row's live splits tile exactly its valid positions [0, min(
    length, S)) in order, none empty but a row of length 0's one split, at
    most n_split of them — so no position at or past the length (or S) is
    loaded, whatever the ragged last page."""
    rng = np.random.default_rng(S + b)
    lengths = rng.integers(0, S + 40, size=b)
    lengths[0] = S + 1
    for dtype in (torch.float32, torch.bfloat16):
        n_split, rows = contig_plan(S, lengths, b, K, n_sm, dtype)
        for length, splits in zip(lengths, rows):
            valid = min(int(length), S)
            assert 1 <= len(splits) <= n_split
            if valid == 0:
                assert splits == [(0, 0)]
                continue
            assert splits[0][0] == 0 and splits[-1][1] == valid
            for (a0, a1), (b0, _) in zip(splits, splits[1:]):
                assert a1 == b0
            assert all(p1 > p0 for p0, p1 in splits)


def test_contig_plan_splits_the_slotted_step():
    """At the slotted serve's decode step (8 slots over 2048 positions, 8
    KV heads, f32, 132 SMs) the host plans 8 splits a (row, KV head) from
    S alone, and each row cuts its own valid pages: a row of ~1055
    positions runs in all 8 splits (runs of 144 positions, none past its
    length), a row of 1-40 positions in one — so no split is spent on the
    cache tail that no row reaches."""
    n_split, rows = contig_plan(2048, (1055, 1040, 1, 40, 1024, 1055, 300,
                                       17), 8, 8, 132, torch.float32)
    assert n_split == 8
    assert [len(r) for r in rows] == [8, 8, 1, 1, 8, 8, 3, 1]
    assert rows[0][0] == (0, 144) and rows[0][-1] == (1008, 1055)


@pytest.mark.parametrize("case", [0, 1, 3, 4, 5])
def test_contig_decode_partials_are_merged_across_splits(case):
    """These cases split some row over several CTAs, so the merge — not a
    single split's normalisation — gives that row's output; a row of
    length 0 has one split, whose partial the merge weighs 0."""
    b, S, H, K, dh, lengths, n_sm = CONTIG_DECODE_CASES[case]
    (_, q), (_, k), (_, v), ln = _contig_inputs(b, S, H, K, dh, lengths,
                                                "float32", seed=1)
    out, partials, n_split = contig_decode_emulation(q, k, v,
                                                     torch.tensor(ln), n_sm)
    assert n_split > 1
    assert max(len(p) for p in partials.values()) > 1
    for (row, _), parts in partials.items():
        if np.broadcast_to(ln, (b,))[row] == 0:
            assert len(parts) == 1 and bool((parts[0][1] == -math.inf).all())
            assert bool((out[row] == 0).all())


def _no_card(monkeypatch):
    """Let a contiguous-decode wrapper run its checks and plan on CPU
    tensors: the device check patched out, a card of 132 SMs, and an
    extension that records what it is given in place of the build."""
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
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,K,lengths", [(8, 2048, 8, (1055, 3)),
                                           (4, 160, 32, 160),
                                           (2, 2040, 2, (0, 4096))])
def test_contig_decode_wrapper_plans_from_shapes_alone(monkeypatch, dtype, b,
                                                       S, K, lengths):
    """The wrapper hands the kernel the plan of ``split_plan`` over cdiv(S,
    16) pages of 16 positions and an f32 scratch of b·K·n_split partials;
    another set of lengths, of either form, gets the same plan — the host
    never reads them."""
    calls = _no_card(monkeypatch)
    H, dh = 2 * K, 16
    q, kc = torch.randn(b, H, dh).to(dtype), torch.randn(b, S, K, dh).to(
        dtype)
    ln = torch.tensor(np.resize(np.asarray(lengths), b), dtype=torch.int32)
    for lens in (ln, ln.flip(0) + 1, torch.tensor(7, dtype=torch.int32)):
        n0 = DAT.decode_attention.launches
        DAT.decode_attention(q, kc, kc, lens)
        assert DAT.decode_attention.launches == n0 + 1
    want = PAT.split_plan(_cdiv(S, 16), 16, b * K, 132,
                          PAT.DECODE_CTAS_PER_SM[dtype])
    for args in calls:
        # (q, k, v, lengths, window_end, out, lse, part, counters,
        #  min_pages, n_split, ctas, scale, window)
        min_pages, n_split, ctas = args[9:12]
        assert (n_split, min_pages, ctas) == want
        part = args[7]
        assert part.dtype == torch.float32
        assert part.numel() == (b * K * n_split * PAT.partial_floats(2, dh)
                                if n_split > 1 else 0)


@pytest.mark.parametrize("g,dh", [(1, 80), (1, 128), (2, 128), (3, 16),
                                  (8, 16), (1, 16)])
def test_decode_partials_start_16_byte_aligned(g, dh):
    """The merge reads each partial's acc as float4, so a decode group of
    odd g (g = 1: zamba2's decode) is laid out as g + 1 rows: a partial of
    g·(dh + 2) floats would start every odd split 8 bytes off a 16-byte
    boundary.  The layout holds acc, m and l of the g rows."""
    n = PAT.partial_floats(g + g % 2, dh)
    assert n % 4 == 0 and g * (dh + 2) <= n


def _misaligned(*shape: int) -> torch.Tensor:
    """A contiguous f32 tensor whose data starts 4 bytes past a 16-byte
    boundary."""
    n = math.prod(shape)
    base = torch.randn(n + 4)
    off = next(i for i in range(1, 4) if (base.data_ptr() + 4 * i) % 16)
    return base[off:off + n].view(shape)


@pytest.mark.parametrize("fault", ["dh 12", "misaligned q", "misaligned k"])
def test_contig_decode_wrapper_refuses_what_16_byte_copies_cannot_read(
        monkeypatch, fault):
    """The split body stages K and V by cp.async, 16 bytes a thread, so the
    contiguous decode's wrapper refuses a head dim that is not a multiple
    of 8 and a tensor that does not start on a 16-byte boundary, before it
    builds or launches."""
    calls = _no_card(monkeypatch)
    dh = 12 if fault == "dh 12" else 16
    q = _misaligned(2, 4, dh) if fault == "misaligned q" else \
        torch.randn(2, 4, dh)
    kc = _misaligned(2, 24, 2, dh) if fault == "misaligned k" else \
        torch.randn(2, 24, 2, dh)
    n0 = DAT.decode_attention.launches
    with pytest.raises(ValueError, match="divisible by 8 and 16-byte"):
        DAT.decode_attention(q, kc, torch.randn(2, 24, 2, dh),
                             torch.tensor([9, 3], dtype=torch.int32))
    assert DAT.decode_attention.launches == n0 and not calls


# =============================================================================
# contiguous flash attention, f32 inputs as split bf16 on the tensor cores
# =============================================================================
def _split_bf16(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b on the tensor cores: "split" (f32 operands as bf16 pairs,
    hi·hi + hi·lo + lo·hi) or "single" (each operand rounded once to
    bf16)."""
    if mode == "split":
        ah, al = _split_bf16(a)
        bh, bl = _split_bf16(b)
        return ah @ bl + al @ bh + ah @ bh
    return _split_bf16(a)[0] @ _split_bf16(b)[0]


def flash_split_emulation(q, k, v, *, causal=True, window=0, mode="split"):
    """csrc/flash_attention.cu for f32 inputs on the CPU.  Two warps share
    each row: per 64-key block, warp half h scores keys 32h .. 32h + 31 —
    S = q·Kᵀ from split operands in log2 units, the masks, its running
    max, the rescale of its l and accumulator, P = exp2(s - m) split again
    for P·V — and at the end the halves' states merge: M = max(m0, m1),
    each weighted 2^(m - M); out = acc / l.  q (b, sq, H, dh); k, v (b,
    skv, K, dh)."""
    b, sq, H, dh = q.shape
    skv, K = k.shape[1], k.shape[2]
    g = H // K
    half = KEYS // 2
    qf = q.float().reshape(b, sq, K, g, dh).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]   # (b, K, 1, skv, dh)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    qpos = torch.arange(sq)[:, None]
    states = []
    for h in range(2):
        m = torch.full((b, K, g, sq), -math.inf)
        l = torch.zeros(b, K, g, sq)
        acc = torch.zeros(b, K, g, sq, dh)
        for kb in range(h * half, skv, KEYS):
            ke = min(kb + half, skv)
            kpos = torch.arange(kb, ke)[None, :]
            s = _product(qf, kf[..., kb:ke, :].transpose(-1, -2), mode)
            s = s * (dh ** -0.5 * LOG2E)
            ok = torch.ones_like(kpos - qpos, dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window > 0:
                ok &= qpos - kpos < window
            s = torch.where(ok, s, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1))
            base = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                               m_new)
            p = torch.exp2(s - base[..., None])
            alpha = torch.exp2(m - base)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _product(p, vf[..., kb:ke, :],
                                                    mode)
            m = m_new
        states.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = states
    M = torch.maximum(m0, m1)
    base = torch.where(M == -math.inf, torch.zeros_like(M), M)
    c0, c1 = torch.exp2(m0 - base), torch.exp2(m1 - base)
    out = (a0 * c0[..., None] + a1 * c1[..., None]) / \
        (l0 * c0 + l1 * c1).clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, H, dh)


FLASH_F32_CASES = [
    # b, s, H, K, dh, causal, window: the slotted prefill's g = 2 at dh
    # 128, zamba2's g = 1 at dh 80, SMOKE's dh 16; windowed; full
    (1, 256, 4, 2, 128, True, 0),
    (2, 128, 4, 4, 80, True, 0),
    (2, 256, 4, 4, 16, True, 0),
    (1, 256, 4, 2, 128, True, 100),
    (2, 128, 4, 4, 80, True, 48),
    (1, 128, 4, 2, 16, False, 0),
]


def _flash_inputs(b, s, H, K, dh, seed):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(shape, np.float32), "float32")
            for shape in ((b, s, H, dh), (b, s, K, dh), (b, s, K, dh))]


@pytest.mark.parametrize("b,s,H,K,dh,causal,window", FLASH_F32_CASES)
def test_flash_split_bf16_matches_pallas_at_the_f32_tolerance(
        b, s, H, K, dh, causal, window):
    """The f32 body's split products and online softmax against the Pallas
    kernel (interpret) and the port's plain version, at f32's TOL."""
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _flash_inputs(b, s, H, K, dh,
                                                       seed=s + dh + window)
    got = flash_split_emulation(q_t, k_t, v_t, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    want = FAJ.flash_attention(q_j, k_j, v_j, causal=causal, window=window,
                               interpret=True)
    _close(got, want, "float32")
    plain = REFT.flash_attention_ref(q_t, k_t, v_t, causal=causal,
                                     window=window)
    _close(got, plain, "float32")


@pytest.mark.parametrize("b,s,H,K,dh,causal,window",
                         [FLASH_F32_CASES[i] for i in (0, 1, 3)])
def test_flash_single_bf16_rounding_fails_the_f32_tolerance(b, s, H, K, dh,
                                                             causal, window):
    """Rounding each f32 operand once to bf16 — what the bf16 body does —
    would not hold the f32 tolerance that the split products hold."""
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _flash_inputs(b, s, H, K, dh,
                                                       seed=s + dh + window)
    want = torch.tensor(np.asarray(FAJ.flash_attention(
        q_j, k_j, v_j, causal=causal, window=window, interpret=True)))
    atol, rtol = TOL["float32"]
    split = flash_split_emulation(q_t, k_t, v_t, causal=causal,
                                  window=window)
    torch.testing.assert_close(split, want, atol=atol, rtol=rtol)
    single = flash_split_emulation(q_t, k_t, v_t, causal=causal,
                                   window=window, mode="single")
    excess = ((single - want).abs() - (atol + rtol * want.abs())).max()
    assert excess > 0, "a single bf16 rounding passes the f32 tolerance"

