"""The split-KV arithmetic of the paged kernels (``csrc/paged_attention.cu``,
``csrc/paged_prefill.cu``, ``csrc/split_kv.cuh``), emulated in PyTorch on
the CPU and held against the reference's Pallas kernels (interpret mode),
its ``combine_attention_parts`` merge and the port's plain versions, on the
same numpy inputs.

The emulations follow the kernels step by step: the host's split plan
(:func:`~repro_torch.kernels.paged_attention.split_plan`), each group's
runs of pages cut on the device from its lengths or positions, one partial
(acc, m, l) per live split with scores in log2 units, and the merge that
gives an empty partial (m = -inf) weight exactly 0.  The prefill emulation
also repeats the tensor-core products: bf16 operands with f32 sums, f32
operands split into bf16 pairs (hi·hi + hi·lo + lo·hi), P rounded to bf16
for bf16 inputs.  Tolerances are ``chip_smoke.TOL``'s, the kernels' own
against their plain versions on the card: f32 1e-4, bf16 4e-3 / 1e-2."""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as FAJ
from repro.kernels import paged_attention as PAJ
from repro.models import layers as LJ
from repro_torch.kernels import flash_attention as FAT
from repro_torch.kernels import paged_attention as PAT
from repro_torch.kernels import ref as REFT

# chip_smoke.TOL: (atol, rtol) of a kernel against its plain version
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-3, 1e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOG2E = 1.4426950408889634
KEYS = 64            # keys of a staged prefill block (kPfKeys)


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


def merge(parts):
    """The kernels' merge of [(acc (rows, dh), m (rows,), l (rows,)), ...]
    — m in log2 units, weight exactly 0 where m is -inf."""
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


# =============================================================================
# paged decode
# =============================================================================
def decode_split_emulation(q, ka, va, tables, lengths, n_sm):
    """csrc/paged_attention.cu on the CPU (scores q·k dh**-0.5 in log2
    units).  Returns (out in q's type, the
    partials of every (row, KV head): a list per group of (acc, m, l) for
    splits 0 .. n_split - 1, None for an empty split)."""
    b, H, dh = q.shape
    _, bs, K, _ = ka.shape
    g = H // K
    n_pages = tables.shape[1]
    n_split, min_pages, ctas = PAT.split_plan(n_pages, bs, b * K, n_sm,
                                              PAT.DECODE_CTAS_PER_SM[q.dtype])
    lens = [min(int(x), n_pages * bs) for x in lengths]
    total = sum(_cdiv(x, bs) for x in lens)
    out = torch.zeros(b, H, dh)
    partials = {}
    for row in range(b):
        valid = _cdiv(lens[row], bs)
        pps = max(min_pages, _cdiv(valid, n_split), _cdiv(total * K, ctas))
        n_live = max(_cdiv(valid, pps), 1)
        pos = torch.arange(n_pages * bs)
        blk = tables[row].long()[pos // bs]
        kr = ka[blk, pos % bs].float()                   # (positions, K, dh)
        vr = va[blk, pos % bs].float()
        for kvh in range(K):
            qg = q[row, kvh * g:(kvh + 1) * g].float()   # (g, dh)
            parts = []
            for s in range(n_split):
                if s >= n_live:
                    parts.append(None)
                    continue
                p0, p1 = s * pps * bs, min((s + 1) * pps * bs, lens[row])
                sc = qg @ kr[p0:p1, kvh].T * (dh ** -0.5 * LOG2E)
                m = sc.max(-1).values if p1 > p0 else torch.full(
                    (g,), -math.inf)
                p = torch.exp2(sc - m[:, None]) if p1 > p0 else sc
                parts.append((p @ vr[p0:p1, kvh], m, p.sum(-1)))
            partials[row, kvh] = parts
            out[row, kvh * g:(kvh + 1) * g] = merge(parts[:n_live])
    return out.to(q.dtype), partials


DECODE_CASES = [
    # b, n_pages, bs, H, K, dh, lengths, n_sm: trailing empty splits,
    # length 1, a row at the full table, and one row alone over its table
    (4, 32, 8, 4, 2, 64, (256, 1, 70, 9), 4),
    (3, 24, 8, 8, 2, 32, (5, 192, 100), 16),
    (1, 64, 8, 4, 4, 16, (512,), 132),
    (2, 16, 16, 6, 1, 128, (1, 33), 8),
]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,n_pages,bs,H,K,dh,lengths,n_sm", DECODE_CASES)
def test_decode_split_emulation_matches_pallas(b, n_pages, bs, H, K, dh,
                                               lengths, n_sm, dtype):
    """The split kernel's partials and merge against the Pallas kernel
    (interpret) and the port's plain version."""
    rng = np.random.default_rng(b * 100 + dh)
    nb = b * n_pages + 1
    q_j, q_t = _both(rng.standard_normal((b, H, dh), np.float32), dtype)
    ka_j, ka_t = _both(rng.standard_normal((nb, bs, K, dh), np.float32),
                       dtype)
    va_j, va_t = _both(rng.standard_normal((nb, bs, K, dh), np.float32),
                       dtype)
    tables = np.zeros((b, n_pages), np.int32)
    perm = rng.permutation(np.arange(1, nb)).reshape(b, n_pages)
    for i, n in enumerate(lengths):
        tables[i, :_cdiv(n, bs)] = perm[i, :_cdiv(n, bs)]
    ln = np.asarray(lengths, np.int32)
    got, partials = decode_split_emulation(q_t, ka_t, va_t,
                                           torch.tensor(tables),
                                           torch.tensor(ln), n_sm)
    assert got.dtype == q_t.dtype and bool(torch.isfinite(got).all())
    want = PAJ.paged_decode_attention(q_j, ka_j, va_j, jnp.asarray(tables),
                                      jnp.asarray(ln), interpret=True)
    _close(got, want, dtype)
    plain = REFT.paged_decode_attention_ref(q_t, ka_t, va_t,
                                            torch.tensor(tables),
                                            torch.tensor(ln))
    _close(got, plain, dtype)
    # a row shorter than the table leaves trailing splits empty
    n_empty = sum(p is None for parts in partials.values() for p in parts)
    assert (n_empty > 0) == (min(lengths) < n_pages * bs)


@pytest.mark.parametrize("b,n_pages,bs,H,K,dh,lengths,n_sm", DECODE_CASES)
def test_decode_merge_matches_reference_combine(b, n_pages, bs, H, K, dh,
                                                lengths, n_sm):
    """The kernels' merge of the live partials equals the reference's
    ``combine_attention_parts`` over the same partials (m in natural
    units, clamped to -1e30 as the reference's producers clamp it), empty
    splits included as partials of weight 0."""
    rng = np.random.default_rng(b + dh)
    nb = b * n_pages + 1
    q = torch.tensor(rng.standard_normal((b, H, dh), np.float32))
    ka = torch.tensor(rng.standard_normal((nb, bs, K, dh), np.float32))
    va = torch.tensor(rng.standard_normal((nb, bs, K, dh), np.float32))
    tables = torch.tensor(rng.integers(1, nb, size=(b, n_pages)),
                          dtype=torch.int32)
    got, partials = decode_split_emulation(q, ka, va, tables,
                                           torch.tensor(lengths), n_sm)
    g = H // K
    n_split = len(partials[0, 0])
    parts = []
    for s in range(n_split):
        acc = np.zeros((b, K, g, dh), np.float32)
        m = np.full((b, K, g), -1e30, np.float32)
        l = np.zeros((b, K, g), np.float32)
        for (row, kvh), ps in partials.items():
            if ps[s] is not None:
                acc[row, kvh] = ps[s][0].numpy()
                m[row, kvh] = np.maximum(ps[s][1].numpy() / LOG2E, -1e30)
                l[row, kvh] = ps[s][2].numpy()
        parts.append((jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l)))
    want = np.asarray(LJ.combine_attention_parts(parts)).reshape(b, H, dh)
    _close(got, want, "float32")


# =============================================================================
# paged chunked prefill
# =============================================================================
def _split_bf16(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b on the tensor cores: "split" (f32 operands as bf16 pairs,
    hi·hi + hi·lo + lo·hi), "single" (each operand rounded once to bf16)
    or "exact" (bf16 operands, exact products, f32 sums)."""
    if mode == "split":
        ah, al = _split_bf16(a)
        bh, bl = _split_bf16(b)
        return ah @ bl + al @ bh + ah @ bh
    if mode == "single":
        return _split_bf16(a)[0] @ _split_bf16(b)[0]
    return a @ b


def prefill_split_emulation(q, ka, va, table, positions, *, window=0,
                            n_sm=132, mode=None):
    """csrc/paged_prefill.cu on the CPU: 64-row tiles, the tile's visible
    pages in runs from split_plan, 64-key blocks with an f32 online softmax
    in log2 units, products by ``mode`` (default: "split" for f32 inputs,
    "exact" with P rounded to bf16 for bf16 inputs), partials merged."""
    C, H, dh = q.shape
    _, bs, K, _ = ka.shape
    g = H // K
    span = table.shape[0]
    tq = FAT.flash_queries_per_cta(g)
    n_tiles = _cdiv(C, tq)
    n_split, min_pages, _ = PAT.split_plan(span, bs, n_tiles * K, n_sm,
                                           PAT.PREFILL_CTAS_PER_SM)
    bf16 = q.dtype == torch.bfloat16
    mode = mode or ("exact" if bf16 else "split")
    n_pos = span * bs
    sl2 = dh ** -0.5 * LOG2E                  # scores in log2 units
    kpos = torch.arange(n_pos)
    blk = table.long()[kpos // bs]
    kr, vr = ka[blk, kpos % bs].float(), va[blk, kpos % bs].float()
    out = torch.zeros(C, H, dh)
    for t in range(n_tiles):
        q0 = t * tq
        nq = min(tq, C - q0)
        qpos = positions[q0:q0 + nq].long()
        hi = min(int(qpos.max()) + 1, n_pos)
        lo = min(max(int(qpos.min()) - window + 1, 0) if window > 0 else 0, hi)
        first = lo // bs
        pages = (hi - 1) // bs - first + 1 if hi > lo else 0
        pps = max(min_pages, _cdiv(pages, n_split))
        n_live = max(_cdiv(pages, pps), 1)
        for kvh in range(K):
            # rows: query q0 + r // g, head kvh * g + r % g
            qt = q[q0:q0 + nq, kvh * g:(kvh + 1) * g].float().reshape(-1, dh)
            rpos = qpos.repeat_interleave(g)
            parts = []
            for s in range(n_live):
                kv_lo = max(lo, first * bs + s * pps * bs)
                kv_hi = min(hi, first * bs + (s + 1) * pps * bs)
                m = torch.full((nq * g,), -math.inf)
                l = torch.zeros(nq * g)
                acc = torch.zeros(nq * g, dh)
                for kb in range(kv_lo, kv_hi, KEYS):
                    ke = min(kb + KEYS, kv_hi)
                    kp = torch.arange(kb, ke)
                    sc = _product(qt, kr[kb:ke, kvh].T, mode) * sl2
                    ok = kp[None, :] <= rpos[:, None]
                    if window > 0:
                        ok &= rpos[:, None] - kp[None, :] < window
                    sc = torch.where(ok, sc, torch.tensor(-math.inf))
                    m_new = torch.maximum(m, sc.max(-1).values)
                    base = torch.where(m_new == -math.inf,
                                       torch.zeros_like(m_new), m_new)
                    p = torch.exp2(sc - base[:, None])
                    alpha = torch.exp2(m - base)
                    l = l * alpha + p.sum(-1)
                    if bf16:
                        p = p.to(torch.bfloat16).float()
                    acc = acc * alpha[:, None] + _product(p, vr[kb:ke, kvh],
                                                          mode)
                    m = m_new
                parts.append((acc, m, l))
            o = merge(parts) if n_live > 1 else \
                parts[0][0] / parts[0][2].clamp_min(1e-30)[:, None]
            out[q0:q0 + nq, kvh * g:(kvh + 1) * g] = o.reshape(nq, g, dh)
    return out.to(q.dtype)


def _prefill_inputs(n_past, C, true_c, H, K, dh, bs, dtype, seed):
    """A sequence of n_past + C tokens whose K/V lie in shuffled arena
    blocks, the chunk's queries at n_past.. and the table sliced to the
    engine's power-of-two page bucket for its n_past + true_c tokens.
    Returns the kernel's inputs and the contiguous ones for the Pallas
    flash kernel (q of every position, the chunk's last)."""
    rng = np.random.default_rng(seed)
    n = n_past + C
    q = rng.standard_normal((n, H, dh), np.float32)
    k = rng.standard_normal((n, K, dh), np.float32)
    v = rng.standard_normal((n, K, dh), np.float32)
    n_blocks = _cdiv(n, bs)
    order = rng.permutation(n_blocks) + 1             # block 0 is the junk
    ka = np.zeros((n_blocks + 1, bs, K, dh), np.float32)
    va = np.zeros_like(ka)
    kp = np.zeros((n_blocks * bs, K, dh), np.float32)
    vp = np.zeros_like(kp)
    kp[:n], vp[:n] = k, v
    ka[order] = kp.reshape(n_blocks, bs, K, dh)
    va[order] = vp.reshape(n_blocks, bs, K, dh)
    need = _cdiv(n_past + true_c, bs)
    span = 1
    while span < need:
        span *= 2
    table = np.zeros((span,), np.int32)
    table[:min(span, n_blocks)] = order[:span]
    positions = (n_past + np.arange(C)).astype(np.int32)
    _, q_t = _both(q[n_past:], dtype)
    _, ka_t = _both(ka, dtype)
    _, va_t = _both(va, dtype)
    kernel_args = (q_t, ka_t, va_t, torch.tensor(table),
                   torch.tensor(positions))
    return kernel_args, _both(q, dtype)[0], _both(k, dtype)[0], \
        _both(v, dtype)[0]


PREFILL_CASES = [
    # n_past, C, true_c, H, K, dh, bs, window, n_sm
    (0, 64, 64, 4, 2, 64, 8, 0, 132),       # one split
    (192, 64, 64, 4, 2, 64, 8, 0, 132),     # four splits, one tile
    (96, 32, 32, 8, 2, 32, 16, 0, 8),       # g = 4: 16 queries a tile
    (192, 64, 64, 4, 2, 64, 8, 48, 132),    # a window
    (224, 32, 5, 4, 4, 16, 8, 0, 132),      # ragged last chunk, g = 1
    (0, 32, 5, 4, 2, 16, 8, 0, 132),        # padded queries past the span
]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("n_past,C,true_c,H,K,dh,bs,window,n_sm",
                         PREFILL_CASES)
def test_prefill_split_emulation_matches_pallas_flash(
        n_past, C, true_c, H, K, dh, bs, window, n_sm, dtype):
    """The split prefill's arithmetic against the Pallas flash kernel
    (interpret) over the whole sequence, whose last C rows are the chunk's
    (the real ones: a padded query past the table's span sees only the
    span), and against the port's plain paged prefill on every row."""
    args, q_j, k_j, v_j = _prefill_inputs(n_past, C, true_c, H, K, dh, bs,
                                          dtype, seed=n_past + C + dh)
    got = prefill_split_emulation(*args, window=window, n_sm=n_sm)
    assert got.dtype == args[0].dtype and bool(torch.isfinite(got).all())
    plain = REFT.paged_prefill_attention_ref(*args, window=window)
    _close(got, plain, dtype)
    n = n_past + C
    blk = math.gcd(n, 128)
    want = FAJ.flash_attention(q_j[None], k_j[None], v_j[None], causal=True,
                               window=window, block_q=blk, block_k=blk,
                               interpret=True)[0, n_past:n_past + true_c]
    _close(got[:true_c], want, dtype)


@pytest.mark.parametrize("n_past,window", [(192, 0), (96, 0), (192, 48)])
def test_prefill_single_bf16_rounding_fails_the_f32_tolerance(n_past,
                                                              window):
    """Rounding each f32 operand once to bf16 (or using TF32) would not hold
    the f32 tolerance the split products hold."""
    args, q_j, k_j, v_j = _prefill_inputs(n_past, 64, 64, 4, 2, 64, 8,
                                          "float32", seed=n_past + window)
    blk = math.gcd(n_past + 64, 128)
    want = torch.tensor(np.asarray(FAJ.flash_attention(
        q_j[None], k_j[None], v_j[None], causal=True, window=window,
        block_q=blk, block_k=blk, interpret=True)[0, n_past:]))
    atol, rtol = TOL["float32"]
    split = prefill_split_emulation(*args, window=window, mode="split")
    torch.testing.assert_close(split, want, atol=atol, rtol=rtol)
    single = prefill_split_emulation(*args, window=window, mode="single")
    excess = ((single - want).abs() - (atol + rtol * want.abs())).max()
    assert excess > 0, "a single bf16 rounding passes the f32 tolerance"


# =============================================================================
# the host's plan
# =============================================================================
@pytest.mark.parametrize("n_pages,bs,groups,n_sm,ctas_per_sm,want", [
    (128, 16, 64, 132, 4, (16, 4, 528)),   # decode, batch 8 x 8 KV heads
    (128, 16, 8, 132, 4, (32, 4, 528)),    # decode, batch 1: MAX_SPLITS
    (64, 16, 8, 132, 1, (16, 4, 132)),     # prefill at n_past 992
    (16, 16, 8, 132, 1, (4, 4, 132)),      # prefill at n_past 224
    (2, 16, 8, 132, 1, (1, 4, 132)),       # prefill at n_past 0
    (8, 8, 2, 132, 1, (1, 8, 132)),        # SMOKE: one split of 64
])
def test_split_plan(n_pages, bs, groups, n_sm, ctas_per_sm, want):
    assert PAT.split_plan(n_pages, bs, groups, n_sm, ctas_per_sm) == want


def test_split_plan_reads_shapes_only():
    """The plan takes integers (the table's width, the block size, the
    groups, the SMs) — never the lengths or positions, which lie on the
    device — so the fused decode loop stays free of host syncs."""
    params = list(inspect.signature(PAT.split_plan).parameters)
    assert params == ["n_pages", "block_size", "n_groups", "n_sm",
                      "ctas_per_sm"]
    for n_pages in (1, 7, 64, 128, 2048):
        for groups in (1, 8, 64, 512):
            n_split, min_pages, ctas = PAT.split_plan(n_pages, 16, groups,
                                                      132, 4)
            assert 1 <= n_split <= PAT.MAX_SPLITS
            assert min_pages * 16 >= PAT.MIN_SPLIT_POSITIONS
            assert ctas == 4 * 132


def _misaligned(*shape: int) -> torch.Tensor:
    """A contiguous f32 tensor whose data starts 4 bytes past a 16-byte
    boundary."""
    n = math.prod(shape)
    base = torch.randn(n + 4)
    off = next(i for i in range(1, 4) if (base.data_ptr() + 4 * i) % 16)
    return base[off:off + n].view(shape)


@pytest.mark.parametrize("fault", ["dh 12", "misaligned q", "misaligned k"])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_paged_wrappers_refuse_what_16_byte_copies_cannot_read(
        monkeypatch, kernel, fault):
    """Both split-KV kernels stage q, K and V by cp.async, 16 bytes a
    thread, so their wrappers refuse a head dim that is not a multiple of
    8 and a tensor that does not start on a 16-byte boundary, before they
    build or launch.  The device check is patched out so that the refusal
    is reached on the CPU."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)

    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(_build, "extension", no_build)
    dh = 12 if fault == "dh 12" else 16
    H, K, bs, n_blocks = 4, 2, 8, 4
    q_shape = (2, H, dh) if kernel == "decode" else (6, H, dh)
    q = (_misaligned(*q_shape) if fault == "misaligned q"
         else torch.randn(q_shape))
    arena = (n_blocks, bs, K, dh)
    ka = _misaligned(*arena) if fault == "misaligned k" else torch.randn(arena)
    va = torch.randn(arena)
    before = (PAT.paged_decode_attention.launches,
              FAT.paged_prefill_attention.launches)
    with pytest.raises(ValueError, match="divisible by 8 and 16-byte"):
        if kernel == "decode":
            PAT.paged_decode_attention(
                q, ka, va, torch.tensor([[1, 2], [3, 0]], dtype=torch.int32),
                torch.tensor([9, 3], dtype=torch.int32))
        else:
            FAT.paged_prefill_attention(
                q, ka, va, torch.tensor([2, 1], dtype=torch.int32),
                torch.arange(6, dtype=torch.int32))
    assert (PAT.paged_decode_attention.launches,
            FAT.paged_prefill_attention.launches) == before
