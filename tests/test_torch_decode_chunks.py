"""The split-KV decode body's sliding window and row-chunks
(``csrc/decode_split.cuh``, both address policies), emulated in PyTorch on
the CPU step by step and held against the port's plain versions and the
reference model path's ``decode_attention_ref(window=...)`` on the same
numpy inputs; and the two decode wrappers' plan, reached on the CPU by
patching out the device check and the build.

The emulation follows the kernel: the host's plan (``decode_chunks``,
``split_plan`` over ``b · K · chunks`` groups), each row's visible range
``[lo, min(length, n_pos))`` with ``lo = max(length - window, 0)`` cut into
runs of ``pps`` pages from the range's first page, positions below ``lo``
masked, one CTA per (split, KV head · chunk, row) holding at most 8 query
rows, each live split's partial (acc, m, l; scores in log2 units) stored at
its offset of the f32 scratch, the arrival counter of its (row, KV head,
chunk), and the merge.  Tolerances are ``chip_smoke.TOL``'s."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as LJ
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as DAT
from repro_torch.kernels import paged_attention as PAT
from repro_torch.kernels import ref as REFT

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (4e-3, 1e-2)}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOG2E = 1.4426950408889634


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_emulation(q, kv_rows, lengths, n_pos, bs, window, n_sm):
    """csrc/decode_split.cuh on the CPU.  ``kv_rows(row)`` gives the row's
    (n_pos, K, dh) K and V (the paged policy gathers its table, the
    contiguous one slices the cache).  Returns (out in q's type, the
    positions each CTA loaded by (row, KV head · chunk), the counters
    after the launch)."""
    b, H, dh = q.shape
    k0, _ = kv_rows(0)
    K = k0.shape[1]
    g = H // K
    chunks, rows = PAT.decode_chunks(g)
    groups = b * K * chunks
    n_split, min_pages, ctas = PAT.split_plan(
        _cdiv(n_pos, bs), bs, groups, n_sm, PAT.DECODE_CTAS_PER_SM[q.dtype])
    rp = rows + rows % 2
    ps = PAT.partial_floats(rp, dh)
    part = torch.full((groups * n_split * ps,), math.nan)
    counters = torch.zeros(groups, dtype=torch.int32)
    lens = [int(x) for x in np.broadcast_to(np.asarray(lengths), (b,))]

    def visible(length):
        lo = max(length - window, 0) if window > 0 else 0
        return max(_cdiv(min(length, n_pos), bs) - lo // bs, 0), lo, lo // bs

    total = sum(visible(x)[0] for x in lens)
    out = torch.zeros(b, H, dh)
    loaded = {}
    for row in range(b):
        valid, lo, pf = visible(lens[row])
        length = min(lens[row], n_pos)
        pps = max(min_pages, _cdiv(valid, n_split),
                  _cdiv(total * K * chunks, ctas))
        n_live = max(_cdiv(valid, pps), 1)
        kr, vr = (t.float() for t in kv_rows(row))
        for y in range(K * chunks):
            kvh, r0 = y // chunks, y % chunks * rows
            gc = min(rows, g - r0)
            group = row * K * chunks + y
            qg = q[row, kvh * g + r0:kvh * g + r0 + gc].float()
            parts = []
            for s in range(n_live):
                p0 = (pf + s * pps) * bs
                pos = list(range(max(p0, lo), min(p0 + pps * bs, length)))
                loaded.setdefault((row, y), []).extend(pos)
                sc = qg @ kr[pos, kvh].T * (dh ** -0.5 * LOG2E)
                m = sc.max(-1).values if pos else torch.full((gc,),
                                                             -math.inf)
                p = torch.exp2(sc - m[:, None]) if pos else sc
                acc, l = p @ vr[pos, kvh], p.sum(-1)
                parts.append((acc, m, l))
                if n_live > 1:
                    off = (group * n_split + s) * ps
                    part[off:off + gc * dh] = acc.flatten()
                    part[off + rp * dh:off + rp * dh + gc] = m
                    part[off + rp * dh + rp:off + rp * dh + rp + gc] = l
                    counters[group] += 1
            if n_live > 1:
                assert int(counters[group]) == n_live   # the last arrives
                counters[group] = 0
                base = group * n_split * ps
                parts = [(part[base + s * ps:base + s * ps + gc * dh].view(
                    gc, dh), part[base + s * ps + rp * dh:][:gc],
                    part[base + s * ps + rp * dh + rp:][:gc])
                    for s in range(n_live)]
            M = torch.stack([m for _, m, _ in parts]).max(0).values
            o, L = torch.zeros(gc, dh), torch.zeros(gc)
            for acc, m, l in parts:
                c = torch.where(m == -math.inf, torch.zeros_like(m),
                                torch.exp2(m - torch.where(
                                    M == -math.inf, torch.zeros_like(M), M)))
                o += c[:, None] * acc
                L += c * l
            out[row, kvh * g + r0:kvh * g + r0 + gc] = o / L.clamp_min(
                1e-30)[:, None]
    return out.to(q.dtype), loaded, counters


def _inputs(b, n_pos, bs, H, K, dh, dtype, seed, paged):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, dh)).astype(np.float32)
    if paged:
        n_pages = n_pos // bs
        nb = b * n_pages + 1
        ka = rng.standard_normal((nb, bs, K, dh)).astype(np.float32)
        va = rng.standard_normal((nb, bs, K, dh)).astype(np.float32)
        tables = rng.permutation(np.arange(1, nb)).reshape(
            b, n_pages).astype(np.int32)
        return q, ka, va, tables
    kc = rng.standard_normal((b, n_pos, K, dh)).astype(np.float32)
    vc = rng.standard_normal((b, n_pos, K, dh)).astype(np.float32)
    return q, kc, vc, None


CASES = [
    # b, n_pos, bs, H, K, dh, lengths, window, n_sm: glm4's g = 16 (two
    # chunks of 8), gemma3's shape scaled down (window shorter than some
    # rows, longer than others, edges inside and on page boundaries), a
    # group of 12 (two chunks of 6) and of 9 (5 + 4), qwen2's g = 7
    (4, 128, 8, 32, 2, 16, (128, 1, 70, 33), 0, 8),
    (4, 128, 8, 32, 2, 16, (128, 1, 70, 33), 24, 8),
    (3, 256, 16, 4, 2, 32, (256, 17, 200), 64, 132),
    (3, 256, 16, 4, 2, 32, (256, 17, 200), 48, 4),
    (2, 96, 8, 12, 1, 16, (96, 40), 16, 16),
    (2, 96, 8, 9, 1, 16, (95, 9), 8, 16),
    (2, 64, 8, 7, 1, 8, (64, 20), 10, 4),
]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("b,n_pos,bs,H,K,dh,lengths,window,n_sm", CASES)
def test_windowed_row_chunk_emulation_matches_plain_and_reference(
        b, n_pos, bs, H, K, dh, lengths, window, n_sm, dtype, paged):
    """The emulated kernel against the port's plain version and the
    reference model path's windowed ``decode_attention_ref``; every CTA
    loads exactly its row's visible positions, each once, and the pages
    it touches are those of the window."""
    bs = bs if paged else DAT.CONTIG_PAGE
    q, k, v, tables = _inputs(b, n_pos, bs, H, K, dh, dtype,
                              b * n_pos + window, paged)
    td = DT[dtype]
    qt, kt, vt = (torch.tensor(x).to(td) for x in (q, k, v))
    ln = np.asarray(lengths, np.int32)
    if paged:
        tt = torch.tensor(tables)

        def kv_rows(row):
            idx = tt[row].long()
            return (kt[idx].reshape(-1, K, dh), vt[idx].reshape(-1, K, dh))
        plain = REFT.paged_decode_attention_ref(qt, kt, vt, tt,
                                                torch.tensor(ln),
                                                window=window)
    else:
        def kv_rows(row):
            return kt[row], vt[row]
        plain = REFT.decode_attention_ref(qt, kt, vt, torch.tensor(ln),
                                          window=window)
    got, loaded, counters = decode_emulation(qt, kv_rows, ln, n_pos, bs,
                                                window, n_sm)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), plain.float(), atol=atol,
                               rtol=rtol)
    kf, vf = (jnp.asarray(t.float().numpy()) for t in (kt, vt))
    if paged:
        kf, vf = LJ.gather_paged_kv(kf, vf, jnp.asarray(tables))
    want = LJ.decode_attention_ref(jnp.asarray(qt.float().numpy())[:, None],
                                   kf, vf, jnp.asarray(ln), window=window)
    torch.testing.assert_close(got.float(), torch.tensor(np.asarray(
        want)[:, 0]), atol=atol, rtol=rtol)
    assert not counters.any()                 # left at zero for the next
    for (row, _), pos in loaded.items():
        lo = max(int(ln[row]) - window, 0) if window > 0 else 0
        assert sorted(pos) == list(range(lo, min(int(ln[row]), n_pos)))
        assert {p // bs for p in pos} <= set(
            range(lo // bs, _cdiv(int(ln[row]), bs)))


@pytest.mark.parametrize("g", range(1, 17))
@pytest.mark.parametrize("dh", [8, 16, 64, 80, 128])
def test_row_chunk_partial_layout(g, dh):
    """A group of g heads runs as chunks of at most 8 rows that cover its
    heads exactly once; every chunk's partial starts 16-byte aligned (its
    rows padded to an even count), holds acc, m and l of its rows, and no
    two partials of a launch overlap; one arrival counter per (row, KV
    head, chunk)."""
    chunks, rows = PAT.decode_chunks(g)
    assert chunks == _cdiv(g, _build.MAX_ROWS) and rows <= _build.MAX_ROWS
    heads = []
    for c in range(chunks):
        gc = min(rows, g - c * rows)
        assert gc >= 1
        heads += range(c * rows, c * rows + gc)
    assert heads == list(range(g))
    rp = rows + rows % 2
    ps = PAT.partial_floats(rp, dh)
    assert ps % 4 == 0 and rows * (dh + 2) <= ps
    b, K, n_split = 3, 2, 5
    used = np.zeros(b * K * chunks * n_split * ps, bool)
    for group in range(b * K * chunks):
        for s in range(n_split):
            off = (group * n_split + s) * ps
            assert (4 * off) % 16 == 0
            assert not used[off:off + ps].any()
            used[off:off + ps] = True
    assert used.all()


def test_a_local_layer_reads_only_its_window():
    """gemma3's shape scaled to the emulation: rows of 2048 positions and
    a window of 1024 load 1024 positions each, from 64 of the 128 pages —
    the same rows with no window load all 2048."""
    b, n_pos, bs, H, K, dh = 2, 2048, 16, 2, 1, 8
    q, k, v, tables = _inputs(b, n_pos, bs, H, K, dh, "float32", 0, True)
    kt, vt, tt = torch.tensor(k), torch.tensor(v), torch.tensor(tables)

    def kv_rows(row):
        idx = tt[row].long()
        return kt[idx].reshape(-1, K, dh), vt[idx].reshape(-1, K, dh)
    ln = np.array([2048, 1500], np.int32)
    for window, want in ((1024, (1024, 1024)), (0, (2048, 1500))):
        _, loaded, _ = decode_emulation(torch.tensor(q), kv_rows, ln,
                                           n_pos, bs, window, 132)
        assert tuple(len(loaded[row, 0]) for row in range(b)) == want
        pages = {p // bs for p in loaded[0, 0]}
        assert len(pages) == (64 if window else 128)


def _no_card(monkeypatch):
    """Let the decode wrappers run their checks and plan on CPU tensors:
    the device check patched out, a card of 132 SMs, counters recorded, and
    an extension that records what it is given in place of the build."""
    calls, wanted = [], []

    class Ext:
        def decode(self, *args):
            calls.append(("decode", args))

        def paged_decode(self, *args):
            calls.append(("paged", args))

    def counters(device, n):
        wanted.append(n)
        return torch.zeros(max(n, 4096), dtype=torch.int32)

    monkeypatch.setattr(_build, "on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "counters", counters)
    monkeypatch.setattr(_build, "extension", lambda verbose=False: Ext())
    return calls, wanted


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,window", [(32, 2, 0), (32, 2, 1024),
                                        (32, 16, 1024), (14, 2, 0)])
def test_decode_wrappers_plan_chunks_and_pass_the_window(monkeypatch, dtype,
                                                         H, K, window):
    """Both wrappers plan ``b · K · chunks`` groups (split plan, scratch of
    their partials, one counter each) and hand the kernel the window, at
    glm4's (32 heads over 2), gemma3's (over 16) and qwen2's (14 over 2)
    group sizes; a window changes nothing in the plan."""
    calls, wanted = _no_card(monkeypatch)
    b, dh, S, bs, n_pages = 8, 128, 2048, 16, 128
    q = torch.zeros(b, H, dh, dtype=dtype)
    kc = torch.zeros(b, S, K, dh, dtype=dtype)
    ka = torch.zeros(b * n_pages + 1, bs, K, dh, dtype=dtype)
    tables = torch.zeros(b, n_pages, dtype=torch.int32)
    ln = torch.full((b,), 1500, dtype=torch.int32)
    DAT.decode_attention(q, kc, kc, ln, window=window)
    PAT.paged_decode_attention(q, ka, ka, tables, ln, window=window)
    chunks, rows = PAT.decode_chunks(H // K)
    groups = b * K * chunks
    assert wanted == [groups, groups]
    for (kind, args), n in zip(calls, (_cdiv(S, 16), n_pages)):
        n_split, min_pages, ctas = PAT.split_plan(
            n, 16, groups, 132, PAT.DECODE_CTAS_PER_SM[dtype])
        # the contiguous decode's arguments: (q, k, v, lengths,
        # window_end, out, lse, part, counters, min_pages, ...)
        at = 9 if kind == "decode" else 8
        assert tuple(args[at:at + 3]) == (min_pages, n_split, ctas)
        part = args[7] if kind == "decode" else args[6]
        assert part.numel() == (groups * n_split * PAT.partial_floats(
            rows + rows % 2, dh) if n_split > 1 else 0)
        assert args[-1] == window


@pytest.mark.parametrize("H,K,ok", [(16, 1, True), (32, 2, True),
                                    (17, 1, False), (64, 2, False)])
def test_decode_wrappers_take_groups_of_up_to_16(monkeypatch, H, K, ok):
    """g = H / K up to 16 is taken by both decode wrappers (the row-chunk
    grid); above it they raise before building or launching."""
    calls, _ = _no_card(monkeypatch)
    q = torch.zeros(2, H, 16)
    kc = torch.zeros(2, 32, K, 16)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    ln = torch.tensor([5, 32], dtype=torch.int32)
    for run in (lambda: DAT.decode_attention(q, kc, kc, ln),
                lambda: PAT.paged_decode_attention(q, kc, kc, tables, ln)):
        if ok:
            run()
        else:
            with pytest.raises(ValueError, match="g <= 16"):
                run()
    assert len(calls) == (2 if ok else 0)
