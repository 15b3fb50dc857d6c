"""The traffic generator: deterministic from the seed, the same sizes for
every seed in another order, and the lengths and shares each mix file
states."""
import json
import statistics

import numpy as np
import pytest

from clover_bench import generate, harness

MIXES = ("reasoning", "rag", "clover-mix")


def _mix(name):
    return json.load(open(harness.HERE / "traffic" / f"{name}.json"))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = generate.Traffic(_mix(name), 2**31 + 77, 1000)
    b = generate.Traffic(_mix(name), 2**31 + 77, 1000)
    for i in (0, 5, 130):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert (ra.max_new_tokens, ra.slo, ra.hint) == \
            (rb.max_new_tokens, rb.slo, rb.hint)
    if not a.closed:
        assert a.due(100) == b.due(100)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_sizes(name):
    t1, t2 = (generate.Traffic(_mix(name), seed, 1000)
              for seed in (3, 2**32 + 9))
    for i in range(2 * generate.BLOCK):
        a, b = t1.request(i), t2.request(i)
        assert (len(a.prompt), a.max_new_tokens, a.slo, a.hint,
                a.prefix_id) == (len(b.prompt), b.max_new_tokens, b.slo,
                                 b.hint, b.prefix_id)
        if not t1.closed:
            assert t1.due(i) == t2.due(i)
    assert t1.request(5).prompt[:8].tolist() != \
        t2.request(5).prompt[:8].tolist()


def test_blocks_hold_the_same_quantiles_in_another_order():
    mix = _mix("reasoning")
    t = generate.Traffic(mix, 1, 1000)
    blocks = [[t.request(i).max_new_tokens for i in range(b * 64, b * 64 + 64)]
              for b in (1, 2)]
    assert sorted(blocks[0]) == sorted(blocks[1])
    assert blocks[0] != blocks[1]


def test_lengths_within_the_stated_ranges():
    for name in MIXES:
        mix = _mix(name)
        t = generate.Traffic(mix, 11, 151936)
        for i in range(3 * generate.BLOCK):
            r = t.request(i)
            assert mix["output"]["lo"] <= r.max_new_tokens <= \
                mix["output"]["hi"] or (t.closed and i < mix["clients"])
            own = len(r.prompt) - (len(t.prefixes[r.prefix_id])
                                   if r.prefix_id >= 0 else 0)
            if t.closed and i < mix["clients"]:
                # the answer so far stands in the prompt
                assert own + r.max_new_tokens <= mix["suffix"]["hi"] + \
                    mix["output"]["hi"]
                continue
            assert mix["suffix"]["lo"] <= own <= mix["suffix"]["hi"]
            assert r.prompt.max() < 151936 and r.prompt.min() >= 0


def test_uniform_and_lognormal_quantiles():
    u = generate.stratified(np.random.default_rng(0), 640)
    lens = generate._quantile_len({"dist": "uniform", "lo": 256,
                                   "hi": 1024}, u)
    assert abs(lens.mean() - 640) < 3
    ln = generate._quantile_len({"dist": "lognormal", "median": 256,
                                 "sigma": 1.0, "lo": 16, "hi": 1536}, u)
    assert abs(statistics.median(ln.tolist()) - 256) <= 3
    assert ln.min() >= 16 and ln.max() <= 1536


def test_closed_loop_residual_budgets():
    mix = _mix("reasoning")
    t = generate.Traffic(mix, 5, 1000)
    first = [t.request(i).max_new_tokens for i in range(mix["clients"])]
    later = [t.request(i).max_new_tokens
             for i in range(mix["clients"], 2 * mix["clients"])]
    assert min(first) >= 1 and max(first) <= mix["output"]["hi"]
    assert statistics.mean(first) < 0.7 * statistics.mean(later)
    assert min(later) >= mix["output"]["lo"]


def test_mix_shares_and_hints():
    mix = _mix("clover-mix")
    t = generate.Traffic(mix, 2**31 + 3, 151936)
    reqs = [t.request(i) for i in range(10 * generate.BLOCK)]
    share = sum(r.prefix_id >= 0 for r in reqs) / len(reqs)
    assert abs(share - 0.6) < 0.02
    inter = [r for r in reqs if r.slo == "interactive"]
    assert abs(len(inter) / len(reqs) - 0.7) < 0.02
    assert all(r.hint is None for r in reqs if r.slo == "deferrable")
    x1 = sum(r.hint == "x1" for r in inter) / len(inter)
    assert abs(x1 - 0.6) < 0.05
    assert {len(p) for p in t.prefixes} <= set(range(256, 769))
    assert len(t.prefixes) == 4


def test_rag_documents_and_popularity():
    mix = _mix("rag")
    t = generate.Traffic(mix, 1, 151552)
    lens = [len(p) for p in t.prefixes]
    assert len(lens) == 256 and min(lens) >= 1024 and max(lens) <= 8192
    assert 0.7e6 < sum(lens) < 1.1e6           # ~0.9 M tokens in the pool
    picks = [t.request(i).prefix_id for i in range(20 * generate.BLOCK)]
    counts = np.bincount(picks, minlength=256)
    assert counts[0] == counts.max()
    # Zipf s = 1 over 256: the first document takes 1 / H(256) = 16%
    assert abs(counts[0] / len(picks) - 1 / sum(1 / k for k in
                                                range(1, 257))) < 0.02
    # every seed holds the same document lengths
    t2 = generate.Traffic(mix, 2, 151552)
    assert [len(p) for p in t2.prefixes] == lens


def test_poisson_arrivals_rate():
    mix = dict(_mix("rag"), rate_rps=2.5)
    t = generate.Traffic(mix, 9, 1000)
    n = 10 * generate.BLOCK
    assert abs(t.due(n - 1) / n - 1 / 2.5) < 0.01 / 2.5
    gaps = np.diff([0.0] + [t.due(i) for i in range(n)])
    assert (gaps > 0).all()
