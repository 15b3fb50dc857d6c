"""The operations and bytes the metrics divide by, against hand sums."""
import torch

from clover_bench import harness
from clover_bench import weights as W
from clover_bench import yardstick as Y

QWEN = {"family": "dense", "d_model": 2048, "n_heads": 16, "n_kv_heads": 8,
        "d_head": 128, "d_ff": 6144, "vocab_size": 151936}
DENSE = W.family("dense")
PROJ = DENSE.proj_flops(QWEN, 28)


def test_projection_flops_qwen3():
    per_layer = 2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048 + \
        3 * 2048 * 6144
    assert PROJ == 2 * per_layer * 28
    assert Y.head_flops(QWEN) == 2 * 2048 * 151936


def test_causal_keys_by_brute_force():
    for n_past, n in ((0, 1), (0, 17), (992, 32), (4096, 1024)):
        assert Y.causal_keys(n_past, n) == sum(n_past + i + 1
                                               for i in range(n))


def test_decode_and_prefill_flops():
    keys = 1700.0
    assert Y.decode_flops(QWEN, 28, keys, PROJ) == PROJ + \
        4 * 16 * 128 * keys * 28 + 2 * 2048 * 151936
    f = Y.prefill_flops(QWEN, 28, 100, 8, True, PROJ)
    brute = sum(Y.decode_flops(QWEN, 28, 100 + i + 1, PROJ)
                for i in range(8)) - 7 * Y.head_flops(QWEN)
    assert abs(f - brute) < 1e-6 * brute


def test_paged_kernel_bytes_and_bound():
    # one layer, 2 rows of 10 and 20 positions, f32 K/V: 8 KV heads x 128
    b = Y.paged_decode_bytes(QWEN, 30, 2, 4)
    assert b == 30 * 2 * 8 * 128 * 4 + 2 * 2 * 16 * 128 * 4
    # a long chunk is bound by its operations, a short one by its bytes
    long_ = Y.paged_prefill_bound_s(QWEN, 4096, 1024, 4)
    ops = 4 * 16 * 128 * Y.causal_keys(4096, 1024)
    assert long_ == ops / Y.PEAK_F32_SPLIT
    short = Y.paged_prefill_bound_s(QWEN, 8192, 1, 4)
    assert short == (8193 * 2 * 8 * 128 * 4 + 2 * 16 * 128 * 4) / \
        Y.HBM_BYTES_PER_S


def test_worklog_totals_against_loops():
    log = harness.WorkLog()
    ln = torch.tensor([10, 0, 30, 5], dtype=torch.int32)
    act = torch.tensor([True, False, True, True])
    log.decode.append((28, 3, ln, act, True))
    log.prefill.append((28, 64, 32, True))
    log.prefill.append((28, 0, 512, False))     # outside the slice
    t = log.totals(QWEN, 4, n_first=2,
                   proj=lambda n: DENSE.proj_flops(QWEN, n))
    flops = 2 * Y.head_flops(QWEN) + Y.prefill_flops(QWEN, 28, 64, 32,
                                                     False, PROJ)
    keys_all = 0.0
    for length, a in zip(ln.tolist(), act.tolist()):
        for s in range(1, 4):
            if a:
                flops += Y.decode_flops(QWEN, 28, length + s, PROJ)
                keys_all += length + s
            else:
                keys_all += length + 1
    assert abs(t["flops"] - flops) < 1e-9 * flops
    dec = 28 * 3 * Y.paged_decode_bytes(QWEN, keys_all / 3, 4, 4)
    assert abs(t["decode_bytes"] - dec) < 1e-9 * dec
    assert t["prefill_bound_s"] == 28 * Y.paged_prefill_bound_s(
        QWEN, 64, 32, 4)
