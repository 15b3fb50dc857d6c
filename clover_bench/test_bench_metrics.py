"""Each per-layer metric's reader on synthetic inputs, and the readers
that ``BENCHMARK.json`` names."""
import json
import types

import pytest

from clover_bench import harness, readers
from clover_bench import yardstick as Y

MANIFEST = json.load(open(harness.ROOT / "BENCHMARK.json"))


def _ctx(**kw):
    ctx = {"counters": {"decode_dispatches": 0, "decode_steps": 0,
                        "prefix_hit_tokens": 0,
                        "prompt_tokens_admitted": 0},
           "due_in": [], "work": None, "trace": None, "window_s": 10.0,
           "t_w1": 0.0}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_reader_exists_and_reads_nothing_from_nothing(name):
    assert harness.load_reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_reader_file_is_the_metrics_own_or_its_bases(name):
    path = harness.reader_path(name)
    assert path.is_file()
    assert path.stem in (name, name.split(".", 1)[0])


def test_steps_per_dispatch():
    read = harness.load_reader("steps_per_dispatch")
    c = _ctx()
    c["counters"].update(decode_dispatches=40, decode_steps=200)
    assert read(c) == 5.0


def test_queue_wait_p95():
    read = harness.load_reader("queue_wait_p95_ms")
    recs = [types.SimpleNamespace(resp=types.SimpleNamespace(
        queue_delay_s=i / 1000)) for i in range(1, 101)]
    recs.append(types.SimpleNamespace(resp=None))
    assert read(_ctx(due_in=recs)) == pytest.approx(95.0)


def test_prefix_hit_share():
    read = harness.load_reader("prefix_hit_share")
    c = _ctx()
    c["counters"].update(prefix_hit_tokens=300, prompt_tokens_admitted=1200)
    assert read(c) == 25.0


@pytest.mark.parametrize("name", ["mfu.throughput", "mfu.tpot",
                                  "mfu.energy"])
def test_mfu(name):
    read = harness.load_reader(name)
    work = {"flops": 0.5 * Y.PEAK_BF16}
    assert read(_ctx(work=work, trace={"window_s": 5.0})) == \
        pytest.approx(10.0)


@pytest.mark.parametrize("name", ["device_idle.throughput",
                                  "device_idle.tpot",
                                  "device_idle.energy"])
def test_device_idle(name):
    read = harness.load_reader(name)
    assert read(_ctx(trace={"busy_s": 1.5, "window_s": 2.0})) == \
        pytest.approx(25.0)


def test_kernel_rooflines():
    work = {"decode_bytes": Y.HBM_BYTES_PER_S * 0.010,
            "prefill_bound_s": 0.003}
    tr = {"decode_kernel_s": 0.020, "prefill_kernel_s": 0.012}
    for name in ("paged_decode_roofline", "paged_decode_roofline.tpot"):
        assert harness.load_reader(name)(
            _ctx(work=work, trace=tr)) == pytest.approx(50.0)
    assert harness.load_reader("paged_prefill_roofline")(
        _ctx(work=work, trace=tr)) == pytest.approx(25.0)


def test_percentile_nearest_rank():
    assert readers.percentile(list(range(1, 21)), 95) == 19
    assert readers.percentile([3.0], 95.0) == 3.0
    assert readers.percentile([], 95) is None


@pytest.mark.parametrize("name", ["ttft_p95_ms.mix", "tpot_p95_ms.mix",
                                  "ttft_p95_ms.rag"])
def test_host_paced_tails(name):
    recs = [types.SimpleNamespace(due=0.0, first=0.1 * i, last=0.1 * i + 1.0,
                                  n=11) for i in range(1, 21)]
    recs.append(types.SimpleNamespace(due=0.0, first=None, last=None, n=0))
    got = harness.load_reader(name)(_ctx(due_in=recs, t_w1=5.0))
    # TTFT: 20 answers of 0.1-2.0 s and one that never started (counted at
    # the longest wait seen, 5.0 s): the 20th of 21; TPOT: 0.1 s each
    assert got == pytest.approx(2000.0 if name.startswith("ttft") else 100.0)
