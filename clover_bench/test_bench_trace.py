"""The reduction of a profiled slice: busy time as a union, kernels by
name, and idle gaps named by the host's innermost range."""
from clover_bench.trace import SLICE, DeviceTrace


def _rows():
    return [(SLICE, False, 0.0, 100.0),
            ("bench.step", False, 0.0, 60.0),
            ("aten::mm", False, 5.0, 15.0),
            ("cudaStreamSynchronize", False, 40.0, 58.0),
            ("bench.wait", False, 60.0, 100.0),
            ("gemm", True, 10.0, 30.0),
            ("gemm", True, 20.0, 35.0),          # overlaps the first
            ("decode_split_kernel<float, PagedKV>", True, 50.0, 55.0)]


def test_busy_is_a_union_within_the_slice():
    tr = DeviceTrace(_rows())
    assert tr.window_s == 100e-6
    assert abs(tr.busy_s - 30e-6) < 1e-12        # [10, 35] + [50, 55]


def test_kernels_by_name():
    tr = DeviceTrace(_rows())
    assert abs(tr.kernel_s(lambda n: "PagedKV" in n) - 5e-6) < 1e-12
    assert tr.top_ops(1)[0][0] == "gemm"


def test_idle_named_by_what_the_host_did():
    idle = dict(DeviceTrace(_rows()).idle_by_host())
    # gaps: [0, 10] in bench.step (aten::mm at 5), [35, 50] at 42.5 in the
    # sync, [55, 100] at 77.5 in bench.wait with no operation open
    assert abs(idle["bench.step/aten::mm"] - 10e-6) < 1e-12
    assert abs(idle["bench.step/cudaStreamSynchronize"] - 15e-6) < 1e-12
    assert abs(idle["bench.wait/python"] - 45e-6) < 1e-12


def test_a_slice_without_the_host_spans_the_device_events():
    rows = [r for r in _rows() if r[1]]
    tr = DeviceTrace(rows)
    assert tr.window_s == 45e-6 and abs(tr.busy_s - 30e-6) < 1e-12
