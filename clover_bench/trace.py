"""Reduction of a ``torch.profiler`` slice to what the per-layer metrics
and the result's ``breakdown`` read: the device's busy time (the union of
its kernels, copies and fills), time by kernel name, and the idle gaps
named by what the host was doing while the device waited.

The host's activity is the innermost profiled CPU range open at a gap's
middle: an ``aten::`` operation or CUDA call of the program, inside the
harness's own ranges (``bench.step`` around ``RealEngine.step``,
``bench.submit``, ``bench.wait``); a gap in no operation is the
harness range's own Python, written ``<range>/python``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

SLICE = "bench.slice"


def rows(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start µs, end µs) of every event of a
    finished ``torch.profiler.profile``, read from its raw kineto events
    (far cheaper than ``prof.events()``); the device's own ranges of
    user annotations are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.is_user_annotation():
            continue
        out.append((e.name(), dev, e.start_ns() / 1e3, e.end_ns() / 1e3))
    return out


class DeviceTrace:
    """Device intervals and host ranges of one profiled slice (µs on the
    profiler's clock).  The slice is the harness's ``bench.slice`` range
    where the host was profiled, else the span of the device events."""

    def __init__(self, events: List[Tuple[str, bool, float, float]]) -> None:
        self.dev: List[Tuple[float, float, str]] = []
        self.cpu: List[Tuple[float, float, str]] = []
        self.ranges: List[Tuple[float, float, str]] = []
        self.t0 = self.t1 = None
        for name, on_dev, a, b in events:
            if on_dev:
                self.dev.append((a, b, name))
            elif name == SLICE:
                self.t0, self.t1 = a, b
            elif name.startswith("bench."):
                self.ranges.append((a, b, name))
            else:
                self.cpu.append((a, b, name))
        self.dev.sort()
        self.cpu.sort()
        self.ranges.sort()
        if self.t0 is None and self.dev:
            self.t0 = self.dev[0][0]
            self.t1 = max(b for _, b, _ in self.dev)
        self._merged = self._merge() if self.t0 is not None else []

    def _merge(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for a, b, _ in self.dev:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def window_s(self) -> float:
        return 0.0 if self.t0 is None else (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged) / 1e6

    def kernel_s(self, pick: Callable[[str], bool]) -> float:
        """Seconds of the device events whose name ``pick`` accepts."""
        return sum(b - a for a, b, n in self.dev if pick(n)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for a, b, name in self.dev:
            tot[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost CPU range open at ``t``, under its outermost
        harness range."""
        outer = "outside"
        j = bisect.bisect_right(self.ranges, (t, float("inf"), ""))
        if j and self.ranges[j - 1][1] >= t:
            outer = self.ranges[j - 1][2]
        i = bisect.bisect_right(self.cpu, (t, float("inf"), ""))
        for a, b, name in reversed(self.cpu[max(0, i - 64):i]):
            if b >= t:
                return f"{outer}/{name}"
        return f"{outer}/python"

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle seconds of the slice summed by what the host was doing,
        largest first."""
        tot: Dict[str, float] = defaultdict(float)
        prev = self.t0
        for a, b in self._merged + [(self.t1, self.t1)]:
            if a > prev:
                tot[self._host_at((a + prev) / 2)] += (a - prev) / 1e6
            prev = max(prev, b)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]
