"""device_idle (device, H100): the share (%) of the traced slice in which
no kernel, copy or fill ran on the card, from ``torch.profiler``.  Split
by the end-to-end metric it moves (``device_idle.throughput``,
``.tpot``, ``.energy``; ``BENCHMARK.json`` names which)."""
from clover_bench.readers import device_idle as read  # noqa: F401
