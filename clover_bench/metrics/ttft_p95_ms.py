"""ttft_p95_ms.<cell kind> (engine loop, ``serving/engine.py``): the 95th
percentile over every request due in the measured window of first token
landed - due time, in ms, as a per-layer metric where the tail is the
host loop's pace and its runs spread too widely for an end-to-end bound
(``PERF.md`` section 2).  Read from the untraced window."""
from clover_bench.readers import ttft_p95_ms as read  # noqa: F401
