"""tpot_p95_ms.<cell kind> (engine loop, ``serving/engine.py``): the 95th
percentile over every request due in the measured window of (last -
first token) / (tokens - 1), in ms, as a per-layer metric where the card
is idle most of the window and the tail is the host loop's pace
(``PERF.md`` section 2).  Read from the untraced window."""
from clover_bench.readers import tpot_p95_ms as read  # noqa: F401
