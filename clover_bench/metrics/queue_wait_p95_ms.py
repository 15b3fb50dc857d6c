"""queue_wait_p95_ms (engine loop, ``serving/engine.py``): the 95th
percentile of the engine's own ``queue_delay_s`` (due time to admission)
over the requests due in the measured window."""
from clover_bench.readers import percentile


def read(ctx):
    p = percentile([r.resp.queue_delay_s for r in ctx["due_in"]
                    if r.resp is not None], 95)
    return None if p is None else 1e3 * p
