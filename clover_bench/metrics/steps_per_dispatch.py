"""steps_per_dispatch (engine loop, ``serving/engine.py``): decode steps
landed per decode dispatch over the window, from the engine's counters.
Moves ``tokens_per_s``."""


def read(ctx):
    c = ctx["counters"]
    if not c["decode_dispatches"]:
        return None
    return c["decode_steps"] / c["decode_dispatches"]
