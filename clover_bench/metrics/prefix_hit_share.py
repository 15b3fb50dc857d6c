"""prefix_hit_share (KV pool, ``serving/kvpool/``): prompt tokens served
from the radix prefix cache at admission, as a share (%) of the prompt
tokens of the requests admitted in the measured window.  Serves
``prefix_hit_share.mix`` too."""


def read(ctx):
    c = ctx["counters"]
    if not c["prompt_tokens_admitted"]:
        return None
    return 100.0 * c["prefix_hit_tokens"] / c["prompt_tokens_admitted"]
