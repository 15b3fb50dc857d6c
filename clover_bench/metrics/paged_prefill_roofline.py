"""paged_prefill_roofline (kernels, ``kernels/flash_attention.py``, its
paged chunked-prefill form): the larger of the operations and bytes
bounds of the paged prefill launches in the traced slice (the real
queries of each chunk, causal over every visible position) over the time
of ``paged_prefill_split_kernel`` and ``paged_prefill_merge_kernel`` on
the card, in %.  Moves ``tpot_p95_ms``: a question's chunk runs between the
decode steps of the rows in flight."""


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if not tr or not work or not tr["prefill_kernel_s"] \
            or not work["prefill_bound_s"]:
        return None
    return 100.0 * work["prefill_bound_s"] / tr["prefill_kernel_s"]
