"""paged_decode_roofline (kernels, ``kernels/paged_attention.py``): the
bytes bound of the split-KV paged decode launches in the traced slice
(each row's K and V at its length read once, its query and output, at
3.35 TB/s) over their time on the card (``decode_split_kernel`` on
``PagedKV``, whose last CTA merges the splits), in %.  Moves
``tokens_per_s``; serves ``paged_decode_roofline.tpot`` too (the g = 16
decode of glm4, which moves ``tpot_p95_ms``)."""
from clover_bench import yardstick as Y


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if not tr or not work or not tr["decode_kernel_s"] \
            or not work["decode_bytes"]:
        return None
    bound_s = work["decode_bytes"] / Y.HBM_BYTES_PER_S
    return 100.0 * bound_s / tr["decode_kernel_s"]
