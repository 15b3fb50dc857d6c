"""Cells of ``BENCHMARK.json`` cut to a size a CPU test can hold: the
same files, the same harness and engine path, widths of a few dozen and
traffic of a few requests a second.  For the benchmark's own tests."""
from __future__ import annotations

import json

from clover_bench import harness

# the limit of ``gap_max`` at this size, placed as the cells' are: sound
# runs here read under a third of it (the cells' limits, set at their own
# sizes from the card's readings, do not carry over to a width of 256)
LIMIT = 0.1
TINY_MODEL = {"n_layers": 4, "d_model": 256, "n_heads": 8, "n_kv_heads": 2,
              "d_head": 32, "d_ff": 512, "vocab_size": 2048}


def cell(name: str) -> harness.Cell:
    manifest = json.load(open(harness.ROOT / "BENCHMARK.json"))
    c = harness.Cell.load(manifest, name)
    c.config["model"].update(TINY_MODEL)
    c.limits = {"gap_max": LIMIT}
    m = c.mix
    m["engine"].update({"max_seqs": 4, "max_len": 160, "n_blocks": 60,
                        "chunk_blocks": 2})
    if m["loop"] == "closed":
        m["clients"] = 4
        m["suffix"] = {"dist": "uniform", "lo": 8, "hi": 40}
        m["output"] = {"dist": "uniform", "lo": 8, "hi": 32}
        m["residual"] = False        # every answer decodes 8 tokens or more
    else:
        m["rate_rps"] = 1.0      # well inside a loaded CPU's capacity
        m["prefix"]["len"] = {"dist": "uniform", "lo": 16, "hi": 60}
        m["prefix"]["count"] = min(m["prefix"]["count"], 8)
        m["suffix"] = {"dist": "uniform", "lo": 4, "hi": 20}
        m["output"] = {"dist": "uniform", "lo": 8, "hi": 24}
        m["warm"]["lead_in_s"] = 0.5
        if m["warm"].get("prefix_fill"):
            m["warm"]["prefix_fill"] = 4
    return c
