"""mfu (model step, ``models/transformer.py`` through
``models/registry.py``): model FLOPs of the prefill chunks and decode
tokens of the traced slice (projections and MLP, attention at each
token's context, one row of logits a prompt and a decode token), counted
from the shapes and lengths the engine passed to its entry points, over
the slice's seconds at the bf16 peak, in %.  Split by the end-to-end
metric it moves (``mfu.throughput``, ``.tpot``, ``.energy``;
``BENCHMARK.json`` names which)."""
from clover_bench.readers import mfu as read  # noqa: F401
