"""Paged KV-cache memory subsystem for the real-execution engine.

The slotted cache reserves ``max_len`` tokens per sequence no matter
how short the prompt is; this package replaces that with vLLM-style paging:

  * ``allocator``  — fixed-size KV blocks carved from one preallocated arena,
    free-list allocation, refcounting, copy-on-write;
  * ``prefix``     — a radix tree over prompt tokens at block granularity,
    deduplicating shared prefixes across admitted requests with LRU eviction
    of unreferenced nodes.

The device-side arena itself lives in ``models.registry.make_block_arena``;
the paged decode kernel is ``kernels.paged_attention``; the serving loop
(`serving.engine.PagedInstance`) wires all of it together.
"""
from repro_torch.serving.kvpool.allocator import BlockAllocator, OutOfBlocks
from repro_torch.serving.kvpool.prefix import RadixPrefixCache

__all__ = ["BlockAllocator", "OutOfBlocks", "RadixPrefixCache"]
