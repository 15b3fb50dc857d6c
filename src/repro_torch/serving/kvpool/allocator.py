"""Host-side block allocator for the paged KV arena.

The device arena is one preallocated ``(L, n_blocks, block_size, K, dh)``
tensor pair per instance (``models.registry.make_block_arena``); this module
owns the *map* of it: which blocks are free, who references each block, and
which physical blocks make up each sequence's logical token range (the block
table).  All state is plain Python — the allocator never touches the device.

Conventions:

  * block 0 is reserved as the **junk sink**: padded block-table entries and
    inactive batch rows point at it, so masked-out device writes always have
    a legal target.  It is never allocated and never freed.
  * blocks are reference counted.  A sequence holds one reference on every
    block in its table; the radix prefix tree holds one reference on every
    block it caches.  ``free`` is decref: the block returns to the free list
    only when the last reference drops.
  * ``copy_on_write`` gives a sequence a private copy of a shared block
    (refcount > 1): a fresh block is allocated, the caller copies the device
    contents, and the shared block loses one reference.  With block-aligned
    prefix sharing the engine never actually triggers it in steady state —
    shared blocks are always full and writes only land past the valid end —
    but the allocator supports it so forked/beam decoding can build on it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["OutOfBlocks", "BlockAllocator"]

JUNK_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAllocator:
    """Free-list + refcount bookkeeping over ``n_blocks`` fixed-size blocks.

    Block ids are ints in ``[1, n_blocks)`` (block 0 is the junk sink).
    """

    def __init__(self, n_blocks: int, block_size: int):
        assert n_blocks >= 2, "need at least one allocatable block + junk"
        assert block_size >= 1
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list: recently freed blocks are re-used first (their
        # arena pages are warm in cache)
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        # bumped on EVERY refcount mutation (alloc/free/incref/COW): an O(1)
        # change fingerprint for the engine's admission gate — a failed
        # block-aware admission is only retried once this moves, instead of
        # re-walking the prefix tree's evictable set every tick
        self.version = 0

    # --- queries -------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocatable(self) -> int:
        """Total blocks the allocator manages (excludes the junk sink)."""
        return self.n_blocks - 1

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def blocks_in_use(self) -> int:
        return self.num_allocatable - self.num_free

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV entries."""
        return -(-max(n_tokens, 0) // self.block_size)

    # --- allocation ----------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks off the free list with refcount 1 each."""
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for bid in out:
            self._ref[bid] = 1
        self.version += 1
        return out

    def incref(self, bids: Sequence[int]) -> None:
        for bid in bids:
            if bid == JUNK_BLOCK:
                continue
            if self._ref.get(bid, 0) <= 0:
                raise ValueError(f"incref of unallocated block {bid}")
            self._ref[bid] += 1
        self.version += 1

    def free(self, bids: Sequence[int]) -> List[int]:
        """Drop one reference per block; returns the blocks actually
        reclaimed (refcount hit zero).  Freeing an unallocated block is a
        double-free and raises."""
        reclaimed: List[int] = []
        for bid in bids:
            if bid == JUNK_BLOCK:
                continue
            r = self._ref.get(bid, 0)
            if r <= 0:
                raise ValueError(f"double free of block {bid}")
            if r == 1:
                del self._ref[bid]
                self._free.append(bid)
                reclaimed.append(bid)
            else:
                self._ref[bid] = r - 1
        self.version += 1
        return reclaimed

    def copy_on_write(self, bid: int) -> int:
        """Private-copy protocol for writing into a possibly-shared block.

        refcount == 1: the caller already owns the block exclusively — the
        same id comes back and no device copy is needed.  refcount > 1: a
        fresh block is allocated (the caller must copy the arena contents
        ``bid`` → returned id) and ``bid`` loses the caller's reference."""
        if self._ref.get(bid, 0) <= 0:
            raise ValueError(f"copy_on_write of unallocated block {bid}")
        if self._ref[bid] == 1:
            return bid
        new = self.alloc(1)[0]
        self._ref[bid] -= 1
        self.version += 1
        return new

    # --- invariant check (tests / debugging) ---------------------------------
    def check(self) -> None:
        """Internal consistency: free list and refcounted set partition the
        allocatable id space, no block is both free and referenced."""
        free = set(self._free)
        held = set(self._ref)
        assert not (free & held), f"blocks both free and held: {free & held}"
        assert free | held == set(range(1, self.n_blocks)), \
            "leaked blocks: " + str(set(range(1, self.n_blocks)) - free - held)
        assert all(r > 0 for r in self._ref.values())
