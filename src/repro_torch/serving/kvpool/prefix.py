"""Radix-tree prefix cache over the paged KV arena (block granularity).

Requests in a serving window overwhelmingly share prompt prefixes — the
system prompt, few-shot preambles, the conversation so far.  With a paged
arena those shared tokens only need to be prefilled ONCE: this tree maps
token-chunk paths (one edge = exactly ``block_size`` tokens) to the arena
block holding that chunk's K/V.  An admitted request walks its prompt down
the tree, takes a reference on every matched block, and only prefills the
unmatched tail.

Sharing is block-aligned on purpose: only FULL blocks are ever shared, so a
shared block is immutable by construction (writes only land past a
sequence's valid end, which lies beyond every full shared block) and the
engine's copy-on-write hook stays a no-op in steady state.

Eviction is LRU over *evictable* nodes — leaves whose block carries no
reference but the tree's own.  Interior nodes become evictable once their
children go; a node whose block a live sequence still references is pinned,
and so are its ancestors (dropping an ancestor would orphan a reachable
child).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kvpool.allocator import BlockAllocator

__all__ = ["RadixPrefixCache"]

Chunk = Tuple[int, ...]


@dataclasses.dataclass
class _Node:
    chunk: Chunk                      # the block_size tokens this edge spells
    block: int                        # arena block holding their K/V
    parent: Optional["_Node"]
    children: Dict[Chunk, "_Node"] = dataclasses.field(default_factory=dict)
    last_used: int = 0


class RadixPrefixCache:
    """Block-granular prompt-prefix dedup over a :class:`BlockAllocator`.

    The tree holds one allocator reference per cached node; callers that
    match get their own references (released through the allocator when the
    sequence finishes, as with any other block in its table)."""

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self.block_size = allocator.block_size
        self._root: Dict[Chunk, _Node] = {}
        self._clock = 0
        self.hits = 0                  # blocks served from cache
        self.misses = 0                # admissions with zero matched blocks
        self.evictions = 0             # nodes evicted (blocks returned)

    # --- internals -----------------------------------------------------------
    def _chunks(self, tokens: Sequence[int], n: int) -> List[Chunk]:
        bs = self.block_size
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def _nodes(self) -> List[_Node]:
        out, stack = [], list(self._root.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def _walk(self, tokens: Sequence[int], n: int) -> List[_Node]:
        """Tree nodes along the longest cached path of the first ``n``
        block-chunks of ``tokens`` (pure read: no refs, no LRU bump)."""
        nodes: List[_Node] = []
        level = self._root
        for chunk in self._chunks(tokens, n):
            node = level.get(chunk)
            if node is None:
                break
            nodes.append(node)
            level = node.children
        return nodes

    # --- lookup --------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block-aligned prefix of ``tokens``.

        Returns ``(blocks, n_cached_tokens)`` with one caller-owned reference
        taken on every returned block.  Matching is capped one token short of
        the prompt so at least one token always remains to prefill — the
        first generated token must come from real last-position logits."""
        usable = max((len(tokens) - 1) // self.block_size, 0)
        self._clock += 1
        nodes = self._walk(tokens, usable)
        blocks: List[int] = []
        for node in nodes:
            node.last_used = self._clock
            blocks.append(node.block)
        if blocks:
            self.alloc.incref(blocks)
            self.hits += len(blocks)
        else:
            self.misses += 1
        return blocks, len(blocks) * self.block_size

    # --- block liveness (partial swap-in) ------------------------------------
    def live_prefix_blocks(self, tokens: Sequence[int],
                           limit: Optional[int] = None) -> int:
        """How many leading FULL block-chunks of ``tokens`` are tree-resident
        right now.  Pure liveness query — no references taken, no LRU bump —
        used at swap-out to record which of a victim's pages the tree still
        backs (the candidates for a partial swap-in)."""
        n = len(tokens) // self.block_size
        if limit is not None:
            n = min(n, limit)
        return len(self._walk(tokens, n))

    def match_full(self, tokens: Sequence[int],
                   max_blocks: Optional[int] = None) -> List[int]:
        """Re-acquire the tree-resident prefix of an already-prefilled
        prompt, over ALL its full blocks (no one-token-short cap — the
        caller already owns real last-position logits from its original
        prefill).  One caller-owned reference is taken per returned block;
        LRU recency is bumped.  This is the swap-in path: every block
        returned is a page whose K/V the engine does NOT have to copy back
        from the host image."""
        n = len(tokens) // self.block_size
        if max_blocks is not None:
            n = min(n, max_blocks)
        self._clock += 1
        nodes = self._walk(tokens, n)
        blocks: List[int] = []
        for node in nodes:
            node.last_used = self._clock
            blocks.append(node.block)
        if blocks:
            self.alloc.incref(blocks)
            self.hits += len(blocks)
        return blocks

    # --- registration --------------------------------------------------------
    def insert(self, tokens: Sequence[int], block_table: Sequence[int]) -> int:
        """Register a prefilled prompt's full blocks for future sharing.

        ``block_table[i]`` must hold the K/V of tokens ``[i·bs, (i+1)·bs)``.
        Chunks already present keep their existing node (the caller's copy
        stays private — dedup only helps *future* admissions); new nodes take
        a tree-owned reference on the caller's block.  Returns the number of
        nodes added."""
        full = min(len(tokens) // self.block_size, len(block_table))
        added = 0
        self._clock += 1
        level, parent = self._root, None
        for i, chunk in enumerate(self._chunks(tokens, full)):
            node = level.get(chunk)
            if node is None:
                node = _Node(chunk, int(block_table[i]), parent,
                             last_used=self._clock)
                self.alloc.incref([node.block])
                level[chunk] = node
                added += 1
            else:
                node.last_used = self._clock
            parent, level = node, node.children
        return added

    # --- eviction ------------------------------------------------------------
    def _evictable(self) -> List[_Node]:
        """Leaves whose block only the tree references, LRU first."""
        out = [n for n in self._nodes()
               if not n.children and self.alloc.refcount(n.block) == 1]
        out.sort(key=lambda n: n.last_used)
        return out

    def evictable_blocks(self) -> int:
        """Blocks reclaimable by (repeated leaves-first) eviction right now:
        a node is reclaimable iff its own block carries no external
        reference AND its entire subtree is reclaimable (children must be
        evicted before their parent).  A pinned node blocks its ancestors
        but NOT its reclaimable siblings or their subtrees."""
        def walk(n: _Node) -> Tuple[int, bool]:
            cnt, all_ok = 0, True
            for c in n.children.values():
                c_cnt, c_ok = walk(c)
                cnt += c_cnt
                all_ok = all_ok and c_ok
            if all_ok and self.alloc.refcount(n.block) == 1:
                return cnt + 1, True
            return cnt, False
        return sum(walk(n)[0] for n in self._root.values())

    def evict(self, n_blocks: int) -> int:
        """LRU-evict unreferenced nodes until ``n_blocks`` arena blocks are
        reclaimed (or nothing evictable remains).  Returns blocks freed."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable()
            if not leaves:
                break
            for node in leaves:
                if freed >= n_blocks:
                    break
                self._drop(node)
                freed += 1
        return freed

    def _drop(self, node: _Node) -> None:
        assert not node.children
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        del siblings[node.chunk]
        self.alloc.free([node.block])
        self.evictions += 1

    def clear(self) -> int:
        """Evict everything evictable (end-of-serve teardown)."""
        return self.evict(self.alloc.num_allocatable)

    def __len__(self) -> int:
        return len(self._nodes())
