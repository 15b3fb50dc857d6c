"""Clover configuration graph (paper Definition 1) + graph edit distance —
the port's copy of the reference package's ``core/config_graph.py``.

A configuration graph is a weighted directed bipartite graph: variant vertices
→ slice-type vertices, integer edge weight = number of instances of that
variant hosted on that slice type.  Properties the paper exploits — and that
our tests assert:

  * canonicalization: all (x^p, x^v) placements with identical edge weights
    collapse to one graph (slice-type isolation ⇒ identical objective);
  * GED(g1, g2) = Σ |w1(e) − w2(e)|  (variant swap = 2, slice move = 2);
  * additivity: adding/removing serving blocks = edge-weight add/subtract
    (the elastic-scaling path);
  * feasibility: Σ instances·chips = blocks·16, every edge HBM-feasible.

Implemented over plain dicts with a networkx export for interop (the paper
implements the optimizer with networkx; our hot path avoids it).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import slices as SL
from repro_torch.core.catalog import Variant, best_variant, feasible_slices

Edge = Tuple[str, int]                 # (variant name, slice chips)


@dataclasses.dataclass(frozen=True)
class ConfigGraph:
    family: str
    edges: Tuple[Tuple[Edge, int], ...]      # sorted ((variant, chips), weight)

    # --- constructors --------------------------------------------------------
    @staticmethod
    def from_dict(family: str, weights: Dict[Edge, int]) -> "ConfigGraph":
        items = tuple(sorted((e, int(w)) for e, w in weights.items() if w > 0))
        return ConfigGraph(family, items)

    @staticmethod
    def uniform(family: str, variant: str, chips_per_slice: int,
                n_blocks: int) -> "ConfigGraph":
        per_block = SL.BLOCK_CHIPS // chips_per_slice
        return ConfigGraph.from_dict(
            family, {(variant, chips_per_slice): per_block * n_blocks})

    # --- views ----------------------------------------------------------------
    def weights(self) -> Dict[Edge, int]:
        return dict(self.edges)

    @property
    def n_instances(self) -> int:
        return sum(w for _, w in self.edges)

    @property
    def total_chips(self) -> int:
        return sum(e[1] * w for e, w in self.edges)

    def instances(self) -> List[Edge]:
        out: List[Edge] = []
        for e, w in self.edges:
            out.extend([e] * w)
        return out

    # --- algebra (paper §4.2: additivity) ----------------------------------------
    def add(self, other: "ConfigGraph") -> "ConfigGraph":
        w = self.weights()
        for e, dw in other.edges:
            w[e] = w.get(e, 0) + dw
        return ConfigGraph.from_dict(self.family, w)

    def subtract(self, other: "ConfigGraph") -> "ConfigGraph":
        w = self.weights()
        for e, dw in other.edges:
            w[e] = w.get(e, 0) - dw
            if w[e] < 0:
                raise ValueError(f"negative weight on {e}")
        return ConfigGraph.from_dict(self.family, w)

    # --- validity ------------------------------------------------------------------
    def is_valid(self, n_blocks: int, variants: Sequence[Variant]) -> bool:
        if self.total_chips != n_blocks * SL.BLOCK_CHIPS:
            return False
        by_name = {v.name: v for v in variants}
        for (vname, chips), w in self.edges:
            v = by_name.get(vname)
            if v is None or chips not in SL.SLICE_SIZES:
                return False
            if not SL.fits(v.mem_gb, chips):
                return False                      # OOM edge (paper §4.2)
        return True

    def to_networkx(self):
        import networkx as nx
        g = nx.DiGraph()
        for (vname, chips), w in self.edges:
            g.add_edge(f"variant:{vname}", f"slice:{SL.slice_name(chips)}", weight=w)
        return g


def ged(a: ConfigGraph, b: ConfigGraph) -> int:
    """Weighted graph edit distance: Σ |w_a(e) − w_b(e)| (paper Fig. 7 step 2:
    vertex sets are fixed, only edge weights differ)."""
    wa, wb = a.weights(), b.weights()
    keys = set(wa) | set(wb)
    return sum(abs(wa.get(k, 0) - wb.get(k, 0)) for k in keys)


# =============================================================================
# neighborhood (GED ≤ 4 — the paper's threshold)
# =============================================================================
def _repaint_moves(g: ConfigGraph, variants: Sequence[Variant]) -> List[ConfigGraph]:
    """Swap one instance's variant (GED 2)."""
    out = []
    w = g.weights()
    for (vname, chips), count in g.edges:
        for v2 in variants:
            if v2.name == vname or not SL.fits(v2.mem_gb, chips):
                continue
            w2 = dict(w)
            w2[(vname, chips)] -= 1
            w2[(v2.name, chips)] = w2.get((v2.name, chips), 0) + 1
            out.append(ConfigGraph.from_dict(g.family, w2))
    return out


def _split_moves(g: ConfigGraph, variants: Sequence[Variant]) -> List[ConfigGraph]:
    """Split one slice 2k → k + k, keeping the variant (GED 3) or repainting
    one half (GED ≤ 4)."""
    out = []
    w = g.weights()
    by_name = {v.name: v for v in variants}
    for (vname, chips), count in g.edges:
        if chips == 1:
            continue
        k = chips // 2
        if not SL.fits(by_name[vname].mem_gb, k):
            continue
        w2 = dict(w)
        w2[(vname, chips)] -= 1
        w2[(vname, k)] = w2.get((vname, k), 0) + 2
        out.append(ConfigGraph.from_dict(g.family, w2))
    return out


def _merge_moves(g: ConfigGraph, variants: Sequence[Variant]) -> List[ConfigGraph]:
    """Merge two k-slices into one 2k-slice (GED 3)."""
    out = []
    w = g.weights()
    sizes: Dict[int, int] = {}
    for (vname, chips), count in g.edges:
        sizes[chips] = sizes.get(chips, 0) + count
    for (vname, chips), count in g.edges:
        if chips == SL.BLOCK_CHIPS:
            continue
        if sizes.get(chips, 0) < 2:
            continue
        # partner slice of same size: same or different variant
        for (v2name, c2), count2 in g.edges:
            if c2 != chips:
                continue
            if v2name == vname and count < 2:
                continue
            w2 = dict(w)
            w2[(vname, chips)] -= 1
            w2[(v2name, chips)] -= 1
            if min(w2[(vname, chips)], w2[(v2name, chips)]) < 0:
                continue
            w2[(vname, 2 * chips)] = w2.get((vname, 2 * chips), 0) + 1
            out.append(ConfigGraph.from_dict(g.family, w2))
    return out


def neighbors(g: ConfigGraph, variants: Sequence[Variant],
              max_ged: int = 4) -> List[ConfigGraph]:
    """All single-move neighbors (every move keeps total chips constant and
    has GED ≤ 4); deduplicated."""
    cands = (_repaint_moves(g, variants) + _split_moves(g, variants)
             + _merge_moves(g, variants))
    seen, out = set(), []
    for c in cands:
        if c.edges in seen or c.edges == g.edges:
            continue
        if ged(g, c) > max_ged:
            continue
        seen.add(c.edges)
        out.append(c)
    return out


def sample_neighbor(g: ConfigGraph, variants: Sequence[Variant],
                    rng: random.Random, max_ged: int = 4) -> ConfigGraph:
    ns = neighbors(g, variants, max_ged)
    if not ns:
        return g
    return rng.choice(ns)


def random_config(family: str, variants: Sequence[Variant], n_blocks: int,
                  rng: random.Random) -> ConfigGraph:
    """Uniformly random valid configuration (used by BLOVER's random search:
    random partition per block, random feasible variant per slice)."""
    weights: Dict[Edge, int] = {}
    for _ in range(n_blocks):
        part = rng.choice(SL.partition_catalog())
        for chips in part:
            feas = [v for v in variants if SL.fits(v.mem_gb, chips)]
            if not feas:       # no variant fits a 1c slice → upgrade to 2c pairs
                continue
            v = rng.choice(feas)
            e = (v.name, chips)
            weights[e] = weights.get(e, 0) + 1
    g = ConfigGraph.from_dict(family, weights)
    # repair chip count if some slices were dropped for infeasibility
    deficit = n_blocks * SL.BLOCK_CHIPS - g.total_chips
    if deficit > 0:
        big = best_variant(variants)
        size = max(s for s in SL.SLICE_SIZES
                   if s <= deficit and SL.fits(big.mem_gb, s))
        w = g.weights()
        while deficit >= size:
            w[(big.name, size)] = w.get((big.name, size), 0) + 1
            deficit -= size
        g = ConfigGraph.from_dict(family, w)
    return g
