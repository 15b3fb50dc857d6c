"""Clover configuration graph (paper Definition 1) — the port's copy of the
reference package's ``core/config_graph.py``, trimmed to what the engine
reads: construction from edge weights and the edge list.

A configuration graph is a weighted directed bipartite graph: variant
vertices → slice-type vertices, integer edge weight = number of instances
of that variant hosted on that slice type.  All (x^p, x^v) placements with
identical edge weights collapse to one graph (canonical sorted edges).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

Edge = Tuple[str, int]                 # (variant name, slice chips)


@dataclasses.dataclass(frozen=True)
class ConfigGraph:
    family: str
    edges: Tuple[Tuple[Edge, int], ...]      # sorted ((variant, chips), weight)

    @staticmethod
    def from_dict(family: str, weights: Dict[Edge, int]) -> "ConfigGraph":
        items = tuple(sorted((e, int(w)) for e, w in weights.items() if w > 0))
        return ConfigGraph(family, items)

    def weights(self) -> Dict[Edge, int]:
        return dict(self.edges)

    @property
    def n_instances(self) -> int:
        return sum(w for _, w in self.edges)

    @property
    def total_chips(self) -> int:
        return sum(e[1] * w for e, w in self.edges)
