"""Slice types and partition catalog — the MIG analogue; the port's copy of
the reference package's ``core/slices.py``.

A serving unit is a 16-chip block; slice types are power-of-two sub-meshes
1c/2c/4c/8c/16c (the tensor-parallel degree of the hosted instance), and a
partition configuration is a multiset of slice sizes summing to 16.
Because every size divides the block, any such multiset tiles the block
exactly, so the catalog is complete.

These are the REFERENCE's constants (its 16-chip block, 16 GB a chip and
its per-chip power and rate figures), kept unchanged so that the port's
optimizer, simulator and fleet visit the same configuration graphs and
price them with the same numbers as the reference's.  They describe the
reference's partitioning model, not the card the port runs on; the card's
own partition catalog and power model are later work (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

BLOCK_CHIPS = 16
SLICE_SIZES = (1, 2, 4, 8, 16)
HBM_PER_CHIP_GB = 16.0

# the reference's per-chip power and rate model (see the module docstring)
CHIP_POWER_PEAK_W = 220.0
CHIP_POWER_IDLE_W = 75.0
PEAK_FLOPS_BF16 = 197e12          # per chip
HBM_BW = 819e9                    # B/s per chip
ICI_BW = 50e9                     # B/s per link


def slice_name(chips: int) -> str:
    return f"{chips}c"


@functools.lru_cache(maxsize=None)
def partition_catalog(block: int = BLOCK_CHIPS) -> Tuple[Tuple[int, ...], ...]:
    """All multisets of SLICE_SIZES summing to ``block`` (descending order).
    For block=16 this yields 36 configurations — the MIG-19 analogue."""
    sizes = [s for s in SLICE_SIZES if s <= block]

    def rec(remaining: int, max_size: int) -> List[Tuple[int, ...]]:
        if remaining == 0:
            return [()]
        out = []
        for s in (x for x in sizes if x <= min(remaining, max_size)):
            for tail in rec(remaining - s, s):
                out.append((s,) + tail)
        return out

    # descending-first enumeration gives canonical (sorted desc) multisets
    return tuple(sorted({tuple(sorted(p, reverse=True)) for p in rec(block, block)},
                        reverse=True))


def config_number(partition: Sequence[int]) -> int:
    """Stable catalog index of a partition (the paper's 'configuration 1..19')."""
    return partition_catalog().index(tuple(sorted(partition, reverse=True)))


def slice_counts(partition: Sequence[int]) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for s in partition:
        out[s] = out.get(s, 0) + 1
    return out


def fits(mem_gb: float, chips: int, headroom: float = 0.9) -> bool:
    """HBM feasibility of hosting a variant on a slice (the paper's OOM-edge
    removal, §4.2)."""
    return mem_gb <= chips * HBM_PER_CHIP_GB * headroom


def power_w(chips: int, utilization: float) -> float:
    """Slice power draw at a given utilization (linear idle→peak model)."""
    u = min(max(utilization, 0.0), 1.0)
    return chips * (CHIP_POWER_IDLE_W + (CHIP_POWER_PEAK_W - CHIP_POWER_IDLE_W) * u)
