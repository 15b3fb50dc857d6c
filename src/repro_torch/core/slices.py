"""Slice sizes and their memory feasibility — the port's copy of the
reference package's ``core/slices.py``, trimmed to what the configuration
graph's neighbourhood reads.

These are the REFERENCE's constants (a 16-chip serving block cut into
power-of-two slices, 16 GB of memory per chip), kept unchanged so that the
port's annealing visits the same configuration graphs as the reference's.
They describe the reference's partitioning model, not the card the port
runs on; the card's own partition catalog is later work (ROADMAP A8).
"""
from __future__ import annotations

BLOCK_CHIPS = 16
SLICE_SIZES = (1, 2, 4, 8, 16)
HBM_PER_CHIP_GB = 16.0


def fits(mem_gb: float, chips: int, headroom: float = 0.9) -> bool:
    """Memory feasibility of hosting a variant on a slice (the paper's
    OOM-edge removal, §4.2)."""
    return mem_gb <= chips * HBM_PER_CHIP_GB * headroom
