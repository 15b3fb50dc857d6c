"""Model-variant records — the port's copy of the reference package's
``core/catalog.py``, trimmed to the :class:`Variant` record the engine's
quality ladder is made of.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Variant:
    family: str
    name: str
    quality: int               # ordinal within family, 1 = lowest (paper §4.1)
    accuracy: float            # task metric in [0, 1]
    flops_g: float             # GFLOPs per inference request
    params_m: float            # parameters (millions)
    mem_gb: float              # serving footprint (weights + working set)

    @property
    def key(self) -> str:
        return f"{self.family}:{self.name}"

