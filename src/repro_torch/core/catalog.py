"""Model-variant catalogs (paper Table 1 + the LM architectures) — the
port's copy of the reference package's ``core/catalog.py``.

Paper applications carry *published* accuracy / FLOPs / parameter numbers
(EfficientNet: Tan & Le 2019; ALBERT: Lan et al. 2019, SQuAD2.0 dev F1;
YOLOv5: Ultralytics release tables, COCO mAP50-95).  The LM archs get
AutoML-style quality ladders: depth-reduced ModelConfigs whose FLOPs and
parameter counts are *computed exactly* from the config, with a documented
log-parameter quality proxy standing in for task accuracy.  The port's
ladders resolve architectures through its own config registry, so they
exist for the architectures the port has (``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

from repro_torch.core import slices as SL


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


def _v(family, name, q, acc, gf, pm):
    mem = pm * 1e6 * 2 / 2**30 * 1.4 + 0.5      # bf16 weights + 40% act + runtime
    return Variant(family, name, q, acc, gf, pm, mem)


# --- paper Table 1 families ---------------------------------------------------
EFFICIENTNET = (
    _v("efficientnet", "B1", 1, 0.791, 0.70, 7.8),
    _v("efficientnet", "B3", 2, 0.816, 1.8, 12.0),
    _v("efficientnet", "B5", 3, 0.836, 9.9, 30.0),
    _v("efficientnet", "B7", 4, 0.843, 37.0, 66.0),
)

ALBERT = (                     # SQuAD2.0 F1/100, seq 384
    _v("albert", "v2-base", 1, 0.800, 9.2, 12.0),
    _v("albert", "v2-large", 2, 0.823, 27.0, 18.0),
    _v("albert", "v2-xlarge", 3, 0.861, 88.0, 60.0),
    _v("albert", "v2-xxlarge", 4, 0.898, 340.0, 235.0),
)

YOLOV5 = (                     # COCO mAP50-95/100
    _v("yolov5", "l", 1, 0.490, 109.0, 46.5),
    _v("yolov5", "x", 2, 0.507, 205.0, 86.7),
    _v("yolov5", "x6", 3, 0.550, 839.0, 140.7),
)

PAPER_FAMILIES: Dict[str, Sequence[Variant]] = {
    "efficientnet": EFFICIENTNET,
    "albert": ALBERT,
    "yolov5": YOLOV5,
}


# --- LM architecture ladders ---------------------------------------------------
def lm_ladder(arch: str, seq_len: int = 1024, gen_tokens: int = 128) -> List[Variant]:
    """AutoML-style quality ladder for an assigned architecture: the full
    config plus depth-reduced variants (1, 3/4, 1/2, 1/4 of the layers).

    FLOPs/request = forward flops for a (seq_len prefill + gen_tokens decode)
    request, computed exactly from the reduced ModelConfig.  Accuracy proxy:
    quality(N) = 1 - 0.35 · (N_active/N_full)^(-0.12) + 0.35, a log-parameter
    scaling-law surrogate normalized to 0.92 at full size (documented —
    real deployments substitute measured task accuracy here).
    """
    from repro_torch.configs import get_config
    full = get_config(arch)
    fracs = [(1.0, "full"), (0.75, "3q"), (0.5, "half"), (0.25, "quarter")]
    out: List[Variant] = []
    n_full_active = full.active_param_count()
    for i, (frac, tag) in enumerate(fracs):
        n_layers = max(int(round(full.n_layers * frac)), 1)
        if full.family == "hybrid" and full.attn_every:
            n_layers = max(full.attn_every,
                           (n_layers // full.attn_every) * full.attn_every)
        cfg = full.with_(n_layers=n_layers, name=f"{arch}-{tag}")
        n_act = cfg.active_param_count()
        fl_req = (cfg.flops_per_token(seq_len) * seq_len
                  + cfg.flops_per_token(seq_len, decode=True) * gen_tokens)
        acc = 0.92 - 0.35 * ((n_act / n_full_active) ** (-0.12) - 1.0)
        mem = cfg.param_count() * 2 / 2**30 * 1.2 + 1.0
        out.append(Variant(arch, tag, len(fracs) - i, acc, fl_req / 1e9,
                           cfg.param_count() / 1e6, mem))
    out.sort(key=lambda v: v.quality)
    return out


def _rank(v: Variant) -> tuple:
    """Total order on a ladder: quality ordinal, then accuracy, then name.
    The name tie-break makes best/worst deterministic for equal-quality
    variants regardless of the input ordering (``max`` alone would return
    whichever duplicate happened to come first)."""
    return (v.quality, v.accuracy, v.name)


def best_variant(variants: Sequence[Variant]) -> Variant:
    """Highest-quality variant of a ladder (deterministic tie-break)."""
    return max(variants, key=_rank)


def worst_variant(variants: Sequence[Variant]) -> Variant:
    """Lowest-quality variant of a ladder (deterministic tie-break)."""
    return min(variants, key=_rank)


def get_family(name: str) -> Sequence[Variant]:
    if name in PAPER_FAMILIES:
        return PAPER_FAMILIES[name]
    return tuple(lm_ladder(name))


def feasible_slices(v: Variant) -> List[int]:
    """Slice sizes that can host this variant (the OOM-edge filter)."""
    return [s for s in SL.SLICE_SIZES if SL.fits(v.mem_gb, s)]
