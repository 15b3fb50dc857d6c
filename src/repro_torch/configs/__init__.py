"""Architecture config registry — ``--arch <id>`` resolution for every
architecture of the reference: the dense family ``qwen3-1.7b``,
``qwen2-0.5b``, ``glm4-9b`` and ``gemma3-27b`` and the MoE family
``qwen3-moe-30b-a3b`` and ``qwen2-moe-a2.7b`` (served by the engines and
the generic entry points); ``mamba2-2.7b`` (SSM), ``zamba2-2.7b``
(hybrid), ``qwen2-vl-7b`` (VLM, M-RoPE) and ``seamless-m4t-large-v2``
(enc-dec), which run through the generic entry points only, as in the
reference.  Each has ``FULL`` and ``SMOKE`` (for the CPU tests);
:func:`get_optimized_config` applies the reference's measured per-arch
overrides (:data:`OPTIMIZED_OVERRIDES`), which the dry run reads
(``launch/dryrun.py --optimized``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-0.5b": "qwen2_0_5b",
    "glm4-9b": "glm4_9b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCHS: List[str] = list(_MODULES)

def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


# The reference's optimized per-arch variants, kept as they are:
#   * remat_policy="collectives" checkpoints a decoder layer's attention and
#     MLP halves apart, keeping their outputs (models/layers.py remat);
#   * decode_window: the append-buffer decode (a read-only prefix and a
#     suffix ring of that many positions, models/layers.py
#     attention_decode_split_apply).
OPTIMIZED_OVERRIDES: Dict[str, dict] = {
    "qwen3-moe-30b-a3b": dict(remat_policy="collectives", decode_window=256),
    "qwen2-moe-a2.7b": dict(remat_policy="collectives"),
    "qwen3-1.7b": dict(remat_policy="collectives"),
    "qwen2-0.5b": dict(remat_policy="collectives"),
    "seamless-m4t-large-v2": dict(remat_policy="collectives"),
    "zamba2-2.7b": dict(remat_policy="collectives"),
    "mamba2-2.7b": dict(remat_policy="collectives"),
    "glm4-9b": dict(decode_window=256),
    "gemma3-27b": dict(decode_window=256),
    "qwen2-vl-7b": dict(decode_window=256),
}


def get_optimized_config(name: str) -> ModelConfig:
    return get_config(name).with_(**OPTIMIZED_OVERRIDES.get(name, {}))
