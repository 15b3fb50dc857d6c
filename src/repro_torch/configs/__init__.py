"""Architecture config registry — ``--arch <id>`` resolution for the
architectures the port runs: ``qwen3-1.7b`` (dense, served by the engines),
``mamba2-2.7b`` (SSM) and ``zamba2-2.7b`` (hybrid), each with ``FULL`` and
``SMOKE`` (for the CPU tests).  The reference's other architectures raise
``NotImplementedError`` until a later slice ports their families."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS: List[str] = list(_MODULES)

# the reference's architectures whose families the port does not serve yet
_NOT_PORTED = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "glm4-9b",
               "gemma3-27b", "qwen2-0.5b", "seamless-m4t-large-v2",
               "qwen2-vl-7b")


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; "
                                  f"available: {ARCHS}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
