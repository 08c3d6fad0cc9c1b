"""Architecture config registry of the port.

``get_config(name)`` returns the full-size published config;
``get_config(name).reduced()`` the CPU smoke variant. The port serves
the dense all-global-attention model the benchmarks use; the other
architectures of the JAX registry arrive with later slices.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import KappaConfig, ModelConfig

# arch id -> module name
_REGISTRY: Dict[str, str] = {
    "deepseek-r1-distill-qwen-1.5b": "deepseek_r1_distill_qwen_15b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.config()


__all__ = ["ModelConfig", "KappaConfig", "get_config"]
