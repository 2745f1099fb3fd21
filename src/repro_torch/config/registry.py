"""Architecture registry.

``repro_torch.configs.<id>`` modules call ``register`` at import time;
``get_config`` lazily imports the configs package so callers never need
to import every config module manually.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config.types import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.arch_id in _REGISTRY and _REGISTRY[cfg.arch_id] != cfg:
        raise ValueError(f"conflicting registration for {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def assigned_archs() -> List[str]:
    """The 10 architectures assigned from the public pool (not the paper's
    own CNN testbed)."""
    _ensure_loaded()
    return sorted(a for a in _REGISTRY if _REGISTRY[a].family != "cnn")
