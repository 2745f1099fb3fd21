"""Architecture registry.

``repro_torch.configs.<id>`` modules call ``register`` at import time;
``get_config`` lazily imports the configs package so callers never need
to import every config module manually.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Set

from repro_torch.config.types import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}
# Archs the port runs that the reference registry does not hold.
_PORT_ONLY: Set[str] = set()


def register(cfg: ModelConfig, port_only: bool = False) -> ModelConfig:
    if cfg.arch_id in _REGISTRY and _REGISTRY[cfg.arch_id] != cfg:
        raise ValueError(f"conflicting registration for {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    if port_only:
        _PORT_ONLY.add(cfg.arch_id)
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
    own CNN testbed, nor the port-only archs)."""
    _ensure_loaded()
    return sorted(a for a in _REGISTRY
                  if _REGISTRY[a].family != "cnn" and a not in _PORT_ONLY)
