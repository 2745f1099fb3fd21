"""Parameters across packages: a reference parameter tree, fetched to the
host as numpy arrays, becomes the port's tree of tensors (same keys, same
layouts: OIHW conv weights, ``(fin, fout)`` FC weights), so both packages
compute the same function from the same weights."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """Nested dict of array-likes -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return walk(tree)


def params_to(tree: Dict[str, Any], device: DeviceLike) -> Dict[str, Any]:
    """The same parameter tree on another device."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.to(dev)

    return walk(tree)
