"""Parameters across packages: a reference parameter tree, fetched to the
host as numpy arrays, becomes the port's tree of tensors (same keys, same
layouts: OIHW conv weights, ``(fin, fout)`` FC weights; for a decoder the
``segments`` list of per-segment trees stacked along a leading layer
axis), so both packages compute the same function from the same
weights. A bfloat16 leaf arrives as numpy's ``ml_dtypes`` bfloat16 and is
carried over by its bits."""
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
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    return walk(tree)


def params_to(tree: Dict[str, Any], device: DeviceLike) -> Dict[str, Any]:
    """The same parameter tree on another device."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node.to(dev)

    return walk(tree)
