"""Weights drawn on the device from the run's seed.

The plain reference's ``layout`` names every leaf with its shape and
fan-in; one generator on the device fills one flat buffer of the served
dtype in a single call, and each leaf is a view of it, scaled to
``gain / sqrt(fan_in)`` (the embedding to its own standard deviation).
Biases are zero. Program and reference read the same tensors."""
from __future__ import annotations

import math
from typing import Any, List, Tuple

import torch

Path = Tuple[Any, ...]


def _leaves(tree, path: Path = ()) -> List[Tuple[Path, tuple, Any]]:
    if isinstance(tree, tuple):
        return [(path, tree[0], tree[1])]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]


def _skeleton(tree):
    if isinstance(tree, tuple):
        return None
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return {k: _skeleton(v) for k, v in tree.items()}


def _put(tree, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def draw(layout, seed: int, device, dtype: torch.dtype, gain: float = 1.0,
         embed_std: float = 0.02):
    """The parameter tree of ``layout`` drawn from ``seed`` on ``device``."""
    leaves = _leaves(layout)
    drawn = [(p, s, f) for p, s, f in leaves if f is not None]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    tree = _skeleton(layout)
    off = 0
    for path, shape, fan in drawn:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape)
        leaf.mul_(embed_std if fan == "embed" else gain / math.sqrt(fan))
        _put(tree, path, leaf)
        off += n
    for path, shape, fan in leaves:
        if fan is None:
            _put(tree, path, torch.zeros(shape, dtype=dtype, device=device))
    return tree


def same_layout(a, b) -> bool:
    """Whether two parameter trees (tensors or meta tensors) have the same
    keys, shapes and dtypes."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype)
    if isinstance(a, list) or isinstance(b, list):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)
                and all(same_layout(x, y) for x, y in zip(a, b)))
    return (isinstance(a, dict) and isinstance(b, dict)
            and a.keys() == b.keys()
            and all(same_layout(a[k], b[k]) for k in a))
