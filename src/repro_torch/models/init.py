"""Parameter specification and materialization.

A model defines its parameters once, as a nested dict of
:class:`ParamSpec` (shape + dtype + logical axis names + initializer), the
same trees as the reference's. :func:`materialize` samples them with an
explicit ``torch.Generator``: truncated normal in [-2, 2], scaled by
``scale / sqrt(fan_in)`` with the reference's fan-in rule. The numbers
differ from the reference's (JAX's PRNG is not reproducible in PyTorch);
``repro_torch.models.bridge`` copies a reference parameter tree instead.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # one logical axis name (or None) per dim
    dtype: str = "bfloat16"
    init: str = "normal"                 # normal | zeros | ones | embed | conv
    scale: float = 1.0                   # stddev multiplier for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} and logical {self.logical} rank mismatch"
            )


def spec(shape, logical, dtype="bfloat16", init="normal", scale=1.0
         ) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(logical), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def stack_specs(s: ParamSpec, n: int, axis_name: str = "layers") -> ParamSpec:
    """Prepend a layer dimension of size n (per-layer params, stacked)."""
    return dataclasses.replace(
        s, shape=(n,) + s.shape, logical=(axis_name,) + s.logical
    )


def stack_tree(specs, n: int, axis_name: str = "layers"):
    """:func:`stack_specs` over every leaf of a nested dict of specs."""
    if is_spec(specs):
        return stack_specs(specs, n, axis_name)
    return {k: stack_tree(v, n, axis_name) for k, v in specs.items()}


def _fan_in(s: ParamSpec) -> int:
    # Last-but-one dims are the fan-in for 2D+ weights (the reference's rule).
    if len(s.shape) >= 2:
        return int(np.prod(s.shape[:-1]))
    return 1


def materialize_leaf(gen: torch.Generator, s: ParamSpec) -> torch.Tensor:
    dtype = torch_dtype(s.dtype)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype)
    if s.init == "embed":
        out = torch.randn(s.shape, generator=gen, dtype=torch.float32)
        return (out * s.scale).to(dtype)
    # "normal" / "conv": truncated normal, fan-in scaled.
    out = torch.empty(s.shape, dtype=torch.float32)
    std = s.scale / np.sqrt(max(_fan_in(s), 1))
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (out * std).to(dtype)


def materialize(specs, seed: int, device) -> dict:
    """Sample a nested dict (or list) of ParamSpecs on the CPU from
    ``seed`` (so the values do not depend on the device), then move them
    to ``device``."""
    gen = torch.Generator().manual_seed(int(seed))

    def walk(tree):
        if isinstance(tree, ParamSpec):
            return materialize_leaf(gen, tree).to(device)
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return {k: walk(v) for k, v in tree.items()}

    return walk(specs)
