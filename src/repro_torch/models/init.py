"""Parameter specification and materialization.

A model defines its parameters once, as a nested dict of
:class:`ParamSpec` (shape + dtype + logical axis names + initializer), the
same trees as the reference's. :func:`materialize` samples them with an
explicit ``torch.Generator``: truncated normal in [-2, 2], scaled by
``scale / sqrt(fan_in)`` with the reference's fan-in rule. The numbers
differ from the reference's (JAX's PRNG is not reproducible in PyTorch);
``repro_torch.models.bridge`` copies a reference parameter tree instead.

Two draws: the default samples every leaf whole on the CPU, so the values
depend on the seed alone; ``draw="device"`` samples on the target device,
a bounded chunk at a time, for models whose float32 leaves would not fit
in host memory (the values then come from that device's generator).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# Elements the device draw samples at a time: 2^26 float32, 256 MiB.
DEVICE_CHUNK = 1 << 26


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


def _map_specs(fn, specs):
    """``fn`` over every ParamSpec of a nested dict / list, in order."""
    if is_spec(specs):
        return fn(specs)
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def abstractify(specs):
    """Tensors on the ``meta`` device for a ParamSpec tree: shapes and
    dtypes, no allocation."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=torch_dtype(
        s.dtype), device="meta"), specs)


def logical_axes(specs):
    """Tree of logical-axis tuples, same structure as the params."""
    return _map_specs(lambda s: s.logical, specs)


def _fan_in(s: ParamSpec) -> int:
    # Last-but-one dims are the fan-in for 2D+ weights (the reference's rule).
    if len(s.shape) >= 2:
        return int(np.prod(s.shape[:-1]))
    return 1


def materialize_leaf(gen: torch.Generator, s: ParamSpec, device,
                     chunk: int) -> torch.Tensor:
    """Sample one leaf on ``device`` with ``gen`` (a generator of that
    device): the leaf is allocated in its own dtype, then filled ``chunk``
    elements at a time in flat order, each chunk drawn in float32, scaled
    and cast into place, so at most one float32 chunk exists at a time."""
    dtype = torch_dtype(s.dtype)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    # "embed": normal times the scale; "normal" / "conv": truncated normal,
    # fan-in scaled.
    std = s.scale if s.init == "embed" else (
        s.scale / np.sqrt(max(_fan_in(s), 1)))
    out = torch.empty(s.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), max(chunk, 1)):
        part = torch.empty(min(chunk, flat.numel() - lo),
                           dtype=torch.float32, device=device)
        if s.init == "embed":
            part.normal_(generator=gen)
        else:
            torch.nn.init.trunc_normal_(part, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
        flat[lo:lo + part.numel()].copy_(part.mul_(std))
        del part                # before the next chunk is allocated
    return out


def materialize(specs, seed: int, device, draw: str = "cpu") -> dict:
    """Sample a nested dict (or list) of ParamSpecs from ``seed`` onto
    ``device``. ``draw="cpu"`` (the default) samples each leaf whole on
    the CPU with one CPU generator, then moves it, so the values do not
    depend on the device. ``draw="device"`` samples on ``device`` with a
    generator of that device seeded from ``seed``, :data:`DEVICE_CHUNK`
    elements at a time: host memory and host time stay flat whatever the
    model's size. Its values are the device generator's: the same for a
    seed on one kind of device, not the CPU draw's."""
    if draw not in ("cpu", "device"):
        raise ValueError(f"draw must be 'cpu' or 'device', not {draw!r}")
    device = torch.device(device)
    on = device if draw == "device" else torch.device("cpu")
    gen = torch.Generator(device=on)
    gen.manual_seed(int(seed))

    def leaf(s: ParamSpec) -> torch.Tensor:
        chunk = DEVICE_CHUNK if draw == "device" else int(np.prod(s.shape))
        return materialize_leaf(gen, s, on, chunk).to(device)

    return _map_specs(leaf, specs)
