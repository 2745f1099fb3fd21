"""Public model API of the port: ``build_model(cfg)`` returns a
:class:`Model` with the reference's decoupling surface (``forward``,
``decoupling_points``, ``run_head``, ``run_heads``, ``run_segment``,
``run_tail``, ``per_point_fmacs``, ``boundary_bytes``) for the paper's CNN
testbed.

Parameters are nested dicts of tensors keyed like the reference's trees.
Batches are dicts whose ``"images"`` entry is a (B, 3, H, W) float tensor
(numpy arrays are moved to the parameters' device by :func:`batch_to`).
Other model families are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.types import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn as cnn_lib
from repro_torch.models.init import materialize


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch dict with every array as a tensor on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


@dataclass
class Model:
    cfg: ModelConfig
    specs: Any                                     # ParamSpec tree

    def __post_init__(self):
        self.layers = cnn_lib.build_layers(self.cfg)

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict:
        """Random parameters from ``seed`` on ``device`` (default: cuda)."""
        return materialize(self.specs, seed, resolve_device(device))

    def param_count(self) -> int:
        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            return int(np.prod(tree.shape))

        return count(self.specs)

    # ------------------------------------------------------------ entries
    def forward(self, params, batch) -> torch.Tensor:
        return cnn_lib.cnn_forward(self.layers, params, batch["images"])

    def decoupling_points(self) -> List[str]:
        return [lyr.name for lyr in self.layers]

    def run_head(self, params, batch, point: int) -> torch.Tensor:
        """Run layers [0, point] and return the boundary activation."""
        return cnn_lib.cnn_forward(self.layers, params, batch["images"],
                                   upto=point + 1)

    def run_heads(self, params, batch, points) -> List[Tuple[Any, Any]]:
        """Boundaries at several points from ONE tapped forward sweep, as
        ``(boundary, None)`` pairs in ``points`` order."""
        pts = list(points)
        if not pts:
            return []
        want = set(pts)
        taps: Dict[int, torch.Tensor] = {}
        x = batch["images"]
        for i, lyr in enumerate(self.layers[: max(want) + 1]):
            x = lyr.apply(params[lyr.name], x)
            if i in want:
                taps[i] = x
        return [(taps[p], None) for p in pts]

    def run_tail(self, params, boundary, point: int,
                 extras: Optional[Any] = None) -> torch.Tensor:
        return cnn_lib.cnn_forward(self.layers, params, boundary,
                                   start=point + 1)

    def run_segment(self, params, boundary, from_point: int, to_point: int,
                    extras: Optional[Any] = None) -> torch.Tensor:
        """The middle tier of a three-way split: layers ``(from_point,
        to_point]`` on the boundary of ``run_head(..., from_point)``, so
        ``run_tail(run_segment(run_head(x, i1), i1, i2), i2)`` is the full
        forward. ``from_point == to_point`` (a relay) returns ``boundary``
        itself."""
        if to_point < from_point:
            raise ValueError(f"segment requires from_point <= to_point, got "
                             f"({from_point}, {to_point})")
        if to_point == from_point:
            return boundary
        return cnn_lib.cnn_forward(self.layers, params, boundary,
                                   start=from_point + 1, upto=to_point + 1)

    # --------------------------------------------------- latency model IO
    def per_point_fmacs(self, batch: int, seq_len: int = 0) -> List[float]:
        """FMACs of each decoupling segment (layer i's own compute)."""
        return [f * batch for f in cnn_lib.layer_fmacs(self.layers)]

    def boundary_bytes(self, batch: int, seq_len: int = 0,
                       bytes_per_val: int = 4) -> List[int]:
        """Raw boundary feature size after each decoupling point."""
        return cnn_lib.feature_bytes(self.layers, batch, bytes_per_val)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"repro_torch: model family {cfg.family!r} is not yet ported; "
            "only the CNN testbed (vgg16/19, resnet50/101) is")
    return Model(cfg=cfg, specs=cnn_lib.cnn_param_specs(cfg))
