"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the CUDA
card; asking for ``cuda`` on a machine without one raises instead of
quietly running on the CPU. ``device="cpu"`` is the opt-in the CPU tests
use. Resolving a device also turns TF32 off for convolutions and matrix
products, so the models run in full float32 on the card, as the
reference does, and keeps bfloat16 matrix products from reducing their
split-K partial sums in bfloat16.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but no CUDA card is "
            "available; pass device='cpu' (or --device cpu) to run on the "
            "CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def tensor_device(tree) -> Optional[torch.device]:
    """Device of the first tensor in a nested dict/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        d = tensor_device(v)
        if d is not None:
            return d
    return None
