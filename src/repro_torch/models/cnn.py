"""The paper's testbed models: VGG16/19 and ResNet50/101 in PyTorch.

Each model is an explicit sequence of :class:`CNNLayer`, the paper's
decoupling-point granularity (layer-wise for VGG, res-unit-wise for
ResNet, Sec. III-A), with the reference's layer names, parameter trees
(OIHW conv weights, ``(fin, fout)`` FC weights) and per-layer FMAC counts.

Layout is NCHW. Convolutions pad like the reference's ``"SAME"``: the pad
is split ``(total // 2, total - total // 2)``, so the 7x7 stride-2 stem
pads (2, 3) at even input sizes, which ``padding=3`` would not reproduce;
asymmetric pads go through an explicit ``F.pad``. Max pooling is 2x2/2
VALID, and the FC flatten is NCHW order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.types import ModelConfig
from repro_torch.models.init import spec


@dataclass
class CNNLayer:
    name: str
    specs: Dict                       # ParamSpec tree (possibly empty)
    apply: Callable                   # (params, x) -> y
    out_shape: Tuple[int, ...]        # (C, H, W) or (F,) after this layer
    fmacs: float                      # multiply-accumulates per sample


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, b, stride: int = 1
              ) -> torch.Tensor:
    """``"SAME"`` convolution, NCHW / OIHW."""
    k = w.shape[-1]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride=stride)


def _conv_layer(name, cin, cout, hw, k=3, stride=1, dtype="float32",
                relu=True):
    out_hw = hw // stride
    specs = {
        "w": spec((cout, cin, k, k), ("conv_out", "conv_in", None, None),
                  dtype, init="conv"),
        "b": spec((cout,), ("conv_out",), dtype, init="zeros"),
    }

    def apply(params, x):
        y = conv_same(x, params["w"], params["b"], stride)
        return F.relu(y) if relu else y

    fmacs = float(out_hw) ** 2 * cout * cin * k * k
    return CNNLayer(name, specs, apply, (cout, out_hw, out_hw), fmacs)


def _maxpool_layer(name, c, hw):
    def apply(params, x):
        return F.max_pool2d(x, 2, 2)

    return CNNLayer(name, {}, apply, (c, hw // 2, hw // 2), 0.0)


def _fc_layer(name, fin, fout, dtype="float32", relu=True):
    specs = {
        "w": spec((fin, fout), ("ffn", "embed"), dtype),
        "b": spec((fout,), ("embed",), dtype, init="zeros"),
    }

    def apply(params, x):
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        y = x @ params["w"] + params["b"]
        return F.relu(y) if relu else y

    return CNNLayer(name, specs, apply, (fout,), float(fin) * fout)


def _res_unit(name, cin, cmid, cout, hw, stride, dtype="float32"):
    """Bottleneck res-unit: 1x1 -> 3x3 -> 1x1 (+ projection shortcut). The
    stride sits on the 1x1 convs, which need no padding."""
    out_hw = hw // stride
    specs = {
        "w1": spec((cmid, cin, 1, 1), ("conv_out", "conv_in", None, None),
                   dtype, init="conv"),
        "w2": spec((cmid, cmid, 3, 3), ("conv_out", "conv_in", None, None),
                   dtype, init="conv"),
        "w3": spec((cout, cmid, 1, 1), ("conv_out", "conv_in", None, None),
                   dtype, init="conv"),
        "b1": spec((cmid,), ("conv_out",), dtype, init="zeros"),
        "b2": spec((cmid,), ("conv_out",), dtype, init="zeros"),
        "b3": spec((cout,), ("conv_out",), dtype, init="zeros"),
    }
    project = cin != cout or stride != 1
    if project:
        specs["wp"] = spec((cout, cin, 1, 1),
                           ("conv_out", "conv_in", None, None), dtype,
                           init="conv")

    def apply(params, x):
        h = F.relu(conv_same(x, params["w1"], params["b1"], stride))
        h = F.relu(conv_same(h, params["w2"], params["b2"]))
        h = conv_same(h, params["w3"], params["b3"])
        sc = conv_same(x, params["wp"], None, stride) if project else x
        return F.relu(h + sc)

    fmacs = (
        float(out_hw) ** 2 * cmid * cin
        + float(out_hw) ** 2 * cmid * cmid * 9
        + float(out_hw) ** 2 * cout * cmid
        + (float(out_hw) ** 2 * cout * cin if project else 0.0)
    )
    return CNNLayer(name, specs, apply, (cout, out_hw, out_hw), fmacs)


VGG_PLANS = {
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}

RESNET_PLANS = {
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
}


def build_layers(cfg: ModelConfig) -> List[CNNLayer]:
    """The layer list of a CNN config (decoupling points are the layer
    boundaries, per the paper)."""
    kind = cfg.cnn_spec
    hw = cfg.image_size
    dtype = cfg.param_dtype
    layers: List[CNNLayer] = []
    if kind in VGG_PLANS:
        cin = 3
        ci = 0
        for item in VGG_PLANS[kind]:
            if item == "M":
                layers.append(_maxpool_layer(f"pool{ci}", cin, hw))
                hw //= 2
            else:
                ci += 1
                layers.append(_conv_layer(f"conv{ci}", cin, item, hw,
                                          dtype=dtype))
                cin = item
        fin = cin * hw * hw
        fdim = 4096 if cfg.image_size >= 112 else 256
        layers.append(_fc_layer("fc1", fin, fdim, dtype))
        layers.append(_fc_layer("fc2", fdim, fdim, dtype))
        layers.append(_fc_layer("fc3", fdim, cfg.num_classes, dtype,
                                relu=False))
        return layers
    if kind in RESNET_PLANS:
        widths = [64, 128, 256, 512]
        layers.append(_conv_layer("stem", 3, 64, hw, k=7, stride=2,
                                  dtype=dtype))
        hw //= 2
        layers.append(_maxpool_layer("stem_pool", 64, hw))
        hw //= 2
        cin = 64
        for stage, blocks in enumerate(RESNET_PLANS[kind]):
            cmid = widths[stage]
            cout = cmid * 4
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                layers.append(
                    _res_unit(f"res{stage+1}_{b+1}", cin, cmid, cout, hw,
                              stride, dtype)
                )
                hw //= stride
                cin = cout

        def gap(params, x):
            return x.mean(dim=(2, 3))

        layers.append(CNNLayer("gap", {}, gap, (cin,), 0.0))
        layers.append(_fc_layer("fc", cin, cfg.num_classes, dtype,
                                relu=False))
        return layers
    raise ValueError(f"unknown cnn spec {kind!r}")


def cnn_param_specs(cfg: ModelConfig):
    return {lyr.name: lyr.specs for lyr in build_layers(cfg)}


def cnn_forward(layers: List[CNNLayer], params, x, upto: int = -1,
                start: int = 0):
    """Run layers [start, upto); upto=-1 means all."""
    end = len(layers) if upto < 0 else upto
    for lyr in layers[start:end]:
        x = lyr.apply(params[lyr.name], x)
    return x


def feature_bytes(layers: List[CNNLayer], batch: int = 1,
                  bytes_per_val: int = 4) -> List[int]:
    """Raw (uncompressed) boundary feature size after each layer (Fig. 2)."""
    return [
        batch * int(np.prod(lyr.out_shape)) * bytes_per_val for lyr in layers
    ]


def layer_fmacs(layers: List[CNNLayer]) -> List[float]:
    return [lyr.fmacs for lyr in layers]
