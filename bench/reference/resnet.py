"""ResNet-50 (arXiv:1512.03385) as the served program lays it out: the
bottleneck res-units of the paper, with the two departures of the JAX
reference this repository reproduces (no batch normalisation, a bias on
every convolution) and TensorFlow's "SAME" padding. Plain float32
PyTorch; a JALAD cut is a layer index, and ``forward`` runs any range of
the layers, so a head, the wire and a tail compose in plain code."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench.counts.flops import cnn_flops_per_image
from bench.reference.lowp import rounder

Layer = Tuple[str, str, dict]          # (name, kind, geometry)


def layers(cfg: dict) -> List[Layer]:
    """The layer list (the decoupling points, in order) of ``cfg``:
    ``stem``, ``stem_pool``, the res-units ``res<stage>_<unit>``, ``gap``
    and ``fc``, each with its geometry."""
    hw = cfg["image_size"]
    c = cfg["stem_width"]
    out: List[Layer] = [("stem", "conv", dict(cin=3, cout=c, k=cfg["stem_kernel"],
                                              stride=2, hw=hw))]
    hw //= 2
    out.append(("stem_pool", "pool", dict(c=c, hw=hw)))
    hw //= 2
    cin = c
    for s, (units, width) in enumerate(zip(cfg["stages"], cfg["widths"])):
        cout = width * cfg["expansion"]
        for u in range(units):
            stride = 2 if (u == 0 and s > 0) else 1
            out.append((f"res{s + 1}_{u + 1}", "unit",
                        dict(cin=cin, cmid=width, cout=cout, stride=stride,
                             hw=hw)))
            hw //= stride
            cin = cout
    out.append(("gap", "gap", dict(c=cin, hw=hw)))
    out.append(("fc", "fc", dict(fin=cin, fout=cfg["num_classes"])))
    return out


def layout(cfg: dict) -> Dict[str, dict]:
    """Parameter tree: leaf -> (shape, fan_in or None for a zero bias)."""
    tree: Dict[str, dict] = {}
    for name, kind, g in layers(cfg):
        if kind == "conv":
            tree[name] = {"w": ((g["cout"], g["cin"], g["k"], g["k"]),
                                g["cin"] * g["k"] ** 2),
                          "b": ((g["cout"],), None)}
        elif kind == "unit":
            ci, cm, co = g["cin"], g["cmid"], g["cout"]
            t = {"w1": ((cm, ci, 1, 1), ci), "w2": ((cm, cm, 3, 3), cm * 9),
                 "w3": ((co, cm, 1, 1), cm), "b1": ((cm,), None),
                 "b2": ((cm,), None), "b3": ((co,), None)}
            if ci != co or g["stride"] != 1:
                t["wp"] = ((co, ci, 1, 1), ci)
            tree[name] = t
        elif kind == "fc":
            tree[name] = {"w": ((g["fin"], g["fout"]), g["fin"]),
                          "b": ((g["fout"],), None)}
        else:
            tree[name] = {}
    return tree


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride, rnd):
    k = w.shape[-1]
    ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b,
                    stride=stride)


def _apply(kind: str, g: dict, p: dict, x: torch.Tensor, rnd) -> torch.Tensor:
    if kind == "conv":
        return F.relu(_conv(x, p["w"], p["b"], g["stride"], rnd))
    if kind == "pool":
        return F.max_pool2d(x, 2, 2)
    if kind == "unit":
        s = g["stride"]
        h = F.relu(_conv(x, p["w1"], p["b1"], s, rnd))
        h = F.relu(_conv(h, p["w2"], p["b2"], 1, rnd))
        h = _conv(h, p["w3"], p["b3"], 1, rnd)
        sc = _conv(x, p["wp"], None, s, rnd) if "wp" in p else x
        return F.relu(h + sc)
    if kind == "gap":
        return x.mean(dim=(2, 3))
    a, w = (x, p["w"]) if rnd is None else (rnd(x), rnd(p["w"]))
    return a @ w + p["b"]


@torch.no_grad()
def forward(cfg: dict, params: dict, x: torch.Tensor, start: int = 0,
            end: Optional[int] = None, precision: str = "f32"
            ) -> torch.Tensor:
    """Layers ``[start, end)`` (all by default) over ``x`` in float32; with
    ``precision="tf32"`` every convolution and product reads its operands
    rounded to TF32."""
    rnd = rounder(precision)
    ls = layers(cfg)
    x = x.float()
    for name, kind, g in ls[start:len(ls) if end is None else end]:
        x = _apply(kind, g, {k: v.float() for k, v in params[name].items()},
                   x, rnd)
    return x


def boundary_shape(cfg: dict, point: int, batch: int) -> Tuple[int, ...]:
    """Shape of the activation after layer ``point``."""
    _, kind, g = layers(cfg)[point]
    if kind in ("conv", "unit"):
        o = g["hw"] // g["stride"]
        return (batch, g["cout"], o, o)
    if kind == "pool":
        return (batch, g["c"], g["hw"] // 2, g["hw"] // 2)
    if kind == "gap":
        return (batch, g["c"])
    return (batch, g["fout"])


def port_overrides(cfg: dict) -> dict:
    """The keys of the program's configuration that ``cfg`` sets."""
    return {"image_size": cfg["image_size"],
            "num_classes": cfg["num_classes"]}


def flops_per_image(cfg: dict) -> float:
    return cnn_flops_per_image(layers(cfg))
