#!/usr/bin/env python3
"""Depth extrapolation of the port's dry run: for combinations whose
full-depth count takes too long on a CPU host, count depth-reduced
variants of the same config (L = 2 and L = 6, the first L entries of its
``block_pattern``) on the fake 16 x 16 world of ``launch/dryrun.py``, fit
the affine model term(L) = a + b * L (the layers are homogeneous) and
extrapolate to the config's own depth. The port's counterpart of
``scripts/extrapolate_heavy.py``; the terms use the H100's profile
(``config/types.py``: ``H100``, ``H100_HBM_BW``, ``H100_NVLINK_BW``).

  PYTHONPATH=src python scripts/extrapolate_heavy_torch.py granite-34b train_4k

Appends a record with the dry run's keys and ``"source":
"extrapolated(L2,L6)"`` to ``--out`` (default
``results/dryrun_1pod.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict

from repro_torch.config import (
    H100,
    H100_HBM_BW,
    H100_NVLINK_BW,
    INPUT_SHAPES,
    TrainConfig,
    get_config,
)
from repro_torch.launch.dryrun import (
    _model_flops,
    count_fake_step,
    fake_device,
    fake_world,
)
from repro_torch.launch.step_analysis import StepCount
from repro_torch.models.api import build_model

L_SMALL, L_BIG = 2, 6


def at_depth(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` blocks."""
    pattern = cfg.block_pattern[:layers] if cfg.block_pattern else ""
    return cfg.replace(num_layers=layers, block_pattern=pattern)


def depth_fit(counts: Dict[int, StepCount], layers: int
              ) -> Callable[[Callable[[StepCount], float]], float]:
    """``fit(get)``: ``get`` of the counts at ``L_SMALL`` and ``L_BIG``,
    fitted by a + b * L and taken at ``layers``."""
    def fit(get):
        y1, y2 = get(counts[L_SMALL]), get(counts[L_BIG])
        b = (y2 - y1) / (L_BIG - L_SMALL)
        a = y1 - b * L_SMALL
        return a + b * layers
    return fit


def count_depths(base, shape, train_cfg: TrainConfig, mesh
                 ) -> Dict[int, StepCount]:
    """The step's count at ``L_SMALL`` and ``L_BIG`` blocks on ``mesh``
    (None: one device)."""
    counts = {}
    for layers in (L_SMALL, L_BIG):
        model = build_model(at_depth(base, layers))
        counts[layers] = count_fake_step(model, shape, train_cfg, mesh)
        c = counts[layers]
        print(f"L={layers}: flops/dev={c.flops:.3e} "
              f"bytes/dev={c.bytes_accessed:.3e} "
              f"wire/dev={c.collectives.total_wire_bytes:.3e}")
    return counts


def extrapolate(arch: str, shape_name: str) -> Dict:
    """The record of ``arch`` x ``shape_name`` at full depth on the fake
    16 x 16 mesh, extrapolated from L = 2 and L = 6."""
    from repro_torch.launch.mesh import make_production_mesh

    base = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    tc = TrainConfig(remat="blocks")
    fake_world(256)
    mesh = make_production_mesh(device=fake_device())
    chips = mesh.size()
    counts = count_depths(base, shape, tc, mesh)
    fit = depth_fit(counts, base.num_layers)

    model_full = build_model(base)
    flops = fit(lambda c: c.flops)
    nbytes = fit(lambda c: c.bytes_accessed)
    wire = fit(lambda c: c.collectives.total_wire_bytes)
    analytic = model_full.analytic_step_flops(
        shape, block_remat=(shape.mode == "train"))
    kinds = set()
    for c in counts.values():
        kinds |= set(c.collectives.by_kind())
    useful = _model_flops(model_full, shape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape), "chips": chips,
        "flops_per_device": flops,
        "bytes_accessed_per_device": nbytes,
        "wire_bytes_per_device": wire,
        "collectives": {
            k: [int(round(fit(lambda c, k=k: c.collectives.by_kind().get(
                k, (0, 0))[0]))),
                fit(lambda c, k=k: c.collectives.by_kind().get(k, (0, 0))[1])]
            for k in sorted(kinds)
        },
        "argument_bytes": int(fit(lambda c: c.argument_bytes)),
        "output_bytes": int(fit(lambda c: c.output_bytes)),
        "temp_bytes": int(fit(lambda c: c.temp_bytes)),
        "model_flops_global": useful,
        "analytic_flops_global": analytic,
        "compute_s": analytic / chips / H100.flops,
        "memory_s": nbytes / H100_HBM_BW,
        "collective_s": wire / H100_NVLINK_BW,
        "hbm_gib_per_device": (fit(lambda c: c.argument_bytes)
                               + fit(lambda c: c.output_bytes)
                               + fit(lambda c: c.temp_bytes)) / 2**30,
        "useful_flops_fraction": useful / (flops * chips) if flops else 0.0,
        "source": f"extrapolated(L{L_SMALL},L{L_BIG})",
        "mode": shape.mode,
    }
    terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
             "collective": rec["collective_s"]}
    rec["dominant"] = max(terms, key=terms.get)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--out", default="results/dryrun_1pod.jsonl")
    args = ap.parse_args(argv)
    rec = extrapolate(args.arch, args.shape)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"extrapolated {args.arch} x {args.shape}: "
          f"compute={rec['compute_s'] * 1e3:.1f}ms "
          f"memory={rec['memory_s'] * 1e3:.1f}ms "
          f"collective={rec['collective_s'] * 1e3:.1f}ms "
          f"dominant={rec['dominant']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
