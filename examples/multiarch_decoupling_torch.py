"""JALAD beyond CNNs on the PyTorch port: decouple every assigned
architecture family, on the CUDA card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/multiarch_decoupling_torch.py [--device cpu]

For each family (dense / MoE / SSM / hybrid / VLM / audio, reduced sizes)
this example picks a mid-network cut, quantizes the boundary hidden state
to 4 bits, runs head+compress+tail, and reports transfer bytes and top-1
agreement with the undecoupled model: the paper's technique as a generic
architecture-level capability.
"""
import argparse

import torch

from repro_torch.config import get_config
from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.models.api import batch_to, build_model

ARCHS = ["olmo-1b", "grok-1-314b", "xlstm-1.3b", "zamba2-2.7b",
         "qwen2-vl-7b", "seamless-m4t-large-v2"]

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()
device = resolve_device(args.device)

print(f"{'arch':28s} {'family':7s} {'cut':>4} {'raw B':>9} {'sent B':>8} "
      f"{'ratio':>6} {'agree':>6}")
for arch in ARCHS:
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device)
    batch = batch_to(make_batch(cfg, 2, 24, seed=1), device)
    n = len(model.decoupling_points())
    plan = DecoupledPlan(n // 2, 4, 0.0, 0.0, 0.0)
    runner = DecoupledRunner(model, params, plan)
    logits, sent = runner.run(batch)
    with torch.no_grad():
        full = model.forward(params, batch)
        out = model.run_head(params, batch, plan.point)
    agree = (logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    boundary = out[0] if isinstance(out, tuple) else out
    raw = boundary.numel() * boundary.element_size()
    print(f"{arch:28s} {cfg.family:7s} {plan.point:4d} {raw:9d} {sent:8d} "
          f"{raw/sent:5.1f}x {agree:6.2%}")
print("\nJALAD's cut+compress applies to every assigned family "
      "(Sec. Arch-applicability in DESIGN.md)")
