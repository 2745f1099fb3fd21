"""Quickstart on the PyTorch port: the JALAD pipeline end to end on a
small CNN, in five steps, on the CUDA card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. Build a model (the paper's ResNet testbed, reduced).
2. Calibrate the accuracy/size predictor tables A_i(c), S_i(c).
3. Build the FMAC latency model with the paper's device constants.
4. Solve the decoupling ILP for the current bandwidth.
5. Run the decoupled inference: edge head -> quantize+Huffman ->
   "transfer" -> dequantize -> cloud tail (on the card: the encode and
   decode kernels, K1/K3 and K2, or K4/K5 when a plan picks per-channel).
"""
import argparse

import torch

from repro_torch.config import CLOUD_1080TI, EDGE_TK1, JaladConfig, get_config
from repro_torch.core.decoupler import JaladEngine
from repro_torch.core.latency import LatencyModel
from repro_torch.core.predictor import build_tables
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.counters import launch_counts
from repro_torch.models.api import batch_to, build_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()
device = resolve_device(args.device)

# 1. model -----------------------------------------------------------------
cfg = get_config("resnet50").reduced()
model = build_model(cfg)
params = model.init(0, device)
points = model.decoupling_points()
print(f"model: {cfg.arch_id} ({model.param_count()/1e6:.2f}M params, "
      f"{len(points)} decoupling points) on {device}")

# 2. predictors -------------------------------------------------------------
bits_choices = [2, 4, 8]
BATCH = 4
calib = [make_batch(cfg, BATCH, 0, seed=i) for i in range(2)]
tables = build_tables(model, params, calib, bits_choices)
print(f"calibrated A_i(c), S_i(c): base accuracy {tables.base_accuracy:.2f}")

# 3. latency model ----------------------------------------------------------
# Same per-batch unit everywhere: S_i(c) is bytes per calibration batch,
# so the FMAC vectors and the raw-input upload are sized for BATCH too.
# The TK1 edge keeps the cut bandwidth-sensitive on this reduced testbed
# (on the fast TX2, the byte-minimal late cut wins at every bandwidth).
lat = LatencyModel(
    model.per_point_fmacs(BATCH), EDGE_TK1, CLOUD_1080TI,
    input_bytes=BATCH * 3 * cfg.image_size ** 2,
)

# 4. decide -----------------------------------------------------------------
jalad = JaladConfig(bits_choices=tuple(bits_choices),
                    accuracy_drop_budget=0.10)
engine = JaladEngine(model, tables, lat, jalad)
for bw in (10e6, 1e6, 50e3):
    plan = engine.decide(bandwidth=bw)
    print(f"BW {bw/1e3:6.0f} KB/s -> cut after {points[plan.point]!r} "
          f"(#{plan.point}), c={plan.bits} bits, "
          f"predicted {plan.predicted_latency*1e3:.2f} ms "
          f"(solved in {plan.solve_ms:.2f} ms)")

# 5. run decoupled ----------------------------------------------------------
# Broadband: the ILP picks an early cloud-heavy cut whose (quantized +
# entropy-coded) interior boundary shows the real compression story.
plan = engine.decide(bandwidth=10e6)
runner = engine.make_runner(params, plan)
batch = make_batch(cfg, BATCH, 0, seed=99)
logits, sent_bytes = runner.run(batch)
with torch.no_grad():
    full = model.forward(params, batch_to(batch, device))
agree = (logits.argmax(-1) == full.argmax(-1)).float().mean().item()
raw = model.boundary_bytes(BATCH)[plan.point]
print(f"decoupled inference: sent {sent_bytes} B "
      f"(raw boundary {raw} B, {raw/sent_bytes:.1f}x compression), "
      f"top-1 agreement with the undecoupled model: {agree:.2%}")
# The hand-written kernels this run launched (none on the CPU, where each
# wrapper runs its plain PyTorch version).
print("kernel launches:", {k: v for k, v in launch_counts().items() if v})
