"""Adaptive edge-cloud serving under a drifting bandwidth trace (Fig. 8),
on the PyTorch port, on the CUDA card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/edge_cloud_serving_torch.py [--device cpu]

Builds the full JALAD serving stack (calibration -> ILP engine -> server
with a bandwidth-estimating adaptation controller) and serves a stream of
requests while the network degrades from 10 MB/s to 50 KB/s and recovers.
The controller re-solves the decoupling as its bandwidth estimate drifts:
watch the cut move toward the edge as the network gets worse.
"""
import argparse

from repro_torch.config import EDGE_TK1, JaladConfig, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.counters import launch_counts
from repro_torch.serving.edge_cloud import build_edge_cloud_server

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()
device = resolve_device(args.device)

cfg = get_config("resnet50").reduced()
# A slow TK1 edge keeps the optimum bandwidth-sensitive: on the fast TX2
# default, the byte-minimal late cut wins at every bandwidth of this
# reduced testbed and there would be nothing to adapt.
jalad = JaladConfig(bits_choices=(2, 4, 8), accuracy_drop_budget=0.10,
                    edge=EDGE_TK1)
server, params = build_edge_cloud_server(cfg, jalad, calib_batches=2,
                                         calib_batch_size=8, device=device)
print(f"server ready on {device}: {len(server.engine.tables.points)} "
      f"candidate cuts")

# a bandwidth trace that collapses from broadband to a congested link
# and recovers (KB/s). Requests reuse the calibration batch size, so the
# predicted S_i(c)/BW transfer term matches the serving clock's
# blob.nbytes/BW exactly.
trace = [10000, 4000, 1500, 600, 100, 50, 100, 600, 4000, 10000]
batches = [make_batch(cfg, 8, 0, seed=i) for i in range(len(trace))]

print(f"\n{'BW':>8} {'cut':>5} {'bits':>4} {'edge':>8} {'xfer':>8} "
      f"{'cloud':>8} {'total':>8} {'sent':>8}")
for bw_k, batch in zip(trace, batches):
    _, lat = server.serve_batch(batch, bandwidth=bw_k * 1e3)
    print(f"{bw_k:6d}KB {lat.plan_point:5d} {lat.plan_bits:4d} "
          f"{lat.edge_s*1e3:7.1f}m {lat.transfer_s*1e3:7.1f}m "
          f"{lat.cloud_s*1e3:7.1f}m {lat.total_s*1e3:7.1f}m "
          f"{lat.bytes_sent:7d}B")

totals = [l.total_s for l in server.log]
print(f"\nlatency stability: max/min = {max(totals)/min(totals):.1f}x over a "
      f"{max(trace)/min(trace):.0f}x bandwidth swing")
print(f"adaptation events: {len(server.controller.history)}")
# The hand-written kernels this run launched (none on the CPU, where each
# wrapper runs its plain PyTorch version).
print("kernel launches:", {k: v for k, v in launch_counts().items() if v})
