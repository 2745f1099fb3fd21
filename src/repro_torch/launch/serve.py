"""Serving launcher of the port: synchronous JALAD edge-cloud serving of
the CNN testbed, on the CUDA card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet50 \
      --jalad --codec huffman --bandwidth 300e3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet50 \
      --reduced --jalad --device cpu       # small CPU run

The pipelined (``--pipeline``), continuous-batching (``--continuous``) and
LM paths are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

from repro_torch.config import JaladConfig, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.launch.serve")


def serve_jalad(args) -> int:
    """Edge-cloud decoupled serving of the CNN testbed (the paper's mode)."""
    from repro_torch.codec import get_codec, list_codecs
    from repro_torch.serving.edge_cloud import build_edge_cloud_server

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    codecs = tuple(list_codecs()) if args.codec == "auto" else (args.codec,)
    for name in codecs:
        get_codec(name)     # fail fast on a typo, before model/calibration
    jc = JaladConfig(bandwidth_bytes_per_s=args.bandwidth,
                     accuracy_drop_budget=args.acc_drop,
                     codec_choices=codecs)
    t0 = time.perf_counter()
    server, _ = build_edge_cloud_server(
        cfg, jc, seed=args.seed, calib_batches=args.calib,
        calib_batch_size=args.batch,
        tables_cache_dir=args.tables_cache or None, device=device)
    log.info("server ready on %s in %.2fs (tables cache: %s)", device,
             time.perf_counter() - t0, args.tables_cache or "disabled")
    batch = make_batch(cfg, args.batch, 64, seed=args.seed + 1)
    for i in range(args.requests):
        _, lat = server.serve_batch(batch, bandwidth=args.bandwidth)
        log.info(
            "req %d: point=%d bits=%d codec=%s edge=%.1fms xfer=%.1fms "
            "cloud=%.1fms sent=%dB", i, lat.plan_point, lat.plan_bits,
            lat.plan_codec, lat.edge_s * 1e3,
            lat.transfer_s * 1e3, lat.cloud_s * 1e3, lat.bytes_sent,
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--jalad", action="store_true",
                    help="JALAD edge-cloud decoupled mode (CNN testbed)")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlapped edge/link/cloud stages (not yet ported)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching LM scheduler (not yet ported)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--bandwidth", type=float, default=1e6)
    ap.add_argument("--codec", default="auto",
                    help="boundary codec for --jalad: a registry id "
                         "(huffman|bitpack) or 'auto' to let the planner "
                         "choose among all registered codecs")
    ap.add_argument("--tables-cache", default="",
                    help="directory for config-hashed predictor tables "
                         "(empty = always recalibrate)")
    ap.add_argument("--acc-drop", type=float, default=0.10)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--calib", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if args.pipeline or args.continuous or not args.jalad:
        raise NotImplementedError(
            "repro_torch: only the synchronous --jalad path is ported yet "
            "(--pipeline, --continuous and the LM paths are not)")
    return serve_jalad(args)


if __name__ == "__main__":
    sys.exit(main())
