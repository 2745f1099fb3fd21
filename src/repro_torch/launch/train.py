"""Training launcher of the port, on the CUDA card unless ``--device cpu``
is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 50 --reduced --device cpu   # CPU-sized run of the family
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --steps 20 --checkpoint-dir ckpt --checkpoint-every 10   # full width
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.config import TrainConfig, get_config
from repro_torch.data.synthetic import ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.training.loop import REMAT_MODES, train
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.launch.train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=list(REMAT_MODES))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant of the family")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = build_model(cfg)
    log.info("arch=%s params=%.2fM device=%s", cfg.arch_id,
             model.param_count() / 1e6, device)

    tc = TrainConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 10, 1),
        microbatches=args.microbatches,
        remat=args.remat,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    loader = ShardedLoader(cfg, global_batch=args.batch, seq_len=args.seq,
                           seed=args.seed)
    result = train(model, tc, loader, num_steps=args.steps, device=device)
    log.info("done: first loss %.4f -> last loss %.4f (%.2f steps/s)",
             result.losses[0], result.losses[-1], result.steps_per_sec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
