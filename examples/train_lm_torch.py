"""End-to-end training driver on the PyTorch port: train a ~100M-param
dense LM for a few hundred steps on the synthetic token stream and watch
the loss drop, on the CUDA card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/train_lm_torch.py                # ~100M, 200 steps
  PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu  # quick smoke

The model is the olmo-1b family scaled to ~100M params (8 layers x 768).
Uses the same TrainConfig / train loop / AdamW / checkpointing stack the
launcher uses.
"""
import argparse

from repro_torch.config import TrainConfig, get_config
from repro_torch.data.synthetic import ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.training.loop import train

ap = argparse.ArgumentParser()
ap.add_argument("--tiny", action="store_true", help="CPU-quick smoke sizes")
ap.add_argument("--steps", type=int, default=None)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()
device = resolve_device(args.device)

base = get_config("olmo-1b")
if args.tiny:
    cfg = base.reduced()
    steps = args.steps or 30
    batch, seq = 8, 64
else:
    # ~100M params: 8 x d768 with the olmo flavour (non-parametric LN, tied)
    cfg = base.replace(num_layers=8, d_model=768, num_heads=12,
                       num_kv_heads=12, d_ff=3072, vocab_size=50304)
    steps = args.steps or 200
    batch, seq = 16, 256

model = build_model(cfg)
print(f"training {cfg.arch_id}-family model: "
      f"{model.param_count()/1e6:.1f}M params, {steps} steps, "
      f"batch {batch} x seq {seq} on {device}")

tc = TrainConfig(learning_rate=3e-3, total_steps=steps,
                 warmup_steps=max(steps // 10, 1), remat="none",
                 log_every=10)
loader = ShardedLoader(cfg, global_batch=batch, seq_len=seq, seed=0)
res = train(model, tc, loader, num_steps=steps, device=device)

first = sum(res.losses[:5]) / 5
last = sum(res.losses[-5:]) / 5
print(f"\nloss: {first:.4f} -> {last:.4f} "
      f"({res.steps_per_sec:.2f} steps/s)")
assert last < first, "loss did not improve"
print("OK: loss improved")
