#!/usr/bin/env python3
"""Hillclimb driver of the port's dry run: count one (arch x shape) step
on the fake production mesh under a named rule-table variant and print
its roofline terms on the H100 profile, for the hypothesis -> change ->
measure loop on sharding plans. The port's counterpart of
``scripts/hillclimb.py``, on ``repro_torch.launch.dryrun.dryrun_one``.

  PYTHONPATH=src python scripts/hillclimb_torch.py olmo-1b train_4k baseline
  PYTHONPATH=src python scripts/hillclimb_torch.py olmo-1b train_4k pure_dp
  PYTHONPATH=src python scripts/hillclimb_torch.py olmo-1b decode_32k tp_weights+kv8
  PYTHONPATH=src python scripts/hillclimb_torch.py yi-6b train_4k fsdp_dp 2 dots

Arguments: arch, shape, variant (a key of ``VARIANTS``, optionally ending
in ``+kv8`` for an int8 KV cache), microbatches (default 1), remat
(default ``blocks``). Each run appends its record, the dry run's keys plus
``variant``, ``remat`` and ``microbatches``, to ``--out`` (default
``results/hillclimb.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.config import INPUT_SHAPES, TrainConfig
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.sharding.rules import DEFAULT_RULES

# ---------------------------------------------------------------------------
# Rule-table variants (each is a full replacement table)
# ---------------------------------------------------------------------------


def _patched(**kw):
    rules = {k: list(v) for k, v in DEFAULT_RULES.items()}
    rules.update(kw)
    return rules


VARIANTS = {
    # the shipped default: FSDP(+TP) weights, data-parallel batch
    "baseline": None,

    # pure data parallelism over all 256 ranks: batch 256-way, weights
    # replicated except the (huge) vocab dim. No per-layer partial-sum
    # all-reduces and no FSDP weight all-gathers; one gradient all-reduce
    # over the full parameter set.
    "pure_dp": _patched(
        batch=[("pod", "data", "model"), ("data", "model"), ("data",)],
        ffn=[], heads=[], kv_heads=[], expert=[],
        ssm_in=[], ssm_qk=[], conv_out=[],
        vocab=[("model",)], kv_seq=[],
    ),

    # FSDP weights but no tensor parallelism (ZeRO-3-like): weights shard
    # over both axes for storage, batch over both axes for compute.
    "fsdp_dp": _patched(
        batch=[("pod", "data", "model"), ("data", "model"), ("data",)],
        ffn=[("data", "model"), ("model",), ("data",)],
        heads=[], kv_heads=[],
        kv_seq=[],
    ),

    # decode-oriented: weights tensor-parallel only (no "data" among the
    # weight candidates, so no per-step FSDP all-gathers), batch on data.
    "tp_weights": _patched(
        ffn=[("model",)], vocab=[("model",)], expert=[("model",)],
        ssm_in=[("model",)], conv_out=[("model",)], heads=[("model",)],
    ),

    # decode-oriented: fully replicated weights (most memory, no weight
    # collectives), the "small model, many requests" serving layout.
    "replicated": _patched(
        ffn=[], vocab=[], expert=[], ssm_in=[], ssm_qk=[], conv_out=[],
        heads=[], kv_heads=[],
    ),

    # tp_weights plus recurrent-state sharding: the xLSTM matrix state
    # (B, h, dh, dh) has dh = 512; its head_dim shards on "model", so a
    # step reads 16x less state a device. (Attention KV caches keep their
    # layout: their kv_seq dim claims "model" first by priority.)
    "tp_state": _patched(
        ffn=[("model",)], vocab=[("model",)], expert=[("model",)],
        ssm_in=[("model",)], conv_out=[("model",)], heads=[("model",)],
        head_dim=[("model",)],
    ),
}


def parse_variant(variant: str):
    """(rule-table name, config overrides) of a variant name."""
    if variant.endswith("+kv8"):
        return variant[:-4] or "baseline", {"kv_cache_bits": 8}
    return variant, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(INPUT_SHAPES))
    ap.add_argument("variant", help="a rule-table variant, may end in +kv8: "
                    + ", ".join(VARIANTS))
    ap.add_argument("micro", nargs="?", type=int, default=1)
    ap.add_argument("remat", nargs="?", default="blocks",
                    choices=["none", "full", "dots", "blocks"])
    ap.add_argument("--out", default="results/hillclimb.jsonl")
    args = ap.parse_args(argv)
    rules_name, overrides = parse_variant(args.variant)
    if rules_name not in VARIANTS:
        ap.error(f"unknown variant {args.variant!r}")
    tc = TrainConfig(remat=args.remat, microbatches=args.micro)
    rec = dryrun_one(args.arch, args.shape, train_cfg=tc,
                     rules=VARIANTS[rules_name], overrides=overrides or None)
    rec["variant"] = args.variant
    rec["remat"] = args.remat
    rec["microbatches"] = args.micro
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
