"""Multi-pod dry run: run one step of every (architecture x input shape)
combination on the production mesh without a device or a weight, and
report its roofline terms. The port's counterpart of the reference's
``launch/dryrun.py``, which lowers and compiles the step for 512 fake XLA
devices and reads the compiled artifact.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --no-unroll

train_4k runs the train step (forward, backward and AdamW); prefill_32k
the prefill step; decode_32k / long_500k the serve step: ONE new token
against a KV (or recurrent-state) cache of seq_len.

The world is fake, and this module alone starts it: a ``fake`` process
group on a ``FakeStore`` of 256 ranks (512 with ``--multi-pod``), whose
collectives move nothing. Rank 0 builds the production mesh over it
(``launch/mesh.py`` ``make_production_mesh``) and runs the step once
under ``FakeTensorMode``: the parameters, the optimizer state and the
batch are fake tensors of each leaf's local shape, placed by the rule
table (``sharding/rules.py``) with ``DTensor.from_local``, on
:func:`fake_device`. :class:`~repro_torch.launch.step_analysis.StepCounter`
reads rank 0's share of the step. Every device of these meshes holds the
same shapes, so one rank stands for all.

The loops over time (the mLSTM's, the sLSTM's, the sequential SSD's) go
through ``utils/scan.py`` ``scan`` and run rolled: three steps of each,
the middle one counted for the n - 2 it stands for, so xlstm-1.3b's
train_4k and prefill_32k count in minutes and exactly (XLA counts a
rolled scan's body once). Every layer runs, as the reference unrolls its
layer scans. With ``--no-unroll`` (``dryrun_one(unroll=False)``) the layer
loops roll too: three layers of each segment run and the count is the
same, where the reference's rolled layer scans undercount.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import INPUT_SHAPES, TrainConfig, get_config
from repro_torch.config.registry import assigned_archs
from repro_torch.launch.step_analysis import (
    StepCount,
    StepCounter,
    analyze_step,
    place_abstract,
)
from repro_torch.models.api import Model, build_model
from repro_torch.optim import adamw
from repro_torch.sharding.rules import shardings_for_specs
from repro_torch.training.loop import make_train_step
from repro_torch.utils.tree import tree_map


def fake_world(world_size: int) -> None:
    """Start a ``fake`` process group of ``world_size`` ranks (this process
    is rank 0), unless one of that size is running. A process that runs
    another group cannot host the fake one: a default group lasts as long
    as its process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {backend} group of {dist.get_world_size()} ranks is "
                f"running; the dry run needs a fake world of {world_size} "
                f"in a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _tokens_of(model: Model, shape) -> int:
    """Tokens (or samples) processed by one step of this shape."""
    if model.cfg.family == "cnn":
        return shape.global_batch
    if shape.mode in ("train", "prefill"):
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per sequence


def build_step(model: Model, shape, train_cfg: TrainConfig,
               mesh) -> Tuple[Any, Tuple, Tuple]:
    """Returns (step_fn, abstract_args, in_shardings): the step, its
    arguments as ``meta`` trees, and their placement trees on ``mesh``
    (None without a mesh). :func:`place_args` turns the last two into
    tensors."""
    abstract_params = model.abstract_params()

    def shard(specs, axes):
        return None if mesh is None else \
            shardings_for_specs(specs, axes, mesh)

    param_sh = shard(abstract_params, model.param_logical_axes())
    batch_specs = model.input_specs(shape)
    batch_sh = shard(batch_specs, model.batch_logical_axes(shape))

    if shape.mode == "train":
        step = make_train_step(model, train_cfg)
        opt_abstract = adamw.AdamWState(
            torch.empty((), dtype=torch.int32, device="meta"),
            _meta_like(abstract_params, torch.float32),
            _meta_like(abstract_params, torch.float32))
        opt_sh = None
        if mesh is not None:
            from torch.distributed.tensor import Replicate

            opt_sh = adamw.AdamWState([Replicate()] * mesh.ndim, param_sh,
                                      param_sh)
        return step, (abstract_params, opt_abstract, batch_specs), (
            param_sh, opt_sh, batch_sh)

    if shape.mode == "prefill":
        cache_len = model.cache_len_for(shape.seq_len)

        def prefill_step(params, batch):
            logits, caches = model.prefill(params, batch, cache_len)
            return logits[:, -1:], caches

        return prefill_step, (abstract_params, batch_specs), (
            param_sh, batch_sh)

    def serve_step(params, batch):
        return model.decode_step(params, batch["tokens"], batch["pos"],
                                 batch["caches"])

    return serve_step, (abstract_params, batch_specs), (param_sh, batch_sh)


def _meta_like(tree, dtype):
    return tree_map(lambda a: torch.empty(a.shape, dtype=dtype,
                                          device="meta"), tree)


def place_args(abstract_args, in_shardings, mesh, device):
    """The step's arguments as tensors on ``device`` (fake ones under
    ``FakeTensorMode``), each leaf a ``DTensor`` of its local shape on
    ``mesh``, or whole without one."""
    return tuple(place_abstract(a, sh, mesh, device)
                 for a, sh in zip(abstract_args, in_shardings))


def run_counted(step, args, rolled: Tuple[str, ...] = ()
                ) -> Tuple[Any, StepCount]:
    """One call of ``step(*args)`` under a
    :class:`~repro_torch.launch.step_analysis.StepCounter` that rolls the
    ``rolled`` kinds of loop (on fake tensors only). Plain tensors made
    inside a sharded step (positions, masks, scalars) act as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = StepCounter(args, rolled=rolled)
    with implicit_replication(), counter:
        out = step(*args)
    return out, counter.finish(out)


def fake_device() -> torch.device:
    """The fake tensors' device without a mesh: ``cuda`` (no card is
    needed for fake tensors), ``cpu`` on a build of torch without CUDA,
    which cannot index fake ``cuda`` tensors. The type changes no count."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


def count_fake_step(model: Model, shape, train_cfg: TrainConfig, mesh,
                    rolled: Tuple[str, ...] = ("time",)) -> StepCount:
    """The count of one step of ``shape`` on rank 0 of ``mesh`` (None: one
    device, unsharded, on :func:`fake_device`), every tensor fake, the
    ``rolled`` kinds of ``scan`` loop rolled (``"time"``, ``"layers"``)."""
    step, abstract, in_sh = build_step(model, shape, train_cfg, mesh)
    device = fake_device() if mesh is None else \
        torch.device(mesh.device_type)
    with fake_mode():
        args = place_args(abstract, in_sh, mesh, device)
        _, count = run_counted(step, args, rolled)
    return count


_FAKE_MODE = None


def fake_mode():
    """The process's one ``FakeTensorMode``: DTensor keeps tensors of a step
    in caches that outlive it, and a fake tensor cannot meet one of
    another mode."""
    global _FAKE_MODE
    from torch._subclasses.fake_tensor import FakeTensorMode

    if _FAKE_MODE is None:
        _FAKE_MODE = FakeTensorMode()
    return _FAKE_MODE


@contextlib.contextmanager
def rule_table(rules: Optional[Dict] = None):
    """Swap ``rules`` in for ``sharding/rules.py``'s ``DEFAULT_RULES`` for
    the block (None: the default stays), restored in a ``finally``.
    ``resolve_spec`` reads the table at call time, so it holds for the
    parameters, the batch and the model's activation constraints alike."""
    import repro_torch.sharding.rules as rules_mod

    saved = rules_mod.DEFAULT_RULES
    if rules is not None:
        rules_mod.DEFAULT_RULES = rules
    try:
        yield
    finally:
        rules_mod.DEFAULT_RULES = saved


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               train_cfg: Optional[TrainConfig] = None,
               rules: Optional[Dict] = None, unroll: bool = True,
               overrides: Optional[Dict] = None) -> Dict:
    """Count one combination on the fake production mesh, print its
    summary and return the roofline record. ``rules`` replaces the rule
    table for the whole counted step (:func:`rule_table`); ``overrides``
    are config fields, ``cfg.replace(**overrides)`` (``kv_cache_bits=8``).
    The loops over time always roll; ``unroll=False`` rolls the layer
    loops too, which counts the same in a fraction of the time."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = INPUT_SHAPES[shape_name]
    if cfg.family == "cnn" and shape.mode != "train":
        raise ValueError("CNN testbed only runs the train shape")
    model = build_model(cfg)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=fake_device())
    mesh_name = "x".join(str(s) for s in mesh.shape)
    train_cfg = train_cfg or TrainConfig()

    t0 = time.perf_counter()
    with rule_table(rules):
        count = count_fake_step(
            model, shape, train_cfg, mesh,
            ("time",) if unroll else ("time", "layers"))
    count_s = time.perf_counter() - t0

    report = analyze_step(
        count,
        arch=arch,
        shape=shape_name,
        mesh_name=mesh_name,
        chips=mesh.size(),
        model_flops_global=_model_flops(model, shape),
        analytic_flops_global=model.analytic_step_flops(
            shape,
            block_remat=(shape.mode == "train"
                         and train_cfg.remat == "blocks"),
        ),
    )
    rec = report.to_dict()
    rec["count_s"] = count_s
    rec["mode"] = shape.mode
    rec["ops"] = count.ops
    print(f"== {arch} x {shape_name} on {mesh_name} "
          f"({shape.mode}) - counted in {count_s:.1f}s, "
          f"{count.ops} ops")
    print(f"   memory: args={count.argument_bytes / 2**30:.2f}GiB "
          f"out={count.output_bytes / 2**30:.2f}GiB "
          f"temp={count.temp_bytes / 2**30:.2f}GiB per device")
    print(f"   counted: flops/dev={report.flops:.3e} "
          f"bytes/dev={report.bytes_accessed:.3e}")
    coll = {k: (c, f"{b / 2**20:.1f}MiB")
            for k, (c, b) in rec["collectives"].items()}
    print(f"   collectives: {coll}")
    print(f"   roofline (H100): compute={report.compute_s * 1e3:.2f}ms "
          f"memory={report.memory_s * 1e3:.2f}ms "
          f"collective={report.collective_s * 1e3:.2f}ms "
          f"-> dominant={report.dominant}")
    print(f"   useful-flops fraction (model/counted): "
          f"{report.useful_flops_fraction:.3f}")
    return rec


def _model_flops(model: Model, shape) -> float:
    tokens = _tokens_of(model, shape)
    f = model.model_flops(tokens)
    if shape.mode == "train":
        return f  # model_flops uses 6ND (fwd+bwd) for transformers
    return f / 3.0  # inference: 2ND


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x all shapes")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 ranks) instead of 16x16 (256)")
    ap.add_argument("--remat", default="blocks",
                    choices=["none", "full", "dots", "blocks"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-unroll", action="store_true",
                    help="roll the layer loops too (three layers of a "
                    "segment run, the middle one counted for the rest): "
                    "the same count in a fraction of the time, where the "
                    "reference's rolled scans undercount")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip combos already recorded in --out")
    args = ap.parse_args(argv)

    train_cfg = TrainConfig(remat=args.remat, microbatches=args.microbatches)

    combos = []
    if args.all:
        for a in assigned_archs():
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]

    done = set()
    if args.skip_existing and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                done.add((r["arch"], r["shape"]))

    records, failures = [], []
    for arch, shape in combos:
        if (arch, shape) in done:
            print(f"== {arch} x {shape}: already recorded, skipping")
            continue
        try:
            rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                             train_cfg=train_cfg, unroll=not args.no_unroll)
            records.append(rec)
            if args.out:   # append at once: survives an interruption
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception as e:  # noqa: BLE001 - every failure is reported
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))

    print(f"\n{len(records)} combinations counted OK, "
          f"{len(failures)} failed")
    for a, s, e in failures:
        print(f"  FAIL {a} x {s}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
