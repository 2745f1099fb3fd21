"""Parity of the port's step accounting (``launch/step_analysis.py``),
dry run (``launch/dryrun.py``) and ``serving/meshed.py``
``aot_tail_report`` with the reference's ``launch/hlo_analysis.py``,
``launch/dryrun.py`` and ``aot_tail_report``.

The reference compiles each step and reads XLA's per-device cost and
memory analysis; the port runs it once on fake tensors under a
``TorchDispatchMode`` counter. What is held:

* **Wire formulas.** The port prices the ops of the reference's
  synthetic HLO (kind, in and out bytes, group size) as the reference's
  ``parse_collectives`` does.
* **Argument bytes equal XLA's** (``memory_analysis``) for every
  ``build_step`` of the reference test's four archs and xlstm-1.3b,
  reduced, at its tiny shapes, on a one-rank mesh, and for ``aot_tail_report`` at every cut of
  reduced olmo-1b and resnet50 (the reference's ``keep_unused=False``
  pruning is the port's "leaves the step reads"). One difference is by
  design: a text family's tail rebuilds its positions from the
  boundary's shape, where the reference's takes them as an argument, so
  a reference tail that runs a block reads ``batch * seq`` int32 more.
* **FLOPs lie in a band of the port's ``analytic_step_flops``**, family
  by family, with each cause named at ``_expected``: 5 % for dense and
  CNN; the MoE once its capacity-padded expert buffer is added (every
  slot of ``(E, B, groups, capacity)`` is computed); the hybrid within 5
  % (the chunked scan's products, which the analytic count leaves out);
  the audio family from 0.70 to 0.85 (the analytic count prices a
  ``'c'`` block's two-matrix GELU MLP at three matrices and its cross
  K/V projections on every decoder token, where they run once on the
  encoder's frames); the recurrent xlstm-1.3b within 5 % once the
  mLSTM's gate projections and its recurrence's products are added. A
  train step with per-block remat recomputes the blocks, not the logits,
  which the analytic count recomputes too. XLA's ``cost_analysis`` FLOPs
  are recorded beside the counted ones; the ratios are printed (XLA
  pushes ``logits[:, -1:]`` into the product and counts a fused
  multiply-add once; it counts the body of xlstm-1.3b's ``lax.scan``
  over time once, where the port counts every step, so that ratio sits
  far above the others and is not bounded).
* **Meshes.** One subprocess a group of archs holds a fake world of 8
  (``fake`` backend on a ``FakeStore``) and counts every step on a
  one-rank mesh, a (2, 2) mesh and, for the tails, a (4, 1) mesh; the
  reference's side runs in subprocesses with 8 fake XLA devices, as
  ``tests/test_meshed.py`` runs them. Per-device argument bytes of the
  meshed tails equal the reference's; the parallel fraction (one
  device's FLOPs over a mesh device's) agrees within 10 % for the decoder
  (the port splits a product as DTensor's rules do, XLA as its
  partitioner does); the port's CNN splits on "data" alone.
  The collectives an olmo-1b step issues on (2, 2) are recorded by kind
  beside XLA's.
* **Variants.** olmo-1b's steps on (2, 2) under the hillclimb scripts'
  ``replicated`` rule table (``rule_table``, the reference's
  ``DEFAULT_RULES`` swapped the same way) and with ``kv_cache_bits=8``
  (``cfg.replace``): argument bytes equal XLA's, as for the default
  table. The two scripts' ``VARIANTS`` tables are equal.

Every subprocess runs with one thread; the five run side by side.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(1 if __name__ == "__main__" else 2)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmo-1b", "grok-1-314b", "zamba2-2.7b", "seamless-m4t-large-v2",
         "xlstm-1.3b"]
MODES = ["train", "prefill", "decode"]
TINY = {"train": ("tiny_train", 32, 4, "train"),
        "prefill": ("tiny_prefill", 32, 2, "prefill"),
        "decode": ("tiny_decode", 32, 2, "decode")}
# Port subprocess groups (side by side) and the reference's.
PORT_GROUPS = {"a": ["olmo-1b", "zamba2-2.7b"],
               "b": ["grok-1-314b", "seamless-m4t-large-v2"],
               "c": ["xlstm-1.3b"]}
REF_GROUPS = ["steps", "tails"]
TAIL_ARCHS = ["olmo-1b", "resnet50"]
TAIL_B, TAIL_S = 2, 16            # the reference's single-device geometry
MESH_B = 8                        # meshed tails: divides both data axes
MESH_POINTS = {"olmo-1b": [0, 1], "resnet50": [0, 10, 17, 19]}
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
PARALLEL_BAND = 0.10
# olmo-1b's (2, 2) steps under a rule-table variant or config overrides.
VARIANT_CASES = [("replicated", m) for m in MODES] + \
    [("kv8", "prefill"), ("kv8", "decode")]
VARIANT_OVERRIDES = {"kv8": {"kv_cache_bits": 8}}


def _script(name: str):
    """A module of ``scripts/`` loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variant(rules_mod, variants, variant: str):
    """(context swapping the rule table in, config overrides)."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        saved = rules_mod.DEFAULT_RULES
        table = variants.get(variant)
        if table is not None:
            rules_mod.DEFAULT_RULES = table
        try:
            yield
        finally:
            rules_mod.DEFAULT_RULES = saved

    return swapped(), VARIANT_OVERRIDES.get(variant, {})


def _tables(variants) -> dict:
    return {k: None if v is None else {a: [list(c) for c in cs]
                                       for a, cs in v.items()}
            for k, v in variants.items()}


# ---------------------------------------------------------------------------
# The subprocesses
# ---------------------------------------------------------------------------


def _count_dict(c):
    return {"flops": c.flops, "argument_bytes": c.argument_bytes,
            "output_bytes": c.output_bytes, "temp_bytes": c.temp_bytes,
            "bytes": c.bytes_accessed,
            "collectives": {k: list(v)
                            for k, v in c.collectives.by_kind().items()}}


def _port_side(group: str) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.serving.meshed import aot_tail_report

    dryrun.fake_world(8)

    def mesh(shape):
        n = shape[0] * shape[1]
        return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=("data", "model"))

    one, two = mesh((1, 1)), mesh((2, 2))
    out = {"steps": {}, "tails": {}}
    for arch in PORT_GROUPS[group]:
        model = build_model(get_config(arch).reduced())
        for mode in MODES:
            shape = ShapeConfig(*TINY[mode])
            for name, m in (("1x1", one), ("2x2", two)):
                c = dryrun.count_fake_step(model, shape,
                                           TrainConfig(remat="blocks"), m)
                out["steps"][f"{arch}/{mode}/{name}"] = _count_dict(c)
    if group == "a":
        variants = _script("hillclimb_torch").VARIANTS
        out["variants"] = _tables(variants)
        for variant, mode in VARIANT_CASES:
            rules = variants.get(variant)
            cfg = get_config("olmo-1b").reduced().replace(
                **VARIANT_OVERRIDES.get(variant, {}))
            with dryrun.rule_table(rules):
                c = dryrun.count_fake_step(
                    build_model(cfg), ShapeConfig(*TINY[mode]),
                    TrainConfig(remat="blocks"), two)
            out["steps"][f"olmo-1b/{mode}/2x2/{variant}"] = _count_dict(c)
        meshes = {k: mesh(v) for k, v in MESHES.items()}
        for arch in TAIL_ARCHS:
            model = build_model(get_config(arch).reduced())
            for p in range(len(model.decoupling_points())):
                out["tails"][f"{arch}/{p}/none"] = aot_tail_report(
                    model, p, batch=TAIL_B, seq_len=TAIL_S)
            for p in MESH_POINTS[arch]:
                out["tails"][f"{arch}/{p}/none8"] = aot_tail_report(
                    model, p, batch=MESH_B, seq_len=TAIL_S)
                for name, m in meshes.items():
                    out["tails"][f"{arch}/{p}/{name}"] = aot_tail_report(
                        model, p, batch=MESH_B, seq_len=TAIL_S, mesh=m)
    return out


def _ref_side(group: str) -> dict:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    # Lock the device count at 8 first: importing the reference's dry run
    # sets XLA_FLAGS to 512 devices for a backend not started yet.
    assert len(jax.devices()) == 8
    from repro.config import ShapeConfig, TrainConfig, get_config
    from repro.launch.dryrun import build_step
    from repro.launch.hlo_analysis import cost_analysis_dict, parse_collectives
    from repro.models.api import build_model
    from repro.serving.meshed import aot_tail_report

    def mesh(shape):
        n = shape[0] * shape[1]
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    out = {"steps": {}, "tails": {}}
    if group == "steps":
        import repro.sharding.rules as rules_mod

        variants = _script("hillclimb").VARIANTS
        out["variants"] = _tables(variants)
        cases = [(a, m, "1x1", None) for a in ARCHS for m in MODES] + \
            [("olmo-1b", m, "2x2", None) for m in MODES] + \
            [("olmo-1b", m, "2x2", v) for v, m in VARIANT_CASES]
        for arch, mode, name, variant in cases:
            swapped, overrides = _variant(rules_mod, variants, variant)
            model = build_model(get_config(arch).reduced().replace(
                **overrides))
            mm = mesh((1, 1) if name == "1x1" else (2, 2))
            # The table stays swapped through compile(): the activation
            # constraints resolve against it at trace time.
            with swapped:
                step, args, in_sh = build_step(
                    model, ShapeConfig(*TINY[mode]),
                    TrainConfig(remat="blocks"), mm)
                with mm:
                    compiled = jax.jit(step, in_shardings=in_sh).lower(
                        *args).compile()
            if variant:
                name = f"{name}/{variant}"
            ma = compiled.memory_analysis()
            coll = parse_collectives(compiled.as_text())
            out["steps"][f"{arch}/{mode}/{name}"] = {
                "flops": float(cost_analysis_dict(compiled).get("flops", 0)),
                "argument_bytes": int(ma.argument_size_in_bytes),
                "collectives": {k: list(v)
                                for k, v in coll.by_kind().items()}}
        return out
    for arch in TAIL_ARCHS:
        model = build_model(get_config(arch).reduced())
        for p in range(len(model.decoupling_points())):
            out["tails"][f"{arch}/{p}/none"] = aot_tail_report(
                model, p, batch=TAIL_B, seq_len=TAIL_S)
        for p in MESH_POINTS[arch]:
            out["tails"][f"{arch}/{p}/none8"] = aot_tail_report(
                model, p, batch=MESH_B, seq_len=TAIL_S)
            for name, shape in MESHES.items():
                out["tails"][f"{arch}/{p}/{name}"] = aot_tail_report(
                    model, p, batch=MESH_B, seq_len=TAIL_S, mesh=mesh(shape))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' numbers, from four subprocesses run side by side."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jobs = [("port", g, env) for g in PORT_GROUPS] + \
        [("ref", g, ref_env) for g in REF_GROUPS]
    procs = []
    for side, g, e in jobs:
        path = d / f"{side}_{g}.json"
        procs.append((side, g, path, subprocess.Popen(
            [sys.executable, __file__, side, g, str(path)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {"port": {"steps": {}, "tails": {}},
           "ref": {"steps": {}, "tails": {}}}
    fails = []
    for side, g, path, proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            fails.append(f"{side} {g} rc={proc.returncode}:\n{log[-3000:]}")
            continue
        got = json.loads(path.read_text())
        print(f"{side} {g}: {got['seconds']:.1f} s")
        for k in ("steps", "tails"):
            out[side][k].update(got[k])
        if "variants" in got:
            out[side]["variants"] = got["variants"]
    assert not fails, "\n".join(fails)
    return out


# ---------------------------------------------------------------------------
# Expected counts
# ---------------------------------------------------------------------------


def _expected(model, shape, remat: bool) -> float:
    """The port's analytic count, corrected for what the port's step
    computes where the two differ by construction:

    * a MoE block computes every slot of its capacity-padded expert
      buffer, where the analytic count takes k experts a token;
    * an mLSTM block computes its input and forget gates' projections
      (``di x heads`` each a token) and, every step of its recurrence,
      ``C q`` and ``n q`` (``di x head_dim`` and ``di`` a token), which
      the analytic count leaves out (its ``3 di^2`` are q, k and v);
    * per-block remat (``torch.utils.checkpoint``, non-reentrant)
      recomputes each block in the backward, but not the logits (outside
      the blocks), and not a block's last product: the recompute stops
      once the tensors the backward saved are rebuilt, and the last
      product's output is not one of them. The analytic count recomputes
      the whole forward. A MoE block's last product (the experts' down
      projection) is recomputed: the combine after it keeps its output
      for the backward."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers.mamba2 import mamba_dims
    from repro_torch.models.layers.moe import expert_capacity, group_shape

    cfg = model.cfg
    d = cfg.d_model
    want = model.analytic_step_flops(shape, block_remat=remat)
    b = shape.global_batch
    seq = shape.seq_len if shape.mode != "decode" else 1
    tokens = b * seq
    passes = {"train": 4.0 if remat else 3.0}.get(shape.mode, 1.0)
    kinds = [seg.kind for seg in tf.segment_plan(cfg)
             for _ in range(seg.count)]
    slots = 0
    if "e" in kinds:
        g, ng = group_shape(seq)
        slots = cfg.num_experts * b * ng * expert_capacity(g, cfg)
        chosen = tokens * cfg.experts_per_token
        want += passes * 2.0 * 3.0 * d * cfg.moe_d_ff_ \
            * (slots - chosen) * kinds.count("e")
    di, h = cfg.ssm_expand * d, cfg.num_heads
    if "l" in kinds:
        want += passes * 2.0 * tokens * (2 * di * h + di * (di // h) + di) \
            * kinds.count("l")
    if shape.mode == "train" and remat:
        want -= 2.0 * tokens * d * cfg.vocab_size
        last = {"d": tokens * cfg.d_ff * d, "A": tokens * cfg.d_ff * d,
                "c": tokens * cfg.d_ff * d, "e": 0, "l": tokens * di * d}
        if "m" in kinds:
            last["m"] = tokens * mamba_dims(cfg).d_inner * d
        want -= 2.0 * sum(last[k] for k in kinds)
    return want


# The band around _expected a family's counted FLOPs lie in.
BANDS = {"dense": (0.95, 1.05), "moe": (0.95, 1.05),
         "hybrid": (0.95, 1.05), "audio": (0.70, 0.85),
         "cnn": (0.95, 1.05), "ssm": (0.95, 1.05)}


def _tail_expected(model, point: int, batch: int, seq: int) -> float:
    """The analytic FLOPs of the cloud tail after ``point``: the CNN
    layers' 2·FMACs; a decoder's blocks, their attention and the
    logits."""
    cfg = model.cfg
    fm = model.per_point_fmacs(batch, seq)[point + 1:]
    want = 2.0 * sum(fm)
    if model.is_lm:
        n_attn = len(fm)      # olmo: every block is attention
        want += 4.0 * batch * cfg.num_heads * seq * seq * cfg.head_dim_ \
            * n_attn
        want += 2.0 * batch * seq * cfg.d_model * cfg.vocab_size
    return want


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_wire_formulas_match_reference():
    """The reference's synthetic HLO, priced by the port op for op."""
    from repro.launch.hlo_analysis import parse_collectives
    from repro_torch.launch.step_analysis import (
        CollectiveStats,
        price_collective,
    )

    hlo = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %x), replica_groups=[32,8]<=[8,32]T(1,0), dimensions={0}
  %ar = f32[16,16]{1,0} all-reduce(f32[16,16]{1,0} %y), replica_groups={{0,1,2,3}, {4,5,6,7}}, to_apply=%add
  %rs = f32[2,16]{1,0} reduce-scatter(f32[8,16]{1,0} %z), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = bf16[4,4]{1,0} collective-permute(bf16[4,4]{1,0} %w), source_target_pairs={{0,1}}
  %aa = f32[8,8]{1,0} all-to-all(f32[8,8]{1,0} %v), replica_groups={{0,1,2,3}}, dimensions={0}
"""
    ref = parse_collectives(hlo)
    assert len(ref.ops) == 5
    mine = CollectiveStats([price_collective(o.kind, o.in_bytes,
                                             o.out_bytes, o.group_size)
                            for o in ref.ops])
    for a, b in zip(mine.ops, ref.ops):
        assert (a.kind, a.in_bytes, a.out_bytes, a.group_size) == \
            (b.kind, b.in_bytes, b.out_bytes, b.group_size)
        assert a.wire_bytes == b.wire_bytes
    assert mine.by_kind() == ref.by_kind()
    assert mine.total_wire_bytes == ref.total_wire_bytes
    with pytest.raises(ValueError, match="no wire price"):
        price_collective("broadcast", 8, 8, 2)


def test_roofline_report_keys_match_reference():
    """The record a roofline benchmark reads has the reference's keys;
    the terms divide by the H100's figures."""
    from repro.launch.hlo_analysis import RooflineReport as JReport
    from repro_torch.config import H100, H100_HBM_BW, H100_NVLINK_BW
    from repro_torch.launch.step_analysis import RooflineReport

    kw = dict(arch="a", shape="s", mesh="2x2", chips=4, flops=8e9,
              bytes_accessed=6e9, wire_bytes=1e8,
              collectives={"all-gather": (2, 1e8)}, argument_bytes=10,
              output_bytes=20, temp_bytes=30, model_flops_global=1e10,
              analytic_flops_global=4e10)
    mine, ref = RooflineReport(**kw).to_dict(), JReport(**kw).to_dict()
    assert list(mine) == list(ref)
    assert mine["compute_s"] == 4e10 / 4 / H100.flops
    assert mine["memory_s"] == 6e9 / H100_HBM_BW
    assert mine["collective_s"] == 1e8 / H100_NVLINK_BW
    assert mine["dominant"] == "memory"
    assert mine["useful_flops_fraction"] == ref["useful_flops_fraction"]
    assert H100.flops == 989e12 and H100_HBM_BW == 3.35e12


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_one_rank(runs, arch, mode):
    """Counted FLOPs in the family's band; argument bytes equal XLA's."""
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.models.api import build_model

    port = runs["port"]["steps"][f"{arch}/{mode}/1x1"]
    ref = runs["ref"]["steps"][f"{arch}/{mode}/1x1"]
    model = build_model(get_config(arch).reduced())
    shape = ShapeConfig(*TINY[mode])
    want = _expected(model, shape, remat=mode == "train")
    lo, hi = BANDS[model.cfg.family]
    assert port["flops"] > 0
    assert lo <= port["flops"] / want <= hi, (port["flops"], want)
    # The port's decode step turns ``pos`` (an int32 scalar) into a row of
    # int64 positions up front, so it reads it even where no block uses
    # it (xlstm-1.3b has no attention), where XLA prunes the argument.
    from repro_torch.models import transformer as tf

    unused_pos = 4 if mode == "decode" and not any(
        seg.kind in "deAc" for seg in tf.segment_plan(model.cfg)) else 0
    assert port["argument_bytes"] == ref["argument_bytes"] + unused_pos
    assert port["collectives"] == {}          # one rank moves nothing
    print(f"{arch} {mode}: counted/XLA cost_analysis FLOPs = "
          f"{port['flops'] / ref['flops']:.3f}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_mesh_2x2(runs, arch, mode):
    """On (2, 2) every step runs; its FLOPs a device are within the one-rank
    step's and a quarter of it (the batch always splits on "data"; a
    product splits on "model" where the rule table shards it), and a
    device holds at most the one-rank step's arguments."""
    one = runs["port"]["steps"][f"{arch}/{mode}/1x1"]
    two = runs["port"]["steps"][f"{arch}/{mode}/2x2"]
    assert one["flops"] / 4 * 0.99 <= two["flops"] <= one["flops"] / 2
    assert two["argument_bytes"] < one["argument_bytes"]
    assert two["collectives"]


@pytest.mark.parametrize("mode", MODES)
def test_olmo_collectives_by_kind(runs, mode):
    """The collectives an olmo-1b step issues on (2, 2), beside XLA's:
    both gather and reduce, each in its own way (DTensor resolves a
    placement op by op; XLA's partitioner over the whole program)."""
    port = runs["port"]["steps"][f"olmo-1b/{mode}/2x2"]["collectives"]
    ref = runs["ref"]["steps"][f"olmo-1b/{mode}/2x2"]["collectives"]
    assert "all-gather" in port and ref
    assert {"all-reduce", "reduce-scatter"} & set(port)
    print(f"olmo-1b {mode} on 2x2: port {port}; XLA {ref}")


def test_hillclimb_variants_match_reference(runs):
    """``scripts/hillclimb_torch.py``'s rule tables are the reference
    script's, variant for variant."""
    port, ref = runs["port"]["variants"], runs["ref"]["variants"]
    assert list(port) == list(ref)
    assert port == ref


@pytest.mark.parametrize("variant,mode", VARIANT_CASES)
def test_variant_argument_bytes_match_xla(runs, variant, mode):
    """Under the ``replicated`` table or ``kv_cache_bits=8``, olmo-1b's
    (2, 2) step reads XLA's argument bytes; replicated weights grow them
    past the default table's, an int8 cache shrinks a decode's."""
    port = runs["port"]["steps"][f"olmo-1b/{mode}/2x2/{variant}"]
    ref = runs["ref"]["steps"][f"olmo-1b/{mode}/2x2/{variant}"]
    default = runs["port"]["steps"][f"olmo-1b/{mode}/2x2"]
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert default["argument_bytes"] == \
        runs["ref"]["steps"][f"olmo-1b/{mode}/2x2"]["argument_bytes"]
    if variant == "replicated":
        assert port["argument_bytes"] > default["argument_bytes"]
    elif mode == "decode":
        assert port["argument_bytes"] < default["argument_bytes"]
    assert port["flops"] > 0


@pytest.mark.parametrize("arch", TAIL_ARCHS)
def test_aot_tail_report_single_device(runs, arch):
    """At every cut: the five keys, ``n_devices`` 1, argument and output
    bytes equal the reference's (the positions argument aside), FLOPs in
    the band of the tail's analytic count."""
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    model = build_model(get_config(arch).reduced())
    n = len(model.decoupling_points())
    seen = set()
    for p in range(n):
        port = runs["port"]["tails"][f"{arch}/{p}/none"]
        ref = runs["ref"]["tails"][f"{arch}/{p}/none"]
        assert list(port) == list(ref)
        assert port["n_devices"] == ref["n_devices"] == 1
        positions = 0
        if model.is_lm and p + 1 < n:     # the tail runs a block
            positions = TAIL_B * TAIL_S * 4
        assert port["argument_bytes_per_device"] == \
            ref["argument_bytes_per_device"] - positions, p
        assert port["output_bytes_per_device"] == \
            ref["output_bytes_per_device"]
        want = _tail_expected(model, p, TAIL_B, TAIL_S)
        if want:
            assert 0.95 <= port["flops_per_device"] / want <= 1.05, p
        else:
            assert port["flops_per_device"] == 0.0
        seen.add(port["argument_bytes_per_device"])
    if arch == "olmo-1b":
        assert 557_056 in seen
    else:
        assert 128 in seen


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TAIL_ARCHS)
def test_aot_tail_report_meshed(runs, arch, mesh):
    """On a fake mesh: ``n_devices`` 4, per-device argument bytes equal
    the reference's (the positions argument aside), and the parallel
    fraction agrees within ``PARALLEL_BAND`` for the decoder; the CNN's is
    the "data" axis's size (see below)."""
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    model = build_model(get_config(arch).reduced())
    n = len(model.decoupling_points())
    data = MESHES[mesh][0]
    for p in MESH_POINTS[arch]:
        port = runs["port"]["tails"][f"{arch}/{p}/{mesh}"]
        ref = runs["ref"]["tails"][f"{arch}/{p}/{mesh}"]
        assert port["n_devices"] == ref["n_devices"] == 4
        positions = 0                     # replicated in the reference
        if model.is_lm and p + 1 < n:
            positions = MESH_B * TAIL_S * 4
        assert port["argument_bytes_per_device"] == \
            ref["argument_bytes_per_device"] - positions, (p, mesh)
        single = runs["port"]["tails"][f"{arch}/{p}/none8"]
        rsingle = runs["ref"]["tails"][f"{arch}/{p}/none8"]
        if not single["flops_per_device"]:
            assert port["flops_per_device"] == 0.0
            continue
        frac = single["flops_per_device"] / port["flops_per_device"]
        rfrac = rsingle["flops_per_device"] / ref["flops_per_device"]
        print(f"{arch} {p} on {mesh}: parallel fraction port {frac:.3f}, "
              f"XLA {rfrac:.3f}")
        if model.is_lm:
            assert abs(frac / rfrac - 1) <= PARALLEL_BAND, (p, frac, rfrac)
        else:
            # The port's CNN layers run on each rank's batch shard
            # (on_batch_shard: DTensor's convolution rule does not fit the
            # rule table), so only "data" splits them; XLA also splits a
            # convolution's channels on "model".
            assert frac == data, (p, frac)
            assert frac <= rfrac * (1 + PARALLEL_BAND)


if __name__ == "__main__":
    import time

    t0 = time.perf_counter()
    side, group, path = sys.argv[1:4]
    result = _port_side(group) if side == "port" else _ref_side(group)
    result["seconds"] = time.perf_counter() - t0
    Path(path).write_text(json.dumps(result))
