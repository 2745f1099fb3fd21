"""Values of the port's sharded layers on a real multi-rank mesh, against
the same model unsharded.

The dry run and ``aot_tail_report`` run the sharded paths on fake
tensors, which check shapes and counts, never values. Here four ``gloo``
ranks (this file run as a script, one process a rank, joined through a
``FileStore``) run them on real tensors, on a (2, 2) and a (4, 1) mesh of
``("data", "model")``, and every rank holds its result against the plain
run of the same reduced model, weights (``init(seed=0)``) and inputs:

* decode: a prefill and two decode steps (per-row positions, the second
  with one row's ``live`` flag off) with parameters placed by
  ``param_shardings`` and the caches by ``cache_logical_axes`` through the
  rule table, so KV caches split on ``kv_heads``, on ``kv_seq`` or on
  both (``attention._write_rows_sharded``, ``_on_head_shards``), a
  recurrent state on its batch (``like_layout``) and the MoE block on
  its batch shard (``on_batch_shard``). Logits and the updated caches;
* the cloud tail: ``MeshedCloudWorker`` serving a group of four blobs of
  reduced grok-1 (MoE) and zamba2 (Mamba2 and shared attention) against
  the unmeshed runner's tails of the same blobs;
* training: ``launch/dryrun.py`` ``build_step``'s train step on sharded
  parameters, optimizer state and batch (the vocab gathered for the
  loss, ``gather_dim``): its loss against ``Model.loss_fn`` and its loss
  and gradient norm against the plain step's.

Tolerances: ``RTOL, ATOL = 2e-4, 2e-5``, the reference's own between its
meshed and single-device tails (a sharded forward sums in other orders),
as ``tests/test_torch_meshed.py`` holds them, with the difference also
within RTOL of the values' scale.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1 if __name__ == "__main__" else 2)

RTOL, ATOL = 2e-4, 2e-5
WORLD = 4
MESHES = {"2x2": 2, "4x1": 1}          # the model axis's size
PROMPT, CACHE_LEN = 8, 16
# (arch, batch): the cache dims the rule table splits on each mesh are
# checked in test_decode_cache_layouts.
DECODE = [("olmo-1b", 1), ("olmo-1b", 2), ("granite-34b", 2),
          ("grok-1-314b", 2), ("zamba2-2.7b", 2)]
TAILS = ["grok-1-314b", "zamba2-2.7b"]
TAIL_GROUP, TAIL_SEQ = 4, 16
TRAIN = ["olmo-1b", "grok-1-314b", "zamba2-2.7b"]
TRAIN_BATCH, TRAIN_SEQ = 4, 16
RANK_TIMEOUT_S = 120.0
SUBPROCESS_TIMEOUT_S = 300
ROOT = Path(__file__).resolve().parent.parent


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= RTOL * scale


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (a list, rank order)."""
    tmp = tmp_path_factory.mktemp("sharded_values")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(tmp)],
        env=env, cwd=str(ROOT), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=SUBPROCESS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} ---\n" + f.read()[-3000:])
        f.close()
    assert rcs == [0] * WORLD, (rcs, "\n".join(text))
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def _decode_ids():
    return [f"{a}-b{b}-{m}" for a, b in DECODE for m in MESHES]


@pytest.mark.parametrize("key", _decode_ids())
def test_sharded_decode_matches_plain(ranks, key):
    for out in ranks:
        case = out["decode"][key]
        for got, want in case["logits"]:
            _close(got, want)
        assert len(case["caches"]) > 0
        for got, want in case["caches"]:
            _close(got, want)


def test_decode_cache_layouts(ranks):
    """The decode cases split a KV cache on kv_heads, on kv_seq and on
    both, and shard a recurrent state and the MoE block's input on the
    batch: the layouts the sharded write and the head-shard core serve."""
    lay = {k: v["kv_layout"] for k, v in ranks[0]["decode"].items()}
    # (batch, kv_seq, kv_heads, head_dim): the mesh axes split over.
    assert lay["olmo-1b-b2-2x2"] == [("data",), None, ("model",), None]
    assert lay["olmo-1b-b1-2x2"] == [None, ("data",), ("model",), None]
    assert lay["granite-34b-b2-2x2"] == [("data",), ("model",), None, None]
    assert lay["olmo-1b-b2-4x1"][1] is not None
    assert lay["grok-1-314b-b2-2x2"][0] == ("data",)
    assert ranks[0]["decode"]["zamba2-2.7b-b2-2x2"]["state_layout"][0] == \
        ("data",)


@pytest.mark.parametrize("arch", TAILS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_meshed_tail_matches_plain(ranks, arch, mesh):
    for out in ranks:
        case = out["tails"][f"{arch}-{mesh}"]
        assert case["fused_calls"] == 1
        assert case["group_sizes"] == [TAIL_GROUP]
        assert len(case["logits"]) == TAIL_GROUP
        for got, want in case["logits"]:
            _close(got, want)


@pytest.mark.parametrize("arch", TRAIN)
def test_sharded_train_step_loss(ranks, arch):
    for out in ranks:
        case = out["train"][arch]
        _close(case["loss"], case["loss_fn"])
        _close(case["loss"], case["plain_loss"])
        _close(case["grad_norm"], case["plain_grad_norm"])
        assert case["sharded_params"] > 0


def test_ranks_agree(ranks):
    """Every rank gathers the same whole values."""
    first = ranks[0]
    for out in ranks[1:]:
        for key, case in first["decode"].items():
            for (a, _), (b, _) in zip(case["logits"],
                                      out["decode"][key]["logits"]):
                np.testing.assert_array_equal(a, b)
        for key, case in first["train"].items():
            assert case["loss"] == out["train"][key]["loss"]


# ---------------------------------------------------------------------------
# A rank (this file as a script)
# ---------------------------------------------------------------------------


def _np(t):
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def _clone(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(torch.clone, tree)


def _spec(t):
    """A DTensor's split per tensor dim: the mesh axes, major to minor."""
    names = t.device_mesh.mesh_dim_names
    out = [None] * t.ndim
    for j, p in enumerate(t.placements):
        if p.is_shard():
            out[p.dim] = (out[p.dim] or ()) + (names[j],)
    return out


def _decode_case(arch, batch, mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.config import get_config
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.api import build_model
    from repro_torch.serving.meshed import param_shardings, shard_params
    from repro_torch.sharding.rules import shardings_for_specs
    from repro_torch.utils.tree import tree_leaves

    model = build_model(get_config(arch).reduced())
    cfg = model.cfg
    params = model.init(seed=0, device="cpu")
    sparams = shard_params(params, param_shardings(model, mesh), mesh)
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32))

    def on_batch(t):
        sh = shardings_for_specs(t, ("batch",) + (None,) * (t.ndim - 1),
                                 mesh)
        return shard_params(t.clone(), sh, mesh)

    logits = []
    want, caches = model.prefill(params, {"tokens": prompt}, CACHE_LEN)
    with implicit_replication():
        got, _ = model.prefill(sparams, {"tokens": on_batch(prompt)},
                               CACHE_LEN)
    logits.append((_np(got), _np(want)))
    axes = tf_lib.cache_logical_axes(cfg)
    scaches = shard_params(_clone(caches), shardings_for_specs(
        caches, axes, mesh), mesh)
    # Per-row positions whose slots fall in different kv_seq shards; the
    # second step leaves the last row out.
    steps = [(torch.tensor([PROMPT, PROMPT - 3][:batch], dtype=torch.int32),
              None),
             (torch.tensor([PROMPT - 5, PROMPT + 1][:batch],
                           dtype=torch.int32),
              torch.tensor([True, False][:batch]) if batch > 1 else None)]
    for pos, live in steps:
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, 1)).astype(np.int32))
        want, _ = model.decode_step(params, tokens, pos, caches, live)
        with implicit_replication():
            got, _ = model.decode_step(sparams, on_batch(tokens), pos,
                                       scaches, live)
        logits.append((_np(got), _np(want)))
    cache_pairs = [(_np(a), _np(b)) for a, b in zip(tree_leaves(scaches),
                                                   tree_leaves(caches))]
    kv = [t for seg in scaches for k, t in seg.items() if k == "k"]
    rec = [t for seg in scaches for k, t in seg.items() if k == "ssm"]
    return dict(logits=logits, caches=cache_pairs,
                kv_layout=_spec(kv[0])[1:] if kv else None,
                state_layout=_spec(rec[0])[1:] if rec else None)


def _tail_case(arch, mesh):
    from repro_torch.config import get_config
    from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import build_model
    from repro_torch.serving.meshed import MeshedCloudWorker

    model = build_model(get_config(arch).reduced())
    params = model.init(seed=0, device="cpu")
    plan = DecoupledPlan(0, 8, 0.0, 0.0, 0.0, codec="bitpack")
    plain = DecoupledRunner(model, params, plan)
    pairs = [plain.edge_step(make_batch(model.cfg, 1, TAIL_SEQ, seed=40 + i))
             for i in range(TAIL_GROUP)]
    blobs, extras = [p[0] for p in pairs], [p[1] for p in pairs]
    want = plain.cloud_step_batch(blobs, extras)
    worker = MeshedCloudWorker(model, params, mesh)
    got = DecoupledRunner(model, params, plan,
                          mesh_worker=worker).cloud_step_batch(blobs, extras)
    return dict(logits=[(_np(g), _np(w)) for g, w in zip(got, want)],
                fused_calls=worker.fused_calls,
                group_sizes=list(worker.group_sizes))


def _train_case(arch, mesh):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.dryrun import build_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.serving.meshed import shard_params
    from repro_torch.training.loop import make_train_step
    from repro_torch.utils.tree import tree_leaves

    model = build_model(get_config(arch).reduced())
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32))}
    shape = ShapeConfig("values", TRAIN_SEQ, TRAIN_BATCH, "train")
    tc = TrainConfig(remat="blocks")
    with torch.no_grad():
        loss_fn = model.loss_fn(params, batch)
    plain = _clone(params)
    _, _, pm = make_train_step(model, tc)(plain, adamw.init_state(plain),
                                          batch)
    step, _, (p_sh, o_sh, b_sh) = build_step(model, shape, tc, mesh)
    sp = shard_params(_clone(params), p_sh, mesh)
    zeros = adamw.init_state(params)
    opt = adamw.AdamWState(
        DTensor.from_local(zeros.step, mesh, o_sh.step, run_check=False),
        shard_params(zeros.mu, o_sh.mu, mesh),
        shard_params(zeros.nu, o_sh.nu, mesh))
    sb = shard_params({k: v.clone() for k, v in batch.items()}, b_sh, mesh)
    with implicit_replication():
        _, _, m = step(sp, opt, sb)
    split = sum(any(p.is_shard() for p in t.placements)
                for t in tree_leaves(sp))
    return dict(loss=float(_np(m["loss"])), loss_fn=float(_np(loss_fn)),
                plain_loss=float(_np(pm["loss"])),
                grad_norm=float(_np(m["grad_norm"])),
                plain_grad_norm=float(_np(pm["grad_norm"])),
                sharded_params=int(split))


def _rank_main(rank: int, world: int, tmp: Path) -> int:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    init_process_group("cpu", store=dist.FileStore(str(tmp / "store"),
                                                   world),
                       rank=rank, world_size=world, timeout_s=RANK_TIMEOUT_S)
    meshes = {name: make_host_mesh(model_axis=m, device="cpu")
              for name, m in MESHES.items()}
    out = {"decode": {}, "tails": {}, "train": {}}
    for arch, batch in DECODE:
        for name, mesh in meshes.items():
            out["decode"][f"{arch}-b{batch}-{name}"] = _decode_case(
                arch, batch, mesh)
    for arch in TAILS:
        for name, mesh in meshes.items():
            out["tails"][f"{arch}-{name}"] = _tail_case(arch, mesh)
    for arch in TRAIN:
        out["train"][arch] = _train_case(arch, meshes["2x2"])
    every = [None] * world
    dist.all_gather_object(every, out)
    if rank == 0:
        with open(tmp / "out.pkl", "wb") as f:
            pickle.dump(every, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]),
                        Path(sys.argv[3])))
