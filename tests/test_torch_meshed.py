"""Parity of the port's meshed cloud (``serving/meshed.py``, the sharded
wire decode, ``launch/mesh.py``, ``FleetServer(cloud_mesh=...)``) with the
reference's.

Two layers, as the reference's ``tests/test_meshed.py``:

* In-process, on a one-rank ``gloo`` mesh ``(1, 1)``: the worker against
  the reference's single-device fused tail on the same blobs and weights
  (bridged), a group of three, the groups it declines, the sharded wire
  and codes decodes byte-identical per blob, and no second copy of the
  weights (every local shard shares storage with its parameter).

* Four ``gloo`` ranks: this file run as a script, one process a rank,
  joined through a ``FileStore``. The parent writes the bridged weights
  (``torch.save``), the reference's calibration tables and the requests
  once, so the ranks do not calibrate four times; each rank serves the
  same requests through ``FleetServer(cloud_mesh=...)`` on a (2, 2)
  mesh, reduced ``granite-34b`` and ``resnet50``, 2 waves x 4 edges, with
  a collective term so the mesh model changes the planner's cloud times.
  The golden is the reference's ``FleetServer`` over
  ``engine.with_cloud_mesh(CloudMeshModel(4, coll))`` with
  ``fuse_cloud_tail=True`` on one device: plans, breakdowns and bytes
  equal, logits within the reference's ``RTOL, ATOL``. Every rank's
  plans and logits agree bit for bit (an all-gathered digest). The ranks
  also run the Huffman codes path and the generic (per-channel) path once
  each on the (2, 2) mesh, a group of three padded to four, and the
  sharded decodes on a (4, 1) mesh.

Tolerances: ``RTOL, ATOL = 2e-4, 2e-5``, the reference's own between its
meshed and single-device tails (a sharded forward sums in other orders),
and the difference also within RTOL of the logits' scale.
A mesh of one replicates every placement, so there the worker equals the
port's own fused tail bit for bit.
"""
import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
# A rank of the four-rank run takes one.
torch.set_num_threads(1 if __name__ == "__main__" else 2)

RTOL, ATOL = 2e-4, 2e-5
SEQ = 16
BW = 3e5
WORLD = 4
# Planner-side seconds a remaining layer, for the mesh model: at BW it
# moves every ResNet-50 request's cut from stem_pool (point 1, unmeshed)
# to res3_2 (point 10), so convolutions run on the mesh; granite-34b cuts
# after its first block, so a whole block does.
COLL = 1e-4
POINTS = {"granite-34b": [0], "resnet50": [1, 4, 10]}
# Every collective of a rank fails after this, instead of hanging.
RANK_TIMEOUT_S = 120.0
SUBPROCESS_TIMEOUT_S = 300
ROOT = Path(__file__).resolve().parent.parent


def _jalad(cls):
    return cls(bits_choices=(4, 8), codec_choices=("bitpack",),
               accuracy_drop_budget=0.5, bandwidth_bytes_per_s=1e6)


def _profiles(types):
    return [types.EDGE_TX2, types.EDGE_TK1, types.EDGE_TX2, types.EDGE_TK1]


def _plan(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


def _as(cls, blob):
    return cls(**{f.name: getattr(blob, f.name)
                  for f in dataclasses.fields(cls)})


def _close(got, want):
    """Within the reference's RTOL / ATOL, and within RTOL of the logits'
    scale: a reduced ResNet-50's random weights give logits of ~1e-7,
    which ATOL alone would not hold."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= RTOL * scale


def _bits(t):
    """A tensor's bytes (bit-level comparisons: -0.0 is not +0.0)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


# ---------------------------------------------------------------------------
# In-process: one rank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    started = not dist.is_initialized()
    assert init_process_group("cpu") == (0, 1)
    yield make_host_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def granite():
    import jax

    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_from_numpy

    from conftest import reduced_model

    jmodel, jparams = reduced_model("granite-34b")
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    return jmodel, jparams, build_model(jmodel.cfg), tparams


def _group(tmodel, tparams, n, codec="bitpack", bits=8, point=0):
    from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
    from repro_torch.data.synthetic import make_batch

    plan = DecoupledPlan(point, bits, 0.0, 0.0, 0.0, codec=codec)
    runner = DecoupledRunner(tmodel, tparams, plan)
    pairs = [runner.edge_step(make_batch(tmodel.cfg, 1, SEQ, seed=40 + i))
             for i in range(n)]
    return plan, [p[0] for p in pairs], [p[1] for p in pairs]


def _ref_fused(jmodel, jparams, plan, blobs):
    from repro.codec import WireBlob as JBlob
    from repro.core.decoupler import DecoupledPlan as JPlan
    from repro.core.decoupler import DecoupledRunner as JRunner

    jplan = JPlan(plan.point, plan.bits, 0.0, 0.0, 0.0, codec=plan.codec)
    # The reference's text-family head returns its positions beside the
    # boundary (the port's tail rebuilds them from the boundary's shape).
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None], (1, SEQ))
    extras = [{"positions": pos, "enc_out": None, "pos3d": None}
              for _ in blobs]
    return [np.asarray(o, np.float32) for o in JRunner(
        jmodel, jparams, jplan).cloud_step_batch(
            [_as(JBlob, b) for b in blobs], extras, fuse_tail=True)]


@pytest.mark.parametrize("codec", ["bitpack", "huffman", "perchannel"])
def test_worker_matches_reference_fused_tail(mesh1, granite, codec):
    from repro_torch.core.decoupler import DecoupledRunner
    from repro_torch.serving.meshed import MeshedCloudWorker

    jmodel, jparams, tmodel, tparams = granite
    plan, blobs, extras = _group(tmodel, tparams, 4, codec)
    worker = MeshedCloudWorker(tmodel, tparams, mesh1)
    outs = DecoupledRunner(tmodel, tparams, plan,
                           mesh_worker=worker).cloud_step_batch(blobs, extras)
    assert worker.fused_calls == 1 and worker.group_sizes == [4]
    refs = _ref_fused(jmodel, jparams, plan, blobs)
    plain = DecoupledRunner(tmodel, tparams, plan).cloud_step_batch(
        blobs, extras, fuse_tail=True)
    for out, ref, own in zip(outs, refs, plain):
        assert type(out) is torch.Tensor
        _close(out.numpy(), ref)
        assert torch.equal(out, own)


def test_worker_pads_a_group_of_three(mesh1, granite):
    from repro_torch.core.decoupler import DecoupledRunner
    from repro_torch.serving.meshed import MeshedCloudWorker, _tile_to

    jmodel, jparams, tmodel, tparams = granite
    plan, blobs, extras = _group(tmodel, tparams, 3)
    worker = MeshedCloudWorker(tmodel, tparams, mesh1)
    outs = DecoupledRunner(tmodel, tparams, plan,
                           mesh_worker=worker).cloud_step_batch(blobs, extras)
    assert [o.shape[0] for o in outs] == [1, 1, 1]
    for out, ref in zip(outs, _ref_fused(jmodel, jparams, plan, blobs)):
        _close(out.numpy(), ref)
    a = np.arange(6).reshape(3, 2)
    assert _tile_to(a, 4).tolist() == [[0, 1], [2, 3], [4, 5], [0, 1]]
    assert torch.equal(_tile_to(torch.from_numpy(a), 5),
                       torch.from_numpy(a[[0, 1, 2, 0, 1]]))
    assert _tile_to(a, 3) is a


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_worker_stacks_extras(mesh1, arch):
    """A vlm's and an audio model's extras (positions, M-RoPE ids, the
    encoder output) batch into the one meshed forward: each request
    equals its own per-request cloud step."""
    from repro_torch.config import get_config
    from repro_torch.core.decoupler import DecoupledRunner
    from repro_torch.models.api import build_model
    from repro_torch.serving.meshed import MeshedCloudWorker

    model = build_model(get_config(arch).reduced())
    params = model.init(0, "cpu")
    plan, blobs, extras = _group(model, params, 3, point=1)
    assert all(isinstance(e, dict) for e in extras)
    worker = MeshedCloudWorker(model, params, mesh1)
    runner = DecoupledRunner(model, params, plan, mesh_worker=worker)
    outs = runner.cloud_step_batch(blobs, extras)
    assert worker.fused_calls == 1 and worker.group_sizes == [3]
    plain = DecoupledRunner(model, params, plan)
    for blob, e, out in zip(blobs, extras, outs):
        _close(out.numpy(), plain.cloud_step(blob, e).numpy())


def test_worker_declines_unshardable_groups(mesh1, granite):
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.serving.meshed import MeshedCloudWorker

    _, _, tmodel, tparams = granite
    plan, blobs, extras = _group(tmodel, tparams, 4)
    worker = MeshedCloudWorker(tmodel, tparams, mesh1)
    assert worker.try_cloud_step_batch([], [], plan) is None
    cloud_only = DecoupledPlan(-1, 0, 0.0, 0.0, 0.0)
    assert worker.try_cloud_step_batch(blobs, extras, cloud_only) is None
    mixed = [blobs[0], dataclasses.replace(blobs[1], codec="huffman")]
    assert worker.try_cloud_step_batch(mixed, extras[:2], plan) is None
    other = [blobs[0], dataclasses.replace(blobs[1], shape=(1, 8, 256))]
    assert worker.try_cloud_step_batch(other, extras[:2], plan) is None
    # Extras on some requests only, or of another batch, do not stack.
    x = {"positions": torch.zeros((1, SEQ), dtype=torch.int64)}
    assert worker.try_cloud_step_batch(blobs[:2], [x, None], plan) is None
    y = {"positions": torch.zeros((2, SEQ), dtype=torch.int64)}
    assert worker.try_cloud_step_batch(blobs[:2], [x, y], plan) is None
    assert worker.fused_calls == 0


@pytest.mark.parametrize("codec,bits", [("bitpack", 6), ("bitpack", 3),
                                        ("huffman", 5)])
def test_sharded_decode_identity(mesh1, codec, bits):
    from repro.codec import WireBlob as JBlob
    from repro.codec import get_codec as jget_codec
    from repro_torch.codec import get_codec
    from repro_torch.core import entropy as ent
    from repro_torch.kernels.quantize import ops

    tc = get_codec(codec)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.normal(size=(2, 5, 9)).astype(np.float32))
          for _ in range(4)]
    blobs = [tc.encode(x, bits) for x in xs]
    mn = np.stack([np.float32(b.x_min) for b in blobs])
    mx = np.stack([np.float32(b.x_max) for b in blobs])
    if codec == "bitpack":
        codes = np.stack([tc._wire_codes(b) for b in blobs])
        out = ops.dequantize_wire_batch_sharded(codes, mn, mx, bits,
                                                blobs[0].shape, mesh1)
    else:
        codes = np.stack([ent.huffman_decode(b.payload).astype(np.uint8)
                          for b in blobs])
        out = ops.dequantize_codes_batch_sharded(
            torch.from_numpy(codes), mn, mx, bits, blobs[0].shape, mesh1)
    assert out.placements[0].is_shard(0) and out.shape == (4, 2, 5, 9)
    local = out.to_local()
    for i, b in enumerate(blobs):
        assert _bits(local[i]) == _bits(tc.decode(b, device="cpu"))
        ref = np.asarray(jget_codec(codec).decode(_as(JBlob, b)), np.float32)
        assert _bits(local[i]) == ref.tobytes()
    with pytest.raises(ValueError, match="no 'pod'"):
        ops.dequantize_wire_batch_sharded(codes, mn, mx, bits, (2, 5, 9),
                                          mesh1, batch_axis="pod")


def test_mesh_of_one_holds_no_weight_copy(mesh1, granite):
    from repro_torch.serving.meshed import MeshedCloudWorker
    from repro_torch.utils.tree import tree_leaves

    _, _, tmodel, tparams = granite
    worker = MeshedCloudWorker(tmodel, tparams, mesh1)
    pairs = list(zip(tree_leaves(tparams), tree_leaves(worker.params)))
    assert pairs
    for p, d in pairs:
        local = d.to_local()
        assert d.shape == p.shape and local.shape == p.shape
        assert local.untyped_storage().data_ptr() == \
            p.untyped_storage().data_ptr()
        assert local.data_ptr() == p.data_ptr()


def test_host_mesh_and_process_group(mesh1):
    from repro_torch.launch.mesh import (
        init_process_group,
        make_host_mesh,
        make_production_mesh,
    )
    from repro_torch.serving.meshed import mesh_size

    assert mesh1.mesh_dim_names == ("data", "model")
    assert tuple(mesh1.shape) == (1, 1) and mesh_size(mesh1) == 1
    assert init_process_group("cpu") == (0, 1)
    with pytest.raises(RuntimeError, match=r"\(16, 16\) needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) needs 512"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model_axis=2, device="cpu")


def test_engine_with_cloud_mesh_matches_reference(granite):
    from repro.config import JaladConfig as JJaladConfig
    from repro.core.decoupler import JaladEngine as JEngine
    from repro.core.latency import CloudMeshModel as JMesh
    from repro.core.latency import LatencyModel as JLatency
    from repro.core.predictor import PredictorTables as JTables
    from repro_torch.config import JaladConfig
    from repro_torch.core.decoupler import JaladEngine
    from repro_torch.core.latency import CloudMeshModel, LatencyModel
    from repro_torch.core.predictor import PredictorTables

    jmodel, _, tmodel, _ = granite
    n = len(tmodel.decoupling_points())
    rng = np.random.default_rng(0)
    acc = rng.uniform(0, 0.3, (n, 2, 1))
    size = rng.uniform(1e3, 1e5, (n, 2, 1))
    fmacs = tmodel.per_point_fmacs(2, SEQ)
    jc, tc = _jalad(JJaladConfig), _jalad(JaladConfig)
    tables = dict(points=tmodel.decoupling_points(), bits_choices=[4, 8],
                  codecs=["bitpack"], acc_drop=acc, size_bytes=size,
                  base_accuracy=0.9)
    jeng = JEngine(jmodel, JTables(**tables),
                   JLatency(fmacs, jc.edge, jc.cloud, 128.0), jc)
    teng = JaladEngine(tmodel, PredictorTables(**tables),
                       LatencyModel(fmacs, tc.edge, tc.cloud, 128.0), tc)
    jm = jeng.with_cloud_mesh(JMesh(4, COLL))
    tm = teng.with_cloud_mesh(CloudMeshModel(4, COLL))
    assert tm.cloud_mesh == CloudMeshModel(4, COLL)
    assert np.array_equal(tm.plan_space.cloud_vec, jm.plan_space.cloud_vec)
    assert not np.array_equal(tm.plan_space.cloud_vec,
                              teng.plan_space.cloud_vec)
    assert np.array_equal(tm.tri_space.cl_vec, jm.tri_space.cl_vec)
    # An engine whose tri space was built before the mesh gets it too.
    teng.tri_space
    jeng.tri_space
    assert np.array_equal(
        teng.with_cloud_mesh(CloudMeshModel(4, COLL)).tri_space.cl_vec,
        jeng.with_cloud_mesh(JMesh(4, COLL)).tri_space.cl_vec)
    for bw in (1e4, 3e5, 1e8):
        assert _plan(tm.decide(bw)) == _plan(jm.decide(bw))
    edge = tm.for_edge(tc.edge)
    assert np.array_equal(edge.plan_space.cloud_vec, tm.plan_space.cloud_vec)


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------


def _case(arch, tmp):
    """The reference's calibrated engine for reduced ``arch`` (the recipe
    of its meshed test: one batch of 2 x SEQ, at the points of POINTS),
    its golden fleet run, the cuts its unmeshed engine picks, and what a
    rank needs to build the same engine."""
    import jax

    from repro.config import JaladConfig as JJaladConfig
    from repro.config import types as jtypes
    from repro.core.latency import CloudMeshModel as JMesh
    from repro.data.synthetic import make_batch as jmake_batch
    from repro.serving.edge_cloud import build_edge_cloud_server
    from repro.serving.fleet import FleetRequest as JRequest
    from repro.serving.fleet import FleetServer as JFleet
    from repro_torch.models.bridge import params_from_numpy

    from conftest import reduced_model

    jmodel, jparams = reduced_model(arch)
    cfg = jmodel.cfg
    srv, _ = build_edge_cloud_server(cfg, _jalad(JJaladConfig),
                                     calib_batches=1, calib_batch_size=2,
                                     seq_len=SEQ, params=jparams,
                                     points=POINTS[arch])
    eng = srv.engine
    tables = str(tmp / f"tables-{arch}.npz")
    eng.tables.save(tables)
    params = str(tmp / f"params-{arch}.pt")
    torch.save(params_from_numpy(jax.device_get(jparams), "cpu"), params)
    batches = [jmake_batch(cfg, 1, SEQ, seed=u) for u in range(8)]
    golden = JFleet(eng.with_cloud_mesh(JMesh(WORLD, COLL)), jparams,
                    _profiles(jtypes), fuse_cloud_tail=True).serve(
        [JRequest(uid=u, device_id=u % 4, batch=dict(batches[u]),
                  bandwidth=BW) for u in range(8)])
    unmeshed = {eng.for_edge(p).decide(BW).point for p in _profiles(jtypes)}
    case = dict(arch=arch, tables=tables, params=params, batches=batches,
                points=eng.point_indices,
                fmacs=list(eng.latency.fmacs_per_point),
                input_bytes=float(eng.latency.input_bytes))
    return case, (golden, unmeshed)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks; returns (rank 0's results, the goldens, the
    reference's fused tails of rank 0's codec-path groups)."""
    tmp = tmp_path_factory.mktemp("meshed")
    cases, goldens = [], {}
    for arch in ("granite-34b", "resnet50"):
        case, goldens[arch] = _case(arch, tmp)
        cases.append(case)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
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
        out = pickle.load(f)
    return out, goldens


@pytest.mark.parametrize("arch", ["granite-34b", "resnet50"])
def test_four_ranks_fleet_matches_reference_golden(ranks, arch):
    out, goldens = ranks
    got, (golden, unmeshed) = out["fleets"][arch], goldens[arch]
    assert got["uids"] == [r.uid for r in golden]
    for i, r in enumerate(golden):
        assert got["plans"][i] == _plan(r.plan)
        bd = got["breakdowns"][i]
        assert bd == {k: getattr(r.breakdown, k) for k in bd}
        assert bd["bytes_sent"] == r.breakdown.bytes_sent
        _close(got["logits"][i], r.logits)
    assert got["fused_calls"] >= 1
    assert max(got["group_sizes"]) >= 8, got["group_sizes"]
    # The collective term priced the cloud side: the meshed vector is
    # not the single-device one, and ResNet-50's cut moved.
    assert got["cloud_vec_meshed"] != got["cloud_vec_single"]
    assert {p[0] for p in got["plans"]} == {POINTS[arch][-1]}
    if arch == "resnet50":
        assert unmeshed == {1}


def test_four_ranks_agree_bit_for_bit(ranks):
    out, _ = ranks
    assert len(out["digests"]) == WORLD
    assert len(set(out["digests"])) == 1, out["digests"]


@pytest.mark.parametrize("codec", ["huffman", "perchannel"])
def test_four_ranks_codec_paths_match_reference(ranks, granite, codec):
    out, _ = ranks
    jmodel, jparams, _, _ = granite
    got = out["codec_paths"][codec]
    assert got["fused_calls"] == 1 and got["group_sizes"] == [4]
    refs = _ref_fused(jmodel, jparams, got["plan"], got["blobs"])
    for a, b in zip(got["logits"], refs):
        _close(a, b)


def test_four_ranks_sharded_decode_and_padding(ranks, granite):
    out, _ = ranks
    dec = out["decode"]
    # Each rank held two of the eight rows; gathered, they are every
    # blob's own decode, byte for byte.
    assert dec["local_rows"] == 2 and dec["equal"] == [True] * 8
    assert dec["codes_equal"] == [True] * 8
    pad = out["padded"]
    assert pad["group_sizes"] == [3] and pad["shapes"] == [1, 1, 1]
    jmodel, jparams, _, _ = granite
    refs = _ref_fused(jmodel, jparams, pad["plan"], pad["blobs"])
    for a, b in zip(pad["logits"], refs):
        _close(a, b)


# ---------------------------------------------------------------------------
# A rank of the four-rank run (this file as a script)
# ---------------------------------------------------------------------------


def _serve_case(case, mesh):
    from repro_torch.config import JaladConfig, get_config
    from repro_torch.config import types as ttypes
    from repro_torch.core.decoupler import JaladEngine
    from repro_torch.core.latency import LatencyModel
    from repro_torch.core.predictor import PredictorTables
    from repro_torch.models.api import build_model
    from repro_torch.serving.fleet import FleetRequest, FleetServer

    tc = _jalad(JaladConfig)
    engine = JaladEngine(
        build_model(get_config(case["arch"]).reduced()),
        PredictorTables.load(case["tables"]),
        LatencyModel(case["fmacs"], tc.edge, tc.cloud, case["input_bytes"]),
        tc, point_indices=case["points"])
    params = torch.load(case["params"])
    fleet = FleetServer(engine, params, _profiles(ttypes), cloud_mesh=mesh,
                        cloud_collective_s=COLL)
    done = fleet.serve([FleetRequest(uid=u, device_id=u % 4,
                                     batch=dict(b), bandwidth=BW)
                        for u, b in enumerate(case["batches"])])
    return dict(
        uids=[r.uid for r in done], plans=[_plan(r.plan) for r in done],
        breakdowns=[dataclasses.asdict(r.breakdown) for r in done],
        logits=[r.logits.numpy() for r in done],
        fused_calls=fleet.mesh_worker.fused_calls,
        group_sizes=list(fleet.mesh_worker.group_sizes),
        cloud_vec_meshed=fleet.engine.plan_space.cloud_vec.tolist(),
        cloud_vec_single=engine.plan_space.cloud_vec.tolist()), params


def _worker_group(model, params, mesh, n, codec):
    from repro_torch.core.decoupler import DecoupledRunner
    from repro_torch.serving.meshed import MeshedCloudWorker

    worker = MeshedCloudWorker(model, params, mesh)
    plan, blobs, extras = _group(model, params, n, codec)
    outs = DecoupledRunner(model, params, plan,
                           mesh_worker=worker).cloud_step_batch(blobs, extras)
    return dict(plan=plan, blobs=blobs, logits=[o.numpy() for o in outs],
                shapes=[o.shape[0] for o in outs],
                fused_calls=worker.fused_calls,
                group_sizes=list(worker.group_sizes))


def _sharded_decodes(mesh):
    """Eight blobs decoded over a (4, 1) mesh, every rank two rows; the
    gathered rows against each blob's own decode."""
    import torch.distributed as dist

    from repro_torch.codec import get_codec
    from repro_torch.core import entropy as ent
    from repro_torch.kernels.quantize import ops

    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(4, 6, 10)).astype(np.float32))
          for _ in range(8)]
    out = {}
    for codec, key in (("bitpack", "equal"), ("huffman", "codes_equal")):
        tc = get_codec(codec)
        blobs = [tc.encode(x, 5) for x in xs]
        mn = np.stack([np.float32(b.x_min) for b in blobs])
        mx = np.stack([np.float32(b.x_max) for b in blobs])
        if codec == "bitpack":
            got = ops.dequantize_wire_batch_sharded(
                np.stack([tc._wire_codes(b) for b in blobs]), mn, mx, 5,
                blobs[0].shape, mesh)
        else:
            got = ops.dequantize_codes_batch_sharded(
                np.stack([ent.huffman_decode(b.payload).astype(np.uint8)
                          for b in blobs]), mn, mx, 5, blobs[0].shape, mesh)
        local = got.to_local()
        out["local_rows"] = int(local.shape[0])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local.contiguous())
        full = torch.cat(parts)
        assert torch.equal(full, got.full_tensor())
        out[key] = [_bits(full[i]) == _bits(tc.decode(b, device="cpu"))
                    for i, b in enumerate(blobs)]
    return out


def _rank_main(rank: int, world: int, tmp: Path) -> int:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.api import build_model
    from repro_torch.config import get_config

    init_process_group("cpu", store=dist.FileStore(str(tmp / "store"),
                                                   world),
                       rank=rank, world_size=world, timeout_s=RANK_TIMEOUT_S)
    mesh22 = make_host_mesh(model_axis=2, device="cpu")
    mesh41 = make_host_mesh(model_axis=1, device="cpu")
    with open(tmp / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    out = {"fleets": {}, "codec_paths": {}}
    for case in cases:
        out["fleets"][case["arch"]], params = _serve_case(case, mesh22)
        if case["arch"] == "granite-34b":
            model = build_model(get_config("granite-34b").reduced())
            for codec in ("huffman", "perchannel"):
                out["codec_paths"][codec] = _worker_group(
                    model, params, mesh22, 4, codec)
            out["padded"] = _worker_group(model, params, mesh41, 3,
                                          "bitpack")
    out["decode"] = _sharded_decodes(mesh41)
    # Every rank's plans and logits, bit for bit.
    h = hashlib.sha256()
    for arch in sorted(out["fleets"]):
        got = out["fleets"][arch]
        h.update(repr(got["plans"]).encode())
        for lg in got["logits"]:
            h.update(lg.tobytes())
    for codec in sorted(out["codec_paths"]):
        for lg in out["codec_paths"][codec]["logits"]:
            h.update(lg.tobytes())
    digests = [None] * world
    dist.all_gather_object(digests, h.hexdigest())
    out["digests"] = digests
    if rank == 0:
        with open(tmp / "out.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]),
                        Path(sys.argv[3])))
