"""Parity of the port's decision and serving layers with the reference.

One predictor-table file built by the reference's calibration is loaded by
both packages. On it, the port's ``JaladEngine.decide`` picks the same
(point, bits, codec) with bitwise-equal predicted latencies at every
bandwidth, and the port's ``EdgeCloudServer.serve_trace`` (reference
weights bridged in, run on the CPU) gives the same plan sequence and the
same ``LatencyBreakdown``s under one bandwidth trace. The port's own
calibration is compared where its inputs are identical: fixed-rate sizes
and the shape of the tables.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.config import JaladConfig as JJaladConfig  # noqa: E402
from repro.core.decoupler import JaladEngine as JEngine  # noqa: E402
from repro.core.latency import LatencyModel as JLatency  # noqa: E402
from repro.core.predictor import PredictorTables as JTables  # noqa: E402
from repro.core.predictor import build_tables as jbuild_tables  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.serving.edge_cloud import EdgeCloudServer as JServer  # noqa: E402
from repro_torch.config import JaladConfig  # noqa: E402
from repro_torch.core.decoupler import JaladEngine  # noqa: E402
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.core.predictor import PredictorTables, build_tables  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving.edge_cloud import (  # noqa: E402
    EdgeCloudServer,
    build_edge_cloud_server,
)

from conftest import reduced_model  # noqa: E402

POINTS = [0, 1, 4, 9, 17, 18, 19]
BITS = (2, 4, 8)
CODECS = ("huffman", "bitpack", "perchannel")
BATCH = 4
TRACE = [3e4, 3e5, 3e6, 3e7, 3e8, 3e9, 3e5, 1e4]


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jmodel, jparams = reduced_model("resnet50")
    cfg = jmodel.cfg
    batches = [jmake_batch(cfg, BATCH, 64, seed=10)]
    tables = jbuild_tables(jmodel, jparams, batches, list(BITS),
                           codecs=list(CODECS), points=POINTS)
    path = str(tmp_path_factory.mktemp("tables") / "tables.npz")
    tables.save(path)
    return jmodel, jparams, batches, path


def _engines(shared, codecs=CODECS):
    jmodel, _, _, path = shared
    cfg = jmodel.cfg
    fmacs = jmodel.per_point_fmacs(BATCH)
    input_bytes = float(BATCH * 3 * cfg.image_size ** 2)
    jt = JTables.load(path)
    tt = PredictorTables.load(path)
    if codecs != CODECS:
        k = jt.codec_index(codecs[0])
        jt = dataclasses.replace(jt, codecs=list(codecs),
                                 acc_drop=jt.acc_drop[:, :, k:k + 1],
                                 size_bytes=jt.size_bytes[:, :, k:k + 1])
        tt = dataclasses.replace(tt, codecs=list(codecs),
                                 acc_drop=tt.acc_drop[:, :, k:k + 1],
                                 size_bytes=tt.size_bytes[:, :, k:k + 1])
    jc = JJaladConfig(bits_choices=BITS, codec_choices=codecs)
    tc = JaladConfig(bits_choices=BITS, codec_choices=codecs)
    jeng = JEngine(jmodel, jt, JLatency(fmacs, jc.edge, jc.cloud,
                                        input_bytes), jc,
                   point_indices=POINTS)
    teng = JaladEngine(build_model(cfg), tt,
                       LatencyModel(fmacs, tc.edge, tc.cloud, input_bytes),
                       tc, point_indices=POINTS)
    return jeng, teng


def _plan(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


def test_tables_round_trip_between_packages(shared, tmp_path):
    path = shared[3]
    tt = PredictorTables.load(path)
    jt = JTables.load(path)
    assert tt.points == jt.points and tt.codecs == jt.codecs
    np.testing.assert_array_equal(tt.size_bytes, jt.size_bytes)
    tt.save(str(tmp_path / "again"))
    back = JTables.load(str(tmp_path / "again"))
    np.testing.assert_array_equal(back.acc_drop, jt.acc_drop)
    assert PredictorTables.cache_key("a", BITS, CODECS, POINTS, seed=1) == \
        JTables.cache_key("a", BITS, CODECS, POINTS, seed=1)


def test_decide_matches_reference_bitwise(shared):
    jeng, teng = _engines(shared)
    for bw in np.logspace(3, 10, 29):
        for method in ("planner", "enumeration", "bnb"):
            assert _plan(teng.decide(bw, method)) == \
                _plan(jeng.decide(bw, method))
    np.testing.assert_array_equal(teng.plan_space.base,
                                  jeng.plan_space.base)


@pytest.mark.parametrize("codecs", [CODECS, ("huffman",), ("bitpack",),
                                    ("perchannel",)])
def test_serve_trace_matches_reference(shared, codecs):
    jmodel, jparams, _, _ = shared
    jeng, teng = _engines(shared, codecs)
    jserver = JServer(jeng, jparams)
    tserver = EdgeCloudServer(teng, params_from_numpy(
        jax.device_get(jparams), "cpu"))
    items = [jmake_batch(jmodel.cfg, BATCH, 64, seed=50 + i)
             for i in range(len(TRACE))]
    want = [dataclasses.asdict(b) for b in jserver.serve_trace(items, TRACE)]
    got = [dataclasses.asdict(b) for b in tserver.serve_trace(items, TRACE)]
    # The reference's three-tier fields stay at their two-tier defaults.
    extra = {"edge_server_s": 0.0, "transfer2_s": 0.0, "bytes_sent2": 0,
             "plan_point2": -1, "plan_bits2": 0, "plan_codec2": ""}
    assert [{**b, **extra} for b in got] == want
    assert tserver.clock == jserver.clock
    assert [(e.step, e.bandwidth, _plan(e.new_plan))
            for e in tserver.controller.history] == \
        [(e.step, e.bandwidth, _plan(e.new_plan))
         for e in jserver.controller.history]
    assert any(b["plan_point"] >= 0 for b in got)


def test_port_calibration_on_the_same_weights(shared):
    jmodel, jparams, batches, path = shared
    jt = JTables.load(path)
    model = build_model(jmodel.cfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    tt = build_tables(model, params, batches, list(BITS),
                      codecs=list(CODECS), points=POINTS)
    assert tt.points == jt.points
    assert tt.acc_drop.shape == jt.acc_drop.shape
    for fixed_rate in ("bitpack", "perchannel"):
        k = jt.codec_index(fixed_rate)
        np.testing.assert_array_equal(tt.size_bytes[:, :, k],
                                      jt.size_bytes[:, :, k])
    assert ((tt.acc_drop >= 0) & (tt.acc_drop <= 1)).all()
    assert tt.base_accuracy == jt.base_accuracy


def test_factory_builds_a_cpu_server_and_serves():
    from repro_torch.config import get_config

    cfg = get_config("vgg16").reduced()
    jc = JaladConfig(bits_choices=(4, 8), codec_choices=CODECS)
    server, params = build_edge_cloud_server(
        cfg, jc, calib_batches=1, calib_batch_size=2, points=[3, 10, 20],
        device="cpu")
    assert params["conv1"]["w"].device.type == "cpu"
    logits, bd = server.serve_batch(make_batch(cfg, 2, 64, seed=1), 3e5)
    assert tuple(logits.shape) == (2, cfg.num_classes)
    assert bd.plan_codec in CODECS + ("png",)
