"""Parity of the port's fleet server with the reference's.

Both packages load one predictor-table file built by the reference's
calibration over the three codecs and serve the same request stream: the
reduced ResNet-50 with the reference's weights bridged in, on the CPU, four
heterogeneous edge profiles, three requests each, round robin, under
bandwidths that make the devices re-plan and share cloud groups.

Tolerances: the decision plane and the simulated clock are float64 numpy
in both packages, so plans, ``LatencyBreakdown``s, ``StageTimeline``s,
cloud groups, switch counts, makespans and synchronous times must be
equal. Logits are float32 model outputs: the port's fleet must equal its
own per-device synchronous server and its scalar (``vectorized=False``)
path with ``torch.equal``; against the reference they agree within
``RTOL`` of the logits' scale, because XLA and PyTorch sum the
convolutions in different orders (the bound of ``test_torch_cnn.py``).
``fuse_cloud_tail=True`` runs one tail forward per group, at another batch
size, and agrees within ``FUSED_RTOL`` (convolutions may pick another
algorithm per batch size).
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
from repro.config import types as jtypes  # noqa: E402
from repro.core.decoupler import DecoupledRunner as JRunner  # noqa: E402
from repro.core.decoupler import JaladEngine as JEngine  # noqa: E402
from repro.core.latency import LatencyModel as JLatency  # noqa: E402
from repro.core.predictor import PredictorTables as JTables  # noqa: E402
from repro.core.predictor import build_tables as jbuild_tables  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.serving.fleet import FleetRequest as JRequest  # noqa: E402
from repro.serving.fleet import FleetServer as JFleet  # noqa: E402
from repro_torch.config import JaladConfig, get_config  # noqa: E402
from repro_torch.config import types as ttypes  # noqa: E402
from repro_torch.core.decoupler import JaladEngine  # noqa: E402
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.core.predictor import PredictorTables  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving.edge_cloud import EdgeCloudServer  # noqa: E402
from repro_torch.serving.fleet import (  # noqa: E402
    FleetRequest,
    FleetServer,
    build_fleet_server,
)

from conftest import reduced_model  # noqa: E402

POINTS = [1, 4, 17, 18, 19]
BITS = (2, 8)
CODECS = ("huffman", "bitpack", "perchannel")
BATCH = 2
RTOL = 2e-5
FUSED_RTOL = 1e-4


def _profiles(types):
    return [types.EDGE_TX2, types.EDGE_TK1,
            types.DeviceProfile("edge-mid", 1e12, 1.30),
            types.DeviceProfile("edge-fast", 4e12, 0.90)]


# Per-round, per-device bandwidths: fast links, a collapse, fast again.
BWS = [[1e8, 3e8, 2e8, 1e8], [1e5, 3e5, 2e5, 1e5], [1e8, 3e8, 2e8, 1e8]]
ROUNDS, DEVICES = len(BWS), len(BWS[0])


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jmodel, jparams = reduced_model("resnet50")
    cfg = jmodel.cfg
    tables = jbuild_tables(jmodel, jparams, [jmake_batch(cfg, BATCH, 64,
                                                         seed=10)],
                           list(BITS), codecs=list(CODECS), points=POINTS)
    path = str(tmp_path_factory.mktemp("tables") / "tables.npz")
    tables.save(path)
    fmacs = jmodel.per_point_fmacs(BATCH)
    input_bytes = float(BATCH * 3 * cfg.image_size ** 2)
    jc = JJaladConfig(bits_choices=BITS, codec_choices=CODECS)
    tc = JaladConfig(bits_choices=BITS, codec_choices=CODECS)
    jeng = JEngine(jmodel, JTables.load(path),
                   JLatency(fmacs, jc.edge, jc.cloud, input_bytes), jc,
                   point_indices=POINTS)
    teng = JaladEngine(build_model(cfg), PredictorTables.load(path),
                       LatencyModel(fmacs, tc.edge, tc.cloud, input_bytes),
                       tc, point_indices=POINTS)
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    batches = [[jmake_batch(cfg, BATCH, 64, seed=300 + 10 * d + j)
                for d in range(DEVICES)] for j in range(ROUNDS)]
    return jeng, jparams, teng, tparams, batches


def _requests(cls, batches, devices=DEVICES):
    return [cls(uid=j * devices + d, device_id=d, batch=dict(batches[j][d]),
                bandwidth=BWS[j][d])
            for j in range(ROUNDS) for d in range(devices)]


@pytest.fixture(scope="module")
def served(shared):
    jeng, jparams, teng, tparams, batches = shared
    jfleet = JFleet(jeng, jparams, _profiles(jtypes), cloud_batch=3)
    tfleet = FleetServer(teng, tparams, _profiles(ttypes), cloud_batch=3)
    jdone = jfleet.serve(_requests(JRequest, batches))
    tdone = tfleet.serve(_requests(FleetRequest, batches))
    return jfleet, jdone, tfleet, tdone


def _plan(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


def _fields(port_obj, obj):
    """``obj``'s values of the fields the port's dataclass has (the
    reference's breakdown also carries the three-tier fields)."""
    return {f.name: getattr(obj, f.name)
            for f in dataclasses.fields(port_obj)}


def _groups(fleet):
    return [(g.key, g.uids) for g in fleet.cloud_groups]


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rtol * scale, (err, scale)


def test_fleet_matches_reference(served):
    jfleet, jdone, tfleet, tdone = served
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    for r, jr in zip(tdone, jdone):
        assert _plan(r.plan) == _plan(jr.plan)
        assert dataclasses.asdict(r.breakdown) == \
            _fields(r.breakdown, jr.breakdown)
        assert dataclasses.asdict(r.timeline) == \
            _fields(r.timeline, jr.timeline)
        assert tuple(r.logits.shape) == tuple(np.shape(jr.logits))
        _close(r.logits, jr.logits, RTOL)
    assert _groups(tfleet) == _groups(jfleet)
    assert tfleet.controller.switch_count() == \
        jfleet.controller.switch_count() >= 1
    assert tfleet.batched_launches() == jfleet.batched_launches() >= 1
    assert tfleet.makespan_s == jfleet.makespan_s
    assert tfleet.synchronous_time_s() == jfleet.synchronous_time_s()
    for d in range(DEVICES):
        assert tfleet.devices[d].clock == jfleet.devices[d].clock
        assert len(tfleet.devices[d].log) == len(jfleet.devices[d].log)
        assert [dataclasses.asdict(b) for b in tfleet.devices[d].log] == \
            [_fields(b, jb) for b, jb in zip(tfleet.devices[d].log,
                                             jfleet.devices[d].log)]
    codecs = {r.timeline.plan_codec for r in tdone}
    assert len(codecs) >= 2, codecs


def test_fleet_equals_per_device_synchronous_servers(shared, served):
    _, _, _, tparams, batches = shared
    _, _, tfleet, tdone = served
    by_uid = {r.uid: r for r in tdone}
    for d in range(DEVICES):
        dev = tfleet.devices[d]
        assert dev.engine.plan_space.size_flat is \
            tfleet.engine.plan_space.size_flat
        ref = EdgeCloudServer(dev.engine, tparams)
        for j in range(ROUNDS):
            logits, bd = ref.serve_batch(dict(batches[j][d]), BWS[j][d])
            r = by_uid[j * DEVICES + d]
            assert r.breakdown == bd
            assert torch.equal(r.logits, logits)
        assert dev.clock == ref.clock
        assert dev.log == ref.log
        assert _plan(dev.plan) == _plan(ref.controller.plan)


def test_vectorized_equals_scalar_path(shared, served):
    _, _, teng, tparams, batches = shared
    _, _, vec, done_v = served
    sca = FleetServer(teng, tparams, _profiles(ttypes), cloud_batch=3,
                      vectorized=False)
    done_s = sca.serve(_requests(FleetRequest, batches))
    assert [r.uid for r in done_s] == [r.uid for r in done_v]
    for rv, rs in zip(done_v, done_s):
        assert _plan(rv.plan) == _plan(rs.plan)
        assert rv.breakdown == rs.breakdown
        assert rv.timeline == rs.timeline
        assert torch.equal(rv.logits, rs.logits)
    assert _groups(sca) == _groups(vec)
    assert sca.makespan_s == vec.makespan_s
    for d in range(DEVICES):
        assert sca.devices[d].clock == vec.devices[d].clock
        assert sca.devices[d].log == vec.devices[d].log
        assert _plan(sca.devices[d].plan) == _plan(vec.devices[d].plan)
    assert sum(len(sca.devices[d].controller.history)
               for d in range(DEVICES)) >= DEVICES + 1


def test_fused_cloud_tail_agrees_within_float(shared, served):
    _, _, teng, tparams, batches = shared
    _, _, exact, done_e = served
    fused = FleetServer(teng, tparams, _profiles(ttypes), cloud_batch=3,
                        fuse_cloud_tail=True)
    done_f = fused.serve(_requests(FleetRequest, batches))
    assert fused.batched_launches() >= 1
    for re_, rf in zip(done_e, done_f):
        assert rf.breakdown == re_.breakdown
        assert rf.timeline == re_.timeline
        _close(rf.logits, re_.logits.numpy(), FUSED_RTOL)
    assert _groups(fused) == _groups(exact)


@pytest.mark.parametrize("codec", CODECS)
def test_cloud_step_batch_matches_reference(shared, codec):
    """One batched decode of reference-encoded blobs (different leading
    batch sizes included), tails per request and fused, against the
    reference's ``cloud_step_batch`` and the port's own ``cloud_step``."""
    jeng, jparams, teng, tparams, _ = shared
    cfg = teng.model.cfg
    plan = dataclasses.replace(teng.decide(1e8), point=17, bits=8,
                               codec=codec)
    jrunner = JRunner(jeng.model, jparams, plan)
    runner = teng.make_runner(tparams, plan)
    blobs = [jrunner.edge_step(jmake_batch(cfg, bsz, 64, seed=400 + i))[0]
             for i, bsz in enumerate((2, 1, 2))]
    want = jrunner.cloud_step_batch(blobs)
    got = runner.cloud_step_batch(blobs)
    fused = runner.cloud_step_batch(blobs, fuse_tail=True)
    assert len(got) == len(fused) == 3
    for blob, g, f, w in zip(blobs, got, fused, want):
        assert torch.equal(g, runner.cloud_step(blob))
        _close(g, w, RTOL)
        assert f.shape == g.shape
        _close(f, g.numpy(), FUSED_RTOL)
    assert runner.cloud_step_batch([]) == []
    one = runner.cloud_step_batch(blobs[:1], [None])
    assert torch.equal(one[0], got[0])


def test_empty_stream_and_bad_inputs(shared):
    _, _, teng, tparams, _ = shared
    for vectorized in (True, False):
        fleet = FleetServer(teng, tparams, _profiles(ttypes),
                            vectorized=vectorized)
        assert fleet.serve([]) == []
        assert fleet.makespan_s == 0.0
        assert fleet.synchronous_time_s() == 0.0
        assert fleet.batched_launches() == 0
        assert fleet.cloud_groups == []
        assert all(dev.clock == 0.0 and dev.log == []
                   for dev in fleet.devices)
    with pytest.raises(ValueError):
        FleetServer(teng, tparams, [])
    solo = FleetServer(teng, tparams, _profiles(ttypes)[:1])
    with pytest.raises(ValueError):
        solo.serve([FleetRequest(uid=0, device_id=3, batch=None,
                                 bandwidth=1e6)])
    # The meshed cloud is ported (tests/test_torch_meshed.py); what is not
    # a mesh is refused, by build_fleet_server before it calibrates.
    with pytest.raises(TypeError, match="DeviceMesh"):
        FleetServer(teng, tparams, _profiles(ttypes), cloud_mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_fleet_server(get_config("resnet50").reduced(), JaladConfig(),
                           _profiles(ttypes), cloud_mesh=object())
    # The token-streaming hooks are ported: a fleet with no attached
    # session steps nothing, and a session needs a plan.
    with pytest.raises(ValueError, match="DecoupledPlan"):
        solo.attach_stream(object())
    assert solo.step_streams() == 0
    assert solo.run_streams() == 0
    assert solo.stream_sessions == [] and solo.cloud_groups == []


def test_single_device_fleet_is_one_synchronous_server(shared):
    jeng, jparams, teng, tparams, batches = shared
    tfleet = FleetServer(teng, tparams, _profiles(ttypes)[:1])
    jfleet = JFleet(jeng, jparams, _profiles(jtypes)[:1])
    reqs = [(j, batches[j][0], BWS[j][0]) for j in range(ROUNDS)]
    done = tfleet.serve([FleetRequest(uid=j, device_id=0, batch=dict(b),
                                      bandwidth=bw) for j, b, bw in reqs])
    jdone = jfleet.serve([JRequest(uid=j, device_id=0, batch=dict(b),
                                   bandwidth=bw) for j, b, bw in reqs])
    ref = EdgeCloudServer(tfleet.devices[0].engine, tparams)
    by_uid = {r.uid: r for r in done}
    for j, b, bw in reqs:
        logits, bd = ref.serve_batch(dict(b), bw)
        assert by_uid[j].breakdown == bd
        assert torch.equal(by_uid[j].logits, logits)
    assert tfleet.devices[0].log == ref.log
    assert tfleet.makespan_s == jfleet.makespan_s > 0
    assert [dataclasses.asdict(r.timeline) for r in done] == \
        [_fields(r.timeline, jr.timeline) for r, jr in zip(done, jdone)]


def test_all_cloud_only_fleet(shared):
    """An unsatisfiable accuracy budget sends every request to the cloud
    whole: full forwards, no batched tail launches, both decision planes
    and the reference agree."""
    jeng, jparams, teng, tparams, batches = shared
    strict = dataclasses.replace(
        teng, cfg=dataclasses.replace(teng.cfg, accuracy_drop_budget=-1.0),
        _plan_space=None)
    jstrict = dataclasses.replace(
        jeng, cfg=dataclasses.replace(jeng.cfg, accuracy_drop_budget=-1.0),
        _plan_space=None)
    fleet = FleetServer(strict, tparams, _profiles(ttypes))
    done = fleet.serve(_requests(FleetRequest, batches))
    jfleet = JFleet(jstrict, jparams, _profiles(jtypes))
    jdone = jfleet.serve(_requests(JRequest, batches))
    assert len(done) == ROUNDS * DEVICES
    for r, jr in zip(done, jdone):
        assert r.breakdown.plan_point == -1 and r.breakdown.plan_bits == 0
        assert r.breakdown.plan_codec == "png"
        assert r.breakdown.edge_s == 0.0
        assert dataclasses.asdict(r.breakdown) == \
            _fields(r.breakdown, jr.breakdown)
        j, d = divmod(r.uid, DEVICES)
        assert torch.equal(r.logits,
                           fleet.runners.full_forward(batches[j][d]))
    assert fleet.batched_launches() == 0
    assert all(g.key is None for g in fleet.cloud_groups)
    assert fleet.makespan_s == jfleet.makespan_s > 0
    scalar = FleetServer(strict, tparams, _profiles(ttypes),
                         vectorized=False)
    done_s = {r.uid: r for r in scalar.serve(_requests(FleetRequest,
                                                       batches))}
    for r in done:
        assert done_s[r.uid].breakdown == r.breakdown
