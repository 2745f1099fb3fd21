"""Parity of the port's three-tier serving path with the reference's.

Both packages load one predictor-table file built by the reference's
calibration over the three codecs and serve the same request stream: the
reduced ResNet-50 with the reference's weights bridged in, on the CPU,
three devices (TX2, TK1 and a mid edge) behind one edge server and one
cloud, with the per-device uplink and backhaul bandwidths of
``tests/test_three_tier_serving.py``, two requests a device, batch 4.

Tolerances: the decision plane and the simulated clock are float64 numpy
in both packages, so plans, ``LatencyBreakdown``s (the three-tier fields
included), ``TriStageTimeline``s, makespans and synchronous times must be
equal. Logits are float32 model outputs and agree within ``RTOL`` of
their scale (``test_torch_cnn.py``'s bound: XLA and PyTorch sum the
convolutions in different orders).

Wire blobs: the two packages' forwards differ in the last float bits, so
a range header computed from each package's own activation may differ by
an ulp. The blobs are therefore held at the same boundary tensor: the
reference's activation at the first cut encodes to the same bytes in both
packages; the port's edge-server step equals the port's decode (bit-exact
against the reference's), its segment, and an encode that gives the
reference's bytes for the same segment output; a relay passes the very
blob of the two-tier runner on.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.codec import get_codec as jget_codec  # noqa: E402
from repro.config import JaladConfig as JJaladConfig  # noqa: E402
from repro.config import types as jtypes  # noqa: E402
from repro.core.decoupler import DecoupledPlan as JPlan  # noqa: E402
from repro.core.decoupler import JaladEngine as JEngine  # noqa: E402
from repro.core.decoupler import TriDecoupledRunner as JTriRunner  # noqa: E402
from repro.core.latency import LatencyModel as JLatency  # noqa: E402
from repro.core.predictor import PredictorTables as JTables  # noqa: E402
from repro.core.predictor import build_tables as jbuild_tables  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.serving.edge_cloud import EdgeCloudServer as JServer  # noqa: E402
from repro.serving.fleet import FleetRequest as JRequest  # noqa: E402
from repro.serving.three_tier import ThreeTierServer as JThree  # noqa: E402
from repro.serving.workloads import make_trace as jmake_trace  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.config import JaladConfig  # noqa: E402
from repro_torch.config import types as ttypes  # noqa: E402
from repro_torch.core.decoupler import (  # noqa: E402
    DecoupledPlan,
    DecoupledRunner,
    JaladEngine,
    TriDecoupledRunner,
)
from repro_torch.core.latency import PNG_RATIO, LatencyModel  # noqa: E402
from repro_torch.core.predictor import PredictorTables  # noqa: E402
from repro_torch.models.api import batch_to, build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EdgeCloudServer,
    FleetRequest,
    ThreeTierServer,
    build_three_tier_server,
    make_trace,
)

from conftest import reduced_model  # noqa: E402

# Cuts the planner chooses among: the stem's pool, four middle blocks and
# the last three points, so genuine two-cut plans are on the table.
POINTS = [1, 4, 9, 14, 17, 18, 19]
BITS = (2, 8)
CODECS = ("huffman", "bitpack", "perchannel")
BATCH = 4                       # == the calibration batch
RTOL = 2e-5
# Per-device (uplink, backhaul), as the reference's serving test: TK1 gets
# a fast uplink and a congested backhaul, where a genuine two-cut plan
# wins; 0.0 takes the config's second-link bandwidth.
BW1S = [1e6, 10e6, 2e6]
BW2S = [20e6, 1e6, 0.0]
REQS_PER_DEVICE = 2
STREAMS = ("all",) + CODECS


def _profiles(types):
    return [types.EDGE_TX2, types.EDGE_TK1,
            types.DeviceProfile("edge-mid", 1e12, 1.30)]


def _config(cls):
    return cls(bits_choices=BITS, codec_choices=CODECS,
               accuracy_drop_budget=0.10, bandwidth_bytes_per_s=1e6,
               bandwidth2_bytes_per_s=20e6)


def _pinned(engine, codec):
    """``engine`` with its tables cut to one codec (either package)."""
    k = engine.tables.codec_index(codec)
    tables = dataclasses.replace(
        engine.tables, codecs=[codec],
        acc_drop=engine.tables.acc_drop[:, :, k:k + 1],
        size_bytes=engine.tables.size_bytes[:, :, k:k + 1])
    return type(engine)(engine.model, tables, engine.latency,
                        dataclasses.replace(engine.cfg,
                                            codec_choices=(codec,)),
                        point_indices=engine.point_indices)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jmodel, jparams = reduced_model("resnet50")
    cfg = jmodel.cfg
    tables = jbuild_tables(jmodel, jparams, [jmake_batch(cfg, BATCH, 0,
                                                         seed=10)],
                           list(BITS), codecs=list(CODECS), points=POINTS)
    path = str(tmp_path_factory.mktemp("tables") / "tables.npz")
    tables.save(path)
    fmacs = jmodel.per_point_fmacs(BATCH)
    input_bytes = float(BATCH * 3 * cfg.image_size ** 2)
    jc, tc = _config(JJaladConfig), _config(JaladConfig)
    jeng = JEngine(jmodel, JTables.load(path),
                   JLatency(fmacs, jc.edge, jc.cloud, input_bytes), jc,
                   point_indices=POINTS)
    teng = JaladEngine(build_model(cfg), PredictorTables.load(path),
                       LatencyModel(fmacs, tc.edge, tc.cloud, input_bytes),
                       tc, point_indices=POINTS)
    tparams = params_from_numpy(jax.device_get(jparams), "cpu")
    n = REQS_PER_DEVICE * len(BW1S)
    batches = [jmake_batch(cfg, BATCH, 0, seed=100 + u) for u in range(n)]
    return jeng, jparams, teng, tparams, batches


def _requests(cls, batches):
    out, uid = [], 0
    for _ in range(REQS_PER_DEVICE):
        for d in range(len(BW1S)):
            out.append(cls(uid=uid, device_id=d, arrival_s=0.01 * uid,
                           batch=dict(batches[uid]), bandwidth=BW1S[d],
                           bandwidth2=BW2S[d]))
            uid += 1
    return out


@pytest.fixture(scope="module")
def served(shared):
    """Each stream (all three codecs in the tables, then each pinned)
    served by both packages: ``{label: (jserver, jdone, tserver,
    tdone)}``."""
    jeng, jparams, teng, tparams, batches = shared
    out = {}
    for label in STREAMS:
        je = jeng if label == "all" else _pinned(jeng, label)
        te = teng if label == "all" else _pinned(teng, label)
        jsrv = JThree(je, jparams, _profiles(jtypes))
        tsrv = ThreeTierServer(te, tparams, _profiles(ttypes))
        jdone = jsrv.serve(_requests(JRequest, batches))
        tdone = tsrv.serve(_requests(FleetRequest, batches))
        out[label] = (jsrv, jdone, tsrv, tdone)
    return out


def _plan(p):
    return (p.point, p.bits, p.codec, p.point2, p.bits2, p.codec2,
            p.predicted_latency, p.predicted_acc_drop)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rtol * scale, (err, scale)


def _same_blob(a, b):
    """Byte-identical wire blobs (range headers compared by bytes, so
    ``-0.0`` is not ``+0.0``)."""
    assert a.codec == b.codec and a.payload == b.payload
    assert tuple(a.shape) == tuple(b.shape) and a.bits == b.bits
    assert np.asarray(a.x_min).tobytes() == np.asarray(b.x_min).tobytes()
    assert np.asarray(a.x_max).tobytes() == np.asarray(b.x_max).tobytes()
    assert a.nbytes == b.nbytes


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [tree]


def _bw2(r, cfg):
    return r.bandwidth2 if r.bandwidth2 > 0 else cfg.bandwidth2_bytes_per_s


# ---------------------------------------------------------------------------
# the served stream against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", STREAMS)
def test_three_tier_stream_matches_reference(served, label):
    jsrv, jdone, tsrv, tdone = served[label]
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    for r, jr in zip(tdone, jdone):
        assert _plan(r.plan) == _plan(jr.plan)
        assert dataclasses.asdict(r.breakdown) == \
            dataclasses.asdict(jr.breakdown)
        assert r.breakdown.total_s == jr.breakdown.total_s
        assert dataclasses.asdict(tsrv.timeline_for(r.uid)) == \
            dataclasses.asdict(jsrv.timeline_for(jr.uid))
        assert tuple(r.logits.shape) == tuple(np.shape(jr.logits))
        _close(r.logits, jr.logits)
    assert tsrv.makespan_s == jsrv.makespan_s
    assert tsrv.synchronous_time_s() == jsrv.synchronous_time_s()
    tctl, jctl = tsrv.controller, jsrv.controller
    for name in ("bw1_est", "bw2_est", "plan_c", "plan_lat", "steps"):
        assert np.array_equal(getattr(tctl, name), getattr(jctl, name)), name
    assert tctl.switch_count() == jctl.switch_count()


@pytest.mark.parametrize("label", STREAMS)
def test_breakdowns_are_the_planners_numbers(shared, served, label):
    """``edge_s`` / ``edge_server_s`` / ``cloud_s`` are the per-device
    view's ``stage_times`` bitwise; for bitpack the bytes on both links
    are ``plan_sizes`` and the transfers exactly ``S / BW``."""
    _, _, _, tdone = served[label]
    tsrv = served[label][2]
    fleet = tsrv.fleet_space
    tri = fleet.tri
    for r in tdone:
        dv = np.array([r.device_id])
        cell = tsrv.controller.plan_c[dv]
        dev_t, es_t, cl_t = fleet.stage_times_all(cell, dv)
        bd = r.breakdown
        assert (bd.edge_s, bd.edge_server_s, bd.cloud_s) == \
            (dev_t[0], es_t[0], cl_t[0])
        view = tri.stage_times(r.plan)
        assert (bd.edge_server_s, bd.cloud_s) == view[1:]
        assert (bd.plan_point2, bd.plan_bits2, bd.plan_codec2) == \
            (r.plan.point2, r.plan.bits2, r.plan.codec2)
        if label == "bitpack":
            s1, s2 = tri.plan_sizes(r.plan)
            assert (bd.bytes_sent, bd.bytes_sent2) == (int(s1), int(s2))
            assert bd.transfer_s == s1 / r.bandwidth
            assert bd.transfer2_s == s2 / _bw2(r, tsrv.engine.cfg)
        if r.plan.point2 == r.plan.point:
            assert bd.edge_server_s == 0.0
            assert bd.bytes_sent2 == bd.bytes_sent


def test_a_genuine_two_cut_plan_is_served(served):
    _, _, _, tdone = served["all"]
    two_cut = [r for r in tdone if r.plan.point2 > r.plan.point]
    assert two_cut, "no request served with a genuine second cut"
    for r in two_cut:
        assert r.breakdown.edge_server_s > 0.0
        assert r.logits is not None


def test_decision_plane_trace_matches_reference(shared):
    """A batchless ``make_trace(link2=True)`` stream: the clock charges
    the planner's sizes and stage times, equal to the reference's."""
    jeng, jparams, teng, tparams, _ = shared
    kw = dict(seed=7, link2=True, mean_bps=2e6, mean2_bps=8e6)
    jsrv = JThree(jeng, jparams, _profiles(jtypes))
    tsrv = ThreeTierServer(teng, tparams, _profiles(ttypes))
    jdone = jsrv.serve(jmake_trace(3, 12, **kw).requests())
    tdone = tsrv.serve(make_trace(3, 12, **kw).requests())
    assert tdone and [r.uid for r in tdone] == [r.uid for r in jdone]
    tri = tsrv.fleet_space.tri
    for r, jr in zip(tdone, jdone):
        assert r.logits is None and r.batch is None
        assert _plan(r.plan) == _plan(jr.plan)
        assert dataclasses.asdict(r.breakdown) == \
            dataclasses.asdict(jr.breakdown)
        assert dataclasses.asdict(tsrv.timeline_for(r.uid)) == \
            dataclasses.asdict(jsrv.timeline_for(jr.uid))
        if not r.plan.is_cloud_only:
            s1, s2 = tri.plan_sizes(r.plan)
            assert (r.breakdown.bytes_sent, r.breakdown.bytes_sent2) == \
                (int(s1), int(s2))
    assert tsrv.makespan_s == jsrv.makespan_s
    assert tsrv.controller.switch_count() == jsrv.controller.switch_count()


def test_cloud_only_path_matches_reference(shared):
    """An impossible accuracy budget: PNG input over both hops, zero-time
    relay, the full forward on the cloud."""
    jeng, jparams, teng, tparams, batches = shared
    jbad = dataclasses.replace(
        jeng, cfg=dataclasses.replace(jeng.cfg, accuracy_drop_budget=-1.0),
        _plan_space=None, _tri_space=None, _stream_terms=None)
    tbad = dataclasses.replace(
        teng, cfg=dataclasses.replace(teng.cfg, accuracy_drop_budget=-1.0),
        _plan_space=None, _tri_space=None)

    def reqs(cls):
        return [cls(uid=0, device_id=0, batch=dict(batches[0]),
                    bandwidth=1e6),
                cls(uid=1, device_id=1, batch=None, bandwidth=5e5)]

    jdone = JThree(jbad, jparams, _profiles(jtypes)[:2]).serve(reqs(JRequest))
    tdone = ThreeTierServer(tbad, tparams, _profiles(ttypes)[:2]).serve(
        reqs(FleetRequest))
    tri = tbad.tri_space
    for r, jr in zip(tdone, jdone):
        assert r.plan.is_cloud_only and _plan(r.plan) == _plan(jr.plan)
        bd = r.breakdown
        assert dataclasses.asdict(bd) == dataclasses.asdict(jr.breakdown)
        assert (bd.plan_point, bd.plan_bits, bd.plan_codec) == (-1, 0, "png")
        assert (bd.plan_point2, bd.plan_bits2, bd.plan_codec2) == (-1, 0, "")
        assert bd.bytes_sent == bd.bytes_sent2 == \
            int(tri.input_bytes * PNG_RATIO)
        assert bd.edge_s == bd.edge_server_s == 0.0
        assert bd.cloud_s == tri.cloud_exec_full()
    r = next(r for r in tdone if r.batch is not None)
    jr = next(r for r in jdone if r.batch is not None)
    full = teng.model.forward(tparams, batch_to(batches[0], "cpu"))
    assert torch.equal(r.logits, full)
    _close(r.logits, jr.logits)


def test_serve_rejects_bad_device_ids(shared):
    _, _, teng, tparams, _ = shared
    server = ThreeTierServer(teng, tparams, _profiles(ttypes))
    with pytest.raises(ValueError):
        server.serve([FleetRequest(uid=0, device_id=3, batch=None,
                                   bandwidth=1e6)])
    with pytest.raises(ValueError):
        server.serve([FleetRequest(uid=0, device_id=-1, batch=None,
                                   bandwidth=1e6)])
    with pytest.raises(ValueError):
        ThreeTierServer(teng, tparams, [])


# ---------------------------------------------------------------------------
# the engine's three-tier surface
# ---------------------------------------------------------------------------

def test_engine_tri_space_and_decide_tri_match_reference(shared):
    jeng, _, teng, _, _ = shared
    jt, tt = jeng.tri_space, teng.tri_space
    for name in ("dev_vec", "cl_vec", "mid_vec", "acc", "base",
                 "size1_eff", "size2_eff", "energy_base"):
        assert np.array_equal(getattr(tt, name), getattr(jt, name)), name
    assert teng.tri_space is tt                         # cached
    for bw1, bw2 in ((1e6, 20e6), (10e6, 1e6), (1e4, 1e9), (None, None)):
        assert _plan(teng.decide_tri(bw1, bw2)) == \
            _plan(jeng.decide_tri(bw1, bw2))
        free = teng.decide_tri(bw1, bw2)
        if free.is_cloud_only:
            continue
        eb = tt.energy_of(free, bw1 or 1e6, bw2 or 20e6) * 0.5
        assert _plan(teng.decide_tri(bw1, bw2, energy_budget=eb)) == \
            _plan(jeng.decide_tri(bw1, bw2, energy_budget=eb))
    # A per-device engine re-derives its own space for the new edge.
    tk1 = teng.for_edge(ttypes.EDGE_TK1)
    jk1 = jeng.for_edge(jtypes.EDGE_TK1)
    assert np.array_equal(tk1.tri_space.dev_vec, jk1.tri_space.dev_vec)
    assert _plan(tk1.decide_tri(10e6, 1e6)) == _plan(jk1.decide_tri(10e6,
                                                                    1e6))
    # The config's energy budget is honoured when none is given.
    lam = dataclasses.replace(teng, cfg=dataclasses.replace(
        teng.cfg, energy_budget_j=1e-9), _plan_space=None, _tri_space=None)
    assert lam.decide_tri(1e6, 20e6).is_cloud_only


def test_build_three_tier_server_reloads_tables(tmp_path):
    """The factory on the CPU, twice over one table directory: the second
    build reloads the first's tables, and both serve equal plans."""
    from repro_torch.config import get_config

    cfg = get_config("resnet50").reduced()
    jc = JaladConfig(bits_choices=(2, 8), codec_choices=("bitpack",))
    kw = dict(device="cpu", calib_batches=1, calib_batch_size=2,
              points=[1, 9, 19], tables_cache_dir=str(tmp_path))
    a, pa = build_three_tier_server(cfg, jc, _profiles(ttypes), **kw)
    b, pb = build_three_tier_server(cfg, jc, _profiles(ttypes)[:1], **kw)
    assert len(list(tmp_path.iterdir())) == 1
    assert np.array_equal(a.engine.tables.size_bytes,
                          b.engine.tables.size_bytes)
    assert isinstance(a, ThreeTierServer) and a.n_devices == 3
    assert all(torch.equal(x, y) for x, y in zip(_leaves(pa), _leaves(pb)))
    assert _plan(a.engine.decide_tri()) == _plan(b.engine.decide_tri())


# ---------------------------------------------------------------------------
# the executable three-way split
# ---------------------------------------------------------------------------

def _tri_plan(cls, point, bits, codec, point2, bits2, codec2):
    return cls(point, bits, 0.0, 0.0, 0.0, codec=codec, point2=point2,
               bits2=bits2, codec2=codec2)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("cuts", ((1, 14), (4, 18)))
def test_two_cut_blobs_byte_identical_at_the_same_boundary(shared, codec,
                                                           cuts):
    jeng, jparams, teng, tparams, batches = shared
    p1, p2 = cuts
    plan = _tri_plan(DecoupledPlan, p1, 4, codec, p2, 2, codec)
    jrun = JTriRunner(jeng.model, jparams,
                      _tri_plan(JPlan, p1, 4, codec, p2, 2, codec))
    run = teng.make_tri_runner(tparams, plan)
    assert isinstance(run, TriDecoupledRunner) and not run.is_relay
    batch = batches[1]
    # Link 1: the reference's activation encodes to the same bytes.
    x1 = np.asarray(jeng.model.run_head(jparams, batch, p1))
    jblob1 = jget_codec(codec).encode(x1, 4)
    blob1 = get_codec(codec).encode(torch.from_numpy(x1), 4)
    _same_blob(blob1, jblob1)
    # The port's device step is its own head through that encode.
    dblob, extras = run.device_step(batch)
    head = teng.model.run_head(tparams, batch_to(batch, "cpu"), p1)
    _same_blob(dblob, get_codec(codec).encode(head, 4))
    # Link 2: decode bit-exact with the reference's, then the port's
    # segment, then an encode that gives the reference's bytes.
    blob2, extras = run.edge_server_step(blob1, extras)
    got = get_codec(codec).decode(blob1, device="cpu")
    want = np.asarray(jget_codec(codec).decode(jblob1))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    x2 = teng.model.run_segment(tparams, got, p1, p2)
    _same_blob(blob2, get_codec(codec).encode(x2, 2))
    _same_blob(blob2, jget_codec(codec).encode(x2.numpy(), 2))
    assert blob2.bits == 2 and blob2.codec == codec
    # The reference's edge-server step on the same blob: same sizes, and
    # the segment agrees within float.
    jblob2, _ = jrun.edge_server_step(jblob1)
    assert blob2.nbytes == jblob2.nbytes
    _close(x2, jeng.model.run_segment(jparams, want, p1, p2))
    # The cloud's tail from the second cut, on the reference's blob.
    _close(run.cloud_step(jblob2), jrun.cloud_step(jblob2))
    logits, n1, n2 = run.run(batch)
    jlogits, jn1, jn2 = jrun.run(batch)
    assert (n1, n2) == (jn1, jn2)
    _close(logits, jlogits)


@pytest.mark.parametrize("codec", CODECS)
def test_relay_is_the_two_tier_runners_blob(shared, codec):
    """A relay plan passes the device's blob object on unchanged: equal
    bytes to the two-tier runner's edge step, equal logits."""
    jeng, jparams, teng, tparams, batches = shared
    p = 9
    run = TriDecoupledRunner(teng.model, tparams,
                             _tri_plan(DecoupledPlan, p, 8, codec, p, 8,
                                       codec))
    assert run.is_relay
    blob, extras = run.device_step(batches[2])
    blob2, extras2 = run.edge_server_step(blob, extras)
    assert blob2 is blob and extras2 is extras
    two = DecoupledRunner(teng.model, tparams,
                          DecoupledPlan(p, 8, 0.0, 0.0, 0.0, codec=codec))
    tblob, _ = two.edge_step(batches[2])
    _same_blob(blob2, tblob)
    logits, n1, n2 = run.run(batches[2])
    ref_logits, nbytes = two.run(batches[2])
    assert n1 == n2 == nbytes
    assert torch.equal(logits, ref_logits)
    jrun = JTriRunner(jeng.model, jparams,
                      _tri_plan(JPlan, p, 8, codec, p, 8, codec))
    _close(logits, jrun.run(batches[2])[0])


@pytest.mark.parametrize("cuts", ((0, 0), (1, 14), (4, 19), (19, 19)))
def test_segment_chain_is_the_full_forward(shared, cuts):
    """``run_tail(run_segment(run_head(x, i1), i1, i2), i2)`` is the full
    forward (the same layers in the same order: bitwise), and the
    segment agrees with the reference's within ``RTOL``."""
    jeng, jparams, teng, tparams, batches = shared
    i1, i2 = cuts
    model, batch = teng.model, batch_to(batches[3], "cpu")
    with torch.no_grad():
        head = model.run_head(tparams, batch, i1)
        seg = model.run_segment(tparams, head, i1, i2)
        if i1 == i2:
            assert seg is head
        out = model.run_tail(tparams, seg, i2)
        assert torch.equal(out, model.forward(tparams, batch))
    jhead = np.asarray(jeng.model.run_head(jparams, batches[3], i1))
    _close(model.run_segment(tparams, torch.from_numpy(jhead), i1, i2),
           jeng.model.run_segment(jparams, jhead, i1, i2))


def test_bad_plans_and_segments_raise(shared):
    _, _, teng, tparams, _ = shared
    with pytest.raises(ValueError):
        TriDecoupledRunner(teng.model, tparams,
                           DecoupledPlan(3, 8, 0.0, 0.0, 0.0))
    with pytest.raises(ValueError):
        TriDecoupledRunner(teng.model, tparams,
                           _tri_plan(DecoupledPlan, 5, 8, "bitpack", 2, 8,
                                     "bitpack"))
    with pytest.raises(ValueError):
        teng.model.run_segment(tparams, torch.zeros(1), 5, 2)
    assert not DecoupledPlan(3, 8, 0.0, 0.0, 0.0).has_second_cut
    assert _tri_plan(DecoupledPlan, 3, 8, "bitpack", 3, 8,
                     "bitpack").has_second_cut


# ---------------------------------------------------------------------------
# the two-tier breakdown keeps its bits
# ---------------------------------------------------------------------------

def test_total_s_sums_in_the_reference_order():
    """Five-term totals of random breakdowns (times across 12 decades, so
    the order of the float adds shows) equal the reference's bitwise."""
    from repro.serving.edge_cloud import LatencyBreakdown as JBreakdown
    from repro_torch.serving import LatencyBreakdown

    rng = np.random.default_rng(17)
    times = 10 ** rng.uniform(-9, 3, (2000, 5))
    for t in times:
        kw = dict(edge_s=t[0], transfer_s=t[1], cloud_s=t[2], bytes_sent=1,
                  plan_point=0, plan_bits=2, edge_server_s=t[3],
                  transfer2_s=t[4])
        assert LatencyBreakdown(**kw).total_s == JBreakdown(**kw).total_s


def test_two_tier_total_is_unchanged_bit_for_bit(shared):
    """The two-tier server's breakdowns: the three-tier fields stay at
    their defaults, and ``total_s`` (now a five-term sum in the
    reference's order) has the bits of ``edge_s + transfer_s + cloud_s``
    and of the reference's total."""
    jeng, jparams, teng, tparams, batches = shared
    jsrv, tsrv = JServer(jeng, jparams), EdgeCloudServer(teng, tparams)
    for i, bw in enumerate((3e5, 3e6, 3e7, 1e9, 1e4)):
        batch = batches[i % len(batches)]
        _, bd = tsrv.serve_batch(dict(batch), bw)
        _, jbd = jsrv.serve_batch(dict(batch), bw)
        assert dataclasses.asdict(bd) == dataclasses.asdict(jbd)
        assert (bd.edge_server_s, bd.transfer2_s, bd.bytes_sent2,
                bd.plan_point2, bd.plan_bits2, bd.plan_codec2) == \
            (0.0, 0.0, 0, -1, 0, "")
        assert bd.total_s == bd.edge_s + bd.transfer_s + bd.cloud_s
        assert bd.total_s == jbd.total_s
    assert tsrv.clock == jsrv.clock
