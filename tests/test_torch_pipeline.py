"""Parity of the port's pipelined server with the reference's.

Both packages load one predictor-table file built by the reference's
calibration over the three codecs, serve the same request stream (the
reduced ResNet-50, reference weights bridged in, run on the CPU) under the
same bandwidth step, and must make the same plan decisions, commit the
same adaptation events and produce equal ``StageTimeline``s. Each request
goes through its own ``serve`` call, so the link stage has observed every
earlier transfer before the edge stage decides: the decision sequence is
then independent of thread timing in both packages.

The micro-batched edge stage is checked on its own: blobs from one batched
encode are byte-identical to per-request encodes (and to the reference's),
and each request's logits are its blob's cloud step.
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
from repro.core.decoupler import DecoupledRunner as JRunner  # noqa: E402
from repro.core.decoupler import JaladEngine as JEngine  # noqa: E402
from repro.core.latency import LatencyModel as JLatency  # noqa: E402
from repro.core.predictor import PredictorTables as JTables  # noqa: E402
from repro.core.predictor import build_tables as jbuild_tables  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.serving.pipeline import (  # noqa: E402
    PipelinedEdgeCloudServer as JPipe,
)
from repro.serving.pipeline import PipelineRequest as JRequest  # noqa: E402
from repro_torch.config import JaladConfig  # noqa: E402
from repro_torch.core.decoupler import JaladEngine  # noqa: E402
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.core.predictor import PredictorTables  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving.pipeline import (  # noqa: E402
    PipelinedEdgeCloudServer,
    PipelineRequest,
)

from conftest import reduced_model  # noqa: E402

POINTS = [1, 4, 17, 18, 19]
BITS = (2, 8)
CODECS = ("huffman", "bitpack", "perchannel")
BATCH = 2
# How long a test waits for each pipeline stage thread to drain (a request
# takes well under a second here), so a hung stage fails the test.
STAGE_TIMEOUT_S = 60.0
# A bandwidth step down then up: the EWMA estimate crosses the plans'
# break-even points in both directions.
TRACE = [3e8] * 2 + [3e3] * 10 + [3e8] * 2


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
    items = [jmake_batch(cfg, BATCH, 64, seed=60 + i)
             for i in range(len(TRACE))]
    return jeng, jparams, teng, tparams, items


def _plan(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


def test_pipeline_matches_reference(shared):
    jeng, jparams, teng, tparams, items = shared
    jpipe = JPipe(jeng, jparams, micro_batch=1)
    tpipe = PipelinedEdgeCloudServer(teng, tparams, micro_batch=1)
    for i, (batch, bw) in enumerate(zip(items, TRACE)):
        jpipe.serve([JRequest(uid=i, batch=batch, bandwidth=bw)])
        tpipe.serve([PipelineRequest(uid=i, batch=batch, bandwidth=bw)],
                    timeout_s=STAGE_TIMEOUT_S)
    jdone, tdone = jpipe.completed, tpipe.completed
    assert [r.uid for r in tdone] == list(range(len(TRACE)))
    assert [_plan(r.plan) for r in tdone] == [_plan(r.plan) for r in jdone]
    assert [dataclasses.asdict(r.timeline) for r in tdone] == \
        [dataclasses.asdict(r.timeline) for r in jdone]

    def events(pipe):
        return [(t, e.step, e.bandwidth, None if e.old_plan is None
                 else _plan(e.old_plan), _plan(e.new_plan))
                for t, e in pipe.adaptation_log]

    assert events(tpipe) == events(jpipe)
    assert tpipe.controller.switch_count() >= 2
    codecs = {r.timeline.plan_codec for r in tdone}
    assert len(codecs) >= 2, codecs
    for r in tdone:
        assert tuple(r.logits.shape) == (BATCH,
                                         teng.model.cfg.num_classes)
        assert bool(torch.isfinite(r.logits).all())
    assert tpipe.makespan_s == jpipe.makespan_s
    assert tpipe.synchronous_time_s() == jpipe.synchronous_time_s()


@pytest.mark.parametrize("codec", CODECS)
def test_microbatched_blobs_match_per_request(shared, codec):
    jeng, jparams, teng, tparams, items = shared
    full = teng.tables
    k = full.codec_index(codec)
    tables = dataclasses.replace(full, codecs=[codec],
                                 acc_drop=full.acc_drop[:, :, k:k + 1],
                                 size_bytes=full.size_bytes[:, :, k:k + 1])
    engine = JaladEngine(teng.model, tables, teng.latency,
                         dataclasses.replace(teng.cfg,
                                             codec_choices=(codec,)),
                         point_indices=POINTS)
    pipe = PipelinedEdgeCloudServer(engine, tparams, micro_batch=4)
    pipe.controller.observe_transfer(3e8, 1.0)
    done = pipe.serve([PipelineRequest(uid=i, batch=items[i], bandwidth=3e8)
                       for i in range(4)], timeout_s=STAGE_TIMEOUT_S)
    plan = done[0].plan
    assert not plan.is_cloud_only and plan.codec == codec
    runner = pipe.runners.get(plan)
    jrunner = JRunner(jeng.model, jparams, plan)
    for r in done:
        assert r.plan is plan and r.encode_group == 4
        blob, _ = runner.edge_step(r.batch)
        jblob, _ = jrunner.edge_step(r.batch)
        assert r.blob.payload == blob.payload == jblob.payload
        np.testing.assert_array_equal(r.blob.x_min, blob.x_min)
        assert r.timeline.bytes_sent == blob.nbytes
        assert torch.equal(r.logits, runner.cloud_step(r.blob))
