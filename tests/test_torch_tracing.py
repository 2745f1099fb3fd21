"""The port's spans (``repro_torch.utils.trace``) on the CPU: nothing is
recorded while nobody records, the ring keeps its size, a fleet ``serve``
and a stream ``step`` give the documented span tree with its request and
step identifiers, each recorded span joins its ``torch.profiler`` range
one for one, the spans of two server threads keep their own parents, each
kernel span's bytes are the benchmark's count for the shapes served, and
recording changes no served logit or token."""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.counts import codec as counts  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.config import JaladConfig, ServeConfig, get_config  # noqa: E402
from repro_torch.config.types import DeviceProfile  # noqa: E402
from repro_torch.core.adaptation import (  # noqa: E402
    AdaptationController,
    FleetAdaptationController,
)
from repro_torch.core.decoupler import DecoupledPlan  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving.fleet import (  # noqa: E402
    FleetRequest,
    FleetServer,
    build_fleet_server,
)
from repro_torch.serving.pipeline import (  # noqa: E402
    PipelinedEdgeCloudServer,
    PipelineRequest,
)
from repro_torch.serving.scheduler import GenRequest  # noqa: E402
from repro_torch.serving.streaming import (  # noqa: E402
    TokenStreamSession,
    step_stream_group,
)
from repro_torch.utils import trace  # noqa: E402

FRAMES = 2
BITS = 2


@pytest.fixture(scope="module")
def fleet_parts():
    cfg = get_config("resnet50").reduced()
    points = build_model(cfg).decoupling_points()
    stem, fc = points.index("stem_pool"), points.index("fc")
    profiles = [DeviceProfile("a", 1e12, 1.0), DeviceProfile("b", 1e12, 1.0)]
    fleet, params = build_fleet_server(
        cfg, JaladConfig(bits_choices=(BITS,),
                         codec_choices=("bitpack", "perchannel")),
        profiles, device="cpu", calib_batches=1, calib_batch_size=FRAMES,
        points=[stem, fc])
    # Device 0 cuts after stem_pool (per-channel, a cloud tail), device 1
    # after fc (bitpack, the whole net in the head).
    plans = {0: DecoupledPlan(stem, BITS, 0.0, 0.0, 0.0, "perchannel"),
             1: DecoupledPlan(fc, BITS, 0.0, 0.0, 0.0, "bitpack")}
    gen = torch.Generator().manual_seed(0)
    images = [torch.randn(FRAMES, 3, cfg.image_size, cfg.image_size,
                          generator=gen) for _ in range(4)]
    return fleet, params, profiles, plans, images


class _Pinned(FleetAdaptationController):
    plans = {}

    def plan_for(self, device_id):
        return self.plans[device_id]


def _fleet(parts):
    fleet, params, profiles, plans, _ = parts
    ctl = _Pinned(fleet.fleet_space, default_bw=1e6)
    ctl.plans = plans
    return FleetServer(fleet.engine, params, profiles, cloud_batch=4,
                       fleet_space=fleet.fleet_space, controller=ctl)


def _serve(parts):
    images = parts[4]
    reqs = [FleetRequest(uid=u, device_id=u % 2,
                         batch={"images": images[u]}, bandwidth=1e7)
            for u in range(len(images))]
    return _fleet(parts).serve(reqs)


@pytest.fixture(scope="module")
def lm():
    model = build_model(get_config("olmo-1b").reduced())
    return model, model.init(0, "cpu")


def _session(lm):
    model, params = lm
    sess = TokenStreamSession(model, params, ServeConfig(
        max_batch=2, max_seq_len=32),
        plan=DecoupledPlan(1, 8, 0.0, 0.0, 0.0, "bitpack"))
    sess.submit(GenRequest(uid=0, tokens=np.arange(5), max_new_tokens=4))
    sess.step()
    sess.submit(GenRequest(uid=1, tokens=np.arange(3, 10),
                           max_new_tokens=4))
    return sess


def _tree(spans):
    """(name, parent's name, uid, step) of each span, in opening order."""
    by = {s.seq: s for s in spans}
    return [(s.name, by[s.parent].name if s.parent in by else None, s.uid,
             s.step) for s in spans]


def test_span_records_nothing_unless_recording():
    trace.clear()
    assert trace.span("fleet.serve", requests=1) is trace.span("x")
    with trace.span("fleet.serve") as sp:
        assert not sp
        sp.set(waves=1)
    get_codec("bitpack").encode(torch.randn(4, 8), BITS)
    assert trace.spans() == []
    with trace.recording() as rec:
        with trace.span("fleet.serve") as sp:
            assert sp
    assert [s.name for s in rec] == ["fleet.serve"]


def test_ring_keeps_its_size():
    trace.clear()
    with trace.recording() as rec:
        for i in range(trace.RING + 10):
            with trace.span("s", uid=i):
                pass
    held = trace.spans()
    assert len(held) == trace.RING == len(rec)
    assert held[0].uid == 10 and held[-1].uid == trace.RING + 9


def test_fleet_span_tree(fleet_parts):
    with trace.recording() as rec:
        _serve(fleet_parts)
    stem, fc = (fleet_parts[3][d].point for d in (0, 1))
    edge = lambda u, k: [  # noqa: E731
        ("fleet.edge", "fleet.serve", u, None),
        ("decoupler.head", "fleet.edge", u, None),
        ("codec.encode", "fleet.edge", u, None),
        (f"kernel.{k}", "codec.encode", u, None)]
    cloud = lambda k: [  # noqa: E731
        ("fleet.cloud", "fleet.serve", None, None),
        ("codec.decode", "fleet.cloud", None, None),
        (f"kernel.{k}", "codec.decode", None, None),
        ("decoupler.tail", "fleet.cloud", None, None),
        ("decoupler.tail", "fleet.cloud", None, None)]
    wave = [("fleet.decide", "fleet.serve", None, None)]
    assert _tree(rec) == (
        [("fleet.serve", None, None, None)]
        + wave + edge(0, "pc_encode") + edge(1, "fused_encode")
        + wave + edge(2, "pc_encode") + edge(3, "fused_encode")
        + cloud("fused_decode") + cloud("pc_decode"))
    attrs = [s.attrs for s in rec]
    assert attrs[0] == {"requests": 4, "waves": 2}
    assert attrs[1] == {"wave": 2}
    assert attrs[2] == {"uid": 0, "device": 0, "point": stem, "bits": BITS,
                        "codec": "perchannel"}
    clouds = [s.attrs for s in rec if s.name == "fleet.cloud"]
    assert clouds == [{"key": (fc, BITS, "bitpack"), "uids": [1, 3]},
                      {"key": (stem, BITS, "perchannel"), "uids": [0, 2]}]
    wire = [s.attrs for s in rec if s.name.startswith("codec.")]
    assert [(w["codec"], w["bits"], w["frames"]) for w in wire] == [
        ("perchannel", BITS, 1), ("bitpack", BITS, 1),
        ("perchannel", BITS, 1), ("bitpack", BITS, 1),
        ("bitpack", BITS, 2), ("perchannel", BITS, 2)]
    tails = [s.attrs for s in rec if s.name == "decoupler.tail"]
    assert tails == [{"point": fc, "frames": FRAMES}] * 2 + [
        {"point": stem, "frames": FRAMES}] * 2


def test_stream_span_tree(lm):
    sess = _session(lm)
    with trace.recording() as rec:
        sess.step()
    join = [("stream.join", "stream.step", 1, 2),
            ("stream.head", "stream.join", 1, 2),
            ("codec.encode", "stream.join", 1, 2),
            ("kernel.fused_encode", "codec.encode", 1, 2),
            ("codec.decode", "stream.join", 1, 2),
            ("kernel.fused_decode", "codec.decode", 1, 2),
            ("stream.tail", "stream.join", 1, 2),
            ("stream.select", "stream.join", 1, 2)]
    step = [("stream.head", "stream.step", None, 2),
            ("codec.encode", "stream.step", None, 2),
            ("kernel.fused_encode", "codec.encode", None, 2),
            ("codec.decode", "stream.step", None, 2),
            ("kernel.fused_decode", "codec.decode", None, 2),
            ("stream.tail", "stream.step", None, 2),
            ("stream.select", "stream.step", None, 2)]
    assert _tree(rec) == [("stream.step", None, None, 2)] + join + step
    assert rec[0].attrs == {"step": 2, "active": 2, "joins": 1}
    assert rec[1].attrs == {"uid": 1, "prompt": 7}
    assert [s.attrs["frames"] for s in rec
            if s.name.startswith("codec.")] == [1, 1, 2, 2]


def test_stream_group_opens_the_same_spans(lm):
    sessions = [_session(lm), _session(lm)]
    with trace.recording() as rec:
        step_stream_group(sessions)
    assert rec[0].name == "stream.step"
    assert rec[0].attrs == {"step": 2, "sessions": 2, "active": 4}
    assert all(s.step == 2 for s in rec)
    # Each session seats uid 1 (a join's eight spans), then one head,
    # tail and select each; the group shares one encode and one decode.
    want = {"stream.join": 2, "stream.head": 4, "stream.tail": 4,
            "stream.select": 4, "codec.encode": 3, "codec.decode": 3,
            "kernel.fused_encode": 3, "kernel.fused_decode": 3}
    got = {}
    for s in rec[1:]:
        got[s.name] = got.get(s.name, 0) + 1
    assert got == want


def test_spans_join_their_profiler_ranges(fleet_parts, lm):
    from torch.profiler import ProfilerActivity, profile

    trace.clear()
    sess = _session(lm)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(fleet_parts)
        sess.step()
    recorded = trace.spans()
    ranges = trace.profile_ranges(prof)
    pairs = trace.join(recorded, ranges)
    assert len(recorded) == len(ranges) == len(pairs) > 40
    assert all(s.ranged for s in recorded)
    for s, (name, start, end, _) in pairs:
        assert s.name == name
        assert start <= s.start_ns <= s.end_ns <= end


def test_two_server_threads_keep_their_parents(fleet_parts):
    fleet, params, _, plans, images = fleet_parts

    class Fixed(AdaptationController):
        def current_plan(self, bandwidth=None):
            return plans[0]

    server = PipelinedEdgeCloudServer(fleet.engine, params,
                                      controller=Fixed(fleet.engine),
                                      micro_batch=1)
    with trace.recording() as rec:
        done = server.serve([PipelineRequest(uid=u, batch={"images": x},
                                             bandwidth=1e7)
                             for u, x in enumerate(images)])
    assert len(done) == len(images)
    by = {s.seq: s for s in rec}
    threads = {s.thread for s in rec}
    assert len(threads) == 2
    for s in rec:
        assert s.parent is None or by[s.parent].thread == s.thread
    for s in rec:
        if s.name.startswith("kernel."):
            want = ("codec.encode" if "encode" in s.name else "codec.decode")
            assert by[s.parent].name == want


def test_threads_interleaved_keep_their_parents():
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with trace.span("outer", uid=tag):
            gate.wait()
            with trace.span("inner"):
                gate.wait()

    with trace.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by = {s.seq: s for s in rec}
    inner = [s for s in rec if s.name == "inner"]
    assert len(inner) == 2
    for s in inner:
        assert by[s.parent].thread == s.thread and s.uid == by[s.parent].uid


def test_many_threads_lose_no_span():
    """More threads than cores opening nested spans with a short switch
    interval: every span is recorded once, with a parent on its own
    thread and its thread's request."""
    n_threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            def work(tag):
                for _ in range(per):
                    with trace.span("outer", uid=tag):
                        with trace.span("inner"):
                            pass

            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(rec) == 2 * n_threads * per
    assert len({s.seq for s in rec}) == len(rec)
    by = {s.seq: s for s in rec}
    for s in rec:
        if s.name == "inner":
            p = by[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert s.uid == p.uid


def test_kernel_bytes_are_the_benchmarks_counts(fleet_parts, lm):
    fleet, params, _, plans, images = fleet_parts
    with trace.recording() as rec:
        _serve(fleet_parts)
    model = fleet.engine.model
    got = {}
    for s in rec:
        if s.name.startswith("kernel."):
            got.setdefault(s.name, []).append(s.attrs["bytes"])
    shape = {}
    for d, plan in plans.items():
        shape[plan.codec] = tuple(model.run_head(
            params, {"images": images[d]}, plan.point).shape)
    pc, bp = shape["perchannel"], shape["bitpack"]
    assert got["kernel.pc_encode"] == [counts.encode_bytes(
        "perchannel", pc, BITS)] * 2
    assert got["kernel.fused_encode"] == [counts.encode_bytes(
        "bitpack", bp, BITS)] * 2
    # Each cloud group of two decodes in one launch.
    assert got["kernel.pc_decode"] == [2 * counts.decode_bytes(
        "perchannel", pc, BITS)]
    assert got["kernel.fused_decode"] == [2 * counts.decode_bytes(
        "bitpack", bp, BITS)]
    # The stream's rows at 8 bits, in the model's dtype.
    sess = _session(lm)
    with trace.recording() as rec:
        sess.step()
    d = lm[0].cfg.d_model
    item = torch.empty((), dtype=sess._cloud_dtype).element_size()
    enc = [s.attrs["bytes"] for s in rec
           if s.name == "kernel.fused_encode"]
    dec = [s.attrs["bytes"] for s in rec
           if s.name == "kernel.fused_decode"]
    assert enc == [counts.encode_bytes("bitpack", (1, 7, d), 8, item),
                   2 * counts.encode_bytes("bitpack", (1, 1, d), 8, item)]
    assert dec == [counts.decode_bytes("bitpack", (1, 7, d), 8, item),
                   2 * counts.decode_bytes("bitpack", (1, 1, d), 8, item)]


def test_recording_changes_no_result(fleet_parts, lm):
    plain = _serve(fleet_parts)
    with trace.recording():
        traced = _serve(fleet_parts)
    assert [r.uid for r in plain] == [r.uid for r in traced]
    for a, b in zip(plain, traced):
        assert torch.equal(a.logits, b.logits)
    outs = []
    for on in (False, True):
        sess = _session(lm)
        if on:
            with trace.recording():
                sess.run()
        else:
            sess.run()
        outs.append({r.uid: list(r.out_tokens) for r in sess.completed})
    assert outs[0] == outs[1] and len(outs[0]) == 2
