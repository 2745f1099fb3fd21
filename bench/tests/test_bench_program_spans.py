"""The program's spans in a traced slice (bench/program_spans.py) and the
five readers on them, on made-up event lists: which span a device
operation belongs to, idle time inside spans, the readers' numbers, and
None where the slice holds no spans of theirs. Then the reduction of a
real CPU profile, its ranges joined with the program's record."""
from pathlib import Path

import pytest

from bench import harness, program_spans
from bench.counts import peaks
from bench.profile import summarize
from bench.program_spans import ProgramSpans

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000


def read(metric, p, cell="olmo-1b.stream_chat", monkeypatch=None):
    monkeypatch.setattr(program_spans, "of", lambda run: p)
    c = harness.find_cell(ROOT, cell)
    return harness.metric_reader(ROOT, metric)(
        harness.Run(c, harness.Record(), None, 1.0))


def stream() -> ProgramSpans:
    """Two steps: step 1 seats a request (its join's prefill launches 4 ms
    of device work), step 2 does not; each step's tail launches 3 and 5 ms,
    step 2's tail kernel runs after the span closed."""
    ranges = [("stream.step", 0, 40 * MS), ("stream.join", 1 * MS, 20 * MS),
              ("stream.tail", 10 * MS, 15 * MS),
              ("stream.tail", 30 * MS, 35 * MS),
              ("stream.step", 50 * MS, 60 * MS),
              ("stream.head", 51 * MS, 52 * MS),
              ("stream.tail", 55 * MS, 57 * MS)]
    launches = {1: 2 * MS, 2: 11 * MS, 3: 31 * MS, 4: 51 * MS, 5: 56 * MS,
                6: 70 * MS}
    ops = [("prefill_head", 3 * MS, 4 * MS, 1),
           ("prefill_tail", 12 * MS, 15 * MS, 2),
           ("tail", 32 * MS, 35 * MS, 3),
           ("head", 51 * MS, 52 * MS, 4),
           ("tail", 58 * MS, 63 * MS, 5),           # after its span closed
           ("stray", 71 * MS, 72 * MS, 6),          # launched outside
           ("unknown", 80 * MS, 81 * MS, 99)]       # no launch on the thread
    gaps = [(0, 3 * MS), (4 * MS, 12 * MS), (15 * MS, 32 * MS),
            (35 * MS, 51 * MS), (52 * MS, 58 * MS), (63 * MS, 71 * MS)]
    return ProgramSpans(ranges, launches, ops, gaps)


def test_an_operation_belongs_to_the_innermost_span_at_its_launch():
    p = stream()
    names = [p.ranges[i][0] if i >= 0 else None for i in p.owner]
    assert names == ["stream.join", "stream.tail", "stream.tail",
                     "stream.head", "stream.tail", None, None]
    # The late tail kernel is step 2's tail's, not the gap's.
    tail2 = p.children(p.named("stream.step")[1], "stream.tail")
    assert [p.device[i] for i in tail2] == [5 * MS]
    assert p.device[p.named("stream.step")[1]] == 6 * MS
    assert p.device[p.named("stream.join")[0]] == 4 * MS
    assert [p.ranges[p.parent[i]][0] for i in p.named("stream.tail")] == [
        "stream.join", "stream.step", "stream.step"]


def test_a_gap_across_a_span_edge_is_split():
    p = ProgramSpans([("fleet.serve", 10, 20), ("fleet.serve", 30, 40)],
                     {}, [], [(5, 12), (18, 33), (39, 50)])
    # Inside: 2 + 2 of the first span, 3 + 1 of the second.
    assert p.idle_pct("fleet.serve") == pytest.approx(100 * 8 / 20)
    assert p.idle_pct("stream.join") is None


def test_stream_readers(monkeypatch):
    p = stream()
    r = lambda m: read(m, p, monkeypatch=monkeypatch)  # noqa: E731
    assert r("tail_device_ms_p50.stream") == pytest.approx(5.0)
    assert r("join_device_ms_p50.stream") == pytest.approx(4.0)
    # The join [1, 20) ms: idle 1-3, 4-12, 15-20 ms of its 19.
    assert r("join_idle_pct.stream") == pytest.approx(100 * 15 / 19)


def test_fleet_readers(monkeypatch):
    ranges = [("fleet.serve", 0, 10 * MS),
              ("codec.encode", 1 * MS, 3 * MS),
              ("kernel.pc_encode", 1 * MS, 2 * MS),
              ("fleet.cloud", 5 * MS, 9 * MS),
              ("kernel.pc_decode", 6 * MS, 7 * MS)]
    attrs = [{}, {}, {"bytes": 3_350_000}, {}, {"bytes": 6_700_000}]
    ops = [("pc_encode_kernel", 2 * MS, 3 * MS, 1),
           ("conv", 3 * MS, 6 * MS, 2),
           ("pc_decode_kernel", 7 * MS, 8 * MS, 3)]
    launches = {1: int(1.5 * MS), 2: int(2.5 * MS), 3: int(6.5 * MS)}
    gaps = [(0, 2 * MS), (6 * MS, 7 * MS), (8 * MS, 12 * MS)]
    p = ProgramSpans(ranges, launches, ops, gaps, attrs)
    r = lambda m: read(m, p, "resnet50.fleet_wifi", monkeypatch)  # noqa: E731
    # 10.05 MB at 3.35 TB/s is 3 us, over the 2 ms the two kernel spans
    # launched (the convolution launched in codec.encode is not theirs).
    assert r("wire_roofline_pct.fleet") == pytest.approx(
        100 * 10.05e6 / peaks.HBM_BYTES_PER_S / 2e-3)
    assert r("serve_idle_pct.fleet") == pytest.approx(100 * 5 / 10)
    # A kernel span whose bytes are not known reads nothing.
    p.attrs[2] = None
    assert r("wire_roofline_pct.fleet") is None


@pytest.mark.parametrize("metric,cell", [
    ("wire_roofline_pct.fleet", "resnet50.fleet_wifi"),
    ("serve_idle_pct.fleet", "resnet50.fleet_wifi"),
    ("tail_device_ms_p50.stream", "olmo-1b.stream_chat"),
    ("join_device_ms_p50.stream", "olmo-1b.stream_chat"),
    ("join_idle_pct.stream", "olmo-1b.stream_chat")])
def test_readers_without_their_spans_read_nothing(metric, cell, monkeypatch):
    other = ProgramSpans([("decoupler.head", 0, MS)], {1: 0},
                         [("k", 0, MS, 1)], [(MS, 2 * MS)])
    assert read(metric, other, cell, monkeypatch) is None
    assert read(metric, None, cell, monkeypatch) is None
    empty = ProgramSpans([], {}, [], [])
    assert read(metric, empty, cell, monkeypatch) is None


def test_a_cpu_profile_reduces_to_joined_spans():
    """The harness's ranges around the program's spans under a real CPU
    profiler: the reduction finds the serving thread's program ranges in
    the slice, and the attributes of the program's record join them."""
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile, record_function

    trace = pytest.importorskip("repro_torch.utils.trace")
    from repro_torch.codec import get_codec

    x = torch.randn(2, 4, 8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.slice"):
            for uid in range(2):
                with record_function("bench.serve"):
                    with trace.span("fleet.serve", requests=1):
                        with trace.span("fleet.edge", uid=uid):
                            get_codec("perchannel").encode(x, 2)
    rec = harness.Record(_done=prof)
    rec.trace = summarize(prof)
    p = program_spans.of(harness.Run(None, rec, rec.trace, 1.0))
    assert [r[0] for r in p.ranges] == [
        "fleet.serve", "fleet.edge", "codec.encode", "kernel.pc_encode"] * 2
    assert [a["uid"] for a, r in zip(p.attrs, p.ranges)
            if r[0] == "fleet.edge"] == [0, 1]
    kernels = [a["bytes"] for a, r in zip(p.attrs, p.ranges)
               if r[0] == "kernel.pc_encode"]
    # x, then 4 channels of 8 words and their (min, max) pairs.
    assert kernels == [trace.tensor_bytes(x) + 4 * 8 * 4 + 8 * 4] * 2
    # No device on the CPU: the whole slice is idle, every serve too.
    assert p.idle_pct("fleet.serve") == pytest.approx(100.0)
