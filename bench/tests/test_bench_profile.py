"""The traced slice's reduction and the per-layer readers, on a made-up
trace: busy time, idle gaps named by the host, kernels a step, shares of
the peaks."""
from pathlib import Path

import pytest

from bench import harness
from bench.counts import peaks
from bench.profile import TraceSlice, _name_gaps, _union

ROOT = Path(__file__).resolve().parents[2]


def test_union_clips_and_merges():
    assert _union([(5, 9), (0, 3), (2, 4), (8, 12)], 1, 11) == [(1, 4),
                                                                 (5, 11)]


def test_gaps_named_by_innermost_host_op():
    host = [("bench.decode_step", 0, 100), ("aten::mm", 10, 20),
            ("cudaStreamSynchronize", 40, 60)]
    named = _name_gaps([(12, 14), (45, 47), (70, 80), (150, 160)], host)
    assert [n for _, _, n in named] == ["aten::mm", "cudaStreamSynchronize",
                                        "bench.decode_step.python",
                                        "host.python"]


def trace() -> TraceSlice:
    ms = 1_000_000
    kernels = [("fused_encode_kernel<float>", 0, 1 * ms),
               ("sm80_xmma_fprop", 1 * ms, 7 * ms),
               ("pc_decode_kernel", 8 * ms, 9 * ms),
               ("void at::native::add", 12 * ms, 13 * ms)]
    t = TraceSlice(window=(0, 20 * ms), kernels=kernels, copies=[],
                   spans=[("bench.decode_step", 0, 10 * ms),
                          ("bench.decode_step", 10 * ms, 20 * ms)])
    t.busy_s = 9e-3
    t.gaps = [(9 * ms, 12 * ms, "aten::copy_"), (13 * ms, 20 * ms,
                                                  "host.python")]
    return t


def run(cell: str, spans) -> harness.Run:
    c = harness.find_cell(ROOT, cell)
    return harness.Run(c, harness.Record(spans=spans), trace(), 20.0)


def test_fleet_readers():
    spans = [dict(name="serve", t0=0.0, t1=0.01, part="traced",
                  flops=6.7e9, codec_bytes=3.35e6, group_sizes=[2, 1]),
             dict(name="serve", t0=1.0, t1=1.02, part="before", flops=1.0,
                  codec_bytes=1, group_sizes=[3])]
    r = run("resnet50.fleet_wifi", spans)
    read = lambda m: harness.metric_reader(ROOT, m)(r)  # noqa: E731
    assert read("cloud_group_size.fleet") == 3.0
    assert read("wave_ms_p50.fleet") == pytest.approx(20.0)
    # 3.35 MB at 3.35 TB/s is 1 us, over the 2 ms of K1 and K5.
    assert read("codec_roofline_pct.fleet") == pytest.approx(0.05)
    assert read("mfu_busy_pct.fleet") == pytest.approx(
        100 * 6.7e9 / (9e-3 * peaks.F32_FLOPS))
    assert read("device_idle_pct.fleet") == pytest.approx(55.0)
    assert trace().breakdown()["idle_gaps"][0] == ["host.python",
                                                   pytest.approx(7e-3)]


def test_stream_readers():
    spans = [dict(name="decode_step", t0=0.0, t1=0.01, part="traced",
                  flops=9.89e9),
             dict(name="join_step", t0=1.0, t1=1.05, part="before",
                  flops=0.0)]
    r = run("olmo-1b.stream_chat", spans)
    read = lambda m: harness.metric_reader(ROOT, m)(r)  # noqa: E731
    assert read("kernels_per_step.stream") == 2.0
    assert read("mfu_pct.stream") == pytest.approx(100 * 9.89e9 / (
        0.02 * peaks.BF16_FLOPS))
    assert read("join_step_ms_p50.stream") == pytest.approx(50.0)
    assert read("decode_step_ms_p50.stream") is None


def test_readers_without_a_trace_read_nothing():
    r = run("resnet50.fleet_wifi", [])
    r.trace = None
    for m in ("codec_roofline_pct.fleet", "mfu_busy_pct.fleet",
              "device_idle_pct.fleet", "cloud_group_size.fleet"):
        assert harness.metric_reader(ROOT, m)(r) is None
