"""The granite-4.0-h-micro configuration, its cell and the fleet_burst
mix, on the CPU at reduced widths: the plain reference against the port,
the served token stream across the cut judged by the reference (a sound
run passes, the fp8 control fails), the layout at the published widths,
the harness finding the cell and its metrics, the SSM readers, and the
burst schedule. The stream is driven to a number of finished requests,
not for a time, so a slow host changes nothing it checks."""
import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness, program_spans
from bench.counts import hybrid
from bench.counts.peaks import HBM_BYTES_PER_S
from bench.program_spans import ProgramSpans
from bench.reference import granite_hybrid as ref
from bench.traffic import closed_chat, fleet_burst
from bench.weights import draw, same_layout

torch.set_num_threads(2)
api = pytest.importorskip("repro_torch.models.api")
from repro_torch.config import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
CELL = "granite-4.0-h-micro.stream_long"
CONFIG = json.loads((ROOT / "bench/configs/granite-4.0-h-micro.json")
                    .read_text())
FULL = CONFIG["model"]
# Every width cut, every mechanism kept: Mamba2 heads of 64, two NoPE
# attention layers among four Mamba2 ones, the muP scalars.
SMALL = dict(FULL, num_hidden_layers=6, hidden_size=128,
             intermediate_size=256, vocab_size=512, num_attention_heads=4,
             num_key_value_heads=2, mamba_n_heads=4, mamba_d_state=16,
             layer_types=["mamba", "attention", "mamba", "mamba",
                          "attention", "mamba"])
MS = 1_000_000


def port(cfg, dtype="float32"):
    return api.build_model(get_config(cfg["arch"] if "arch" in cfg
                                      else "granite-4.0-h-micro").replace(
        **ref.port_overrides(cfg), dtype=dtype, param_dtype=dtype,
        ssm_param_dtype=dtype))


@pytest.mark.parametrize("seq", [7, 600, 2100])
def test_reference_matches_the_port(seq):
    """Float32 on both sides; the scan's forms (quadratic, chunked above
    one chunk, recurrent below) sum in other orders: measured up to
    1.5e-5 of the largest logit, bfloat16 operands move it ~1e-2. At
    2,100 positions the program's attention is chunked, padded."""
    model = port(SMALL)
    params = draw(ref.layout(SMALL), 7, "cpu", torch.float32,
                  embed_std=0.05)
    assert same_layout(params, model.abstract_params())
    toks = torch.from_numpy(np.random.default_rng(seq).integers(1, 512, seq))
    want = ref.forward(SMALL, params, toks)
    got = model.forward(params, {"tokens": toks[None]})[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(
        want.abs().max()))


def test_layout_is_the_programs_at_the_published_widths():
    """Specs and meta tensors only: the reference's layout is the program's
    tree, every leaf bfloat16, 3.19 B parameters."""
    model = port(FULL, "bfloat16")

    def meta(tree):
        if isinstance(tree, tuple):
            return torch.empty(tree[0], dtype=torch.bfloat16, device="meta")
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return {k: meta(v) for k, v in tree.items()}

    assert same_layout(meta(ref.layout(FULL)), model.abstract_params())
    assert same_layout(model.abstract_params(), api.build_model(
        get_config("granite-4.0-h-micro")).abstract_params())
    assert 3.18e9 < model.param_count() < 3.20e9
    # Two FLOPs a weight a token, but for the norms, D, A and biases.
    emb = FULL["vocab_size"] * FULL["hidden_size"]
    assert sum(hybrid.layer_fmacs_per_token(FULL)) == pytest.approx(
        model.param_count() - emb, rel=1e-3)


def test_config_holds_the_published_numbers():
    for k, v in FULL.items():
        assert CONFIG[k] == v, k
    over = ref.port_overrides(FULL)
    assert [i for i, k in enumerate(over["block_pattern"]) if k == "d"] == [
        5, 15, 25, 35]
    model = api.build_model(get_config("granite-4.0-h-micro"))
    points = model.decoupling_points()
    cut = points.index(CONFIG["serving"]["cut"])
    assert cut == 19
    assert over["block_pattern"][:cut + 1].count("M") == 18
    with pytest.raises(ValueError):
        ref.port_overrides(dict(FULL, mamba_d_head=128))


def test_harness_finds_the_cell_and_its_metrics():
    cell = harness.find_cell(ROOT, CELL)
    assert cell.config["family"] == "granite_hybrid"
    assert cell.mix["kind"] == "closed_chat"
    # No inter-token tail: about one step in twelve seats a prompt of
    # 1k-7k tokens, so the 95th percentile falls where the gaps of decode
    # steps give way to those of joins, and moves with the host's speed
    # from run to run by more than half its bound.
    assert {m["name"] for m in cell.end_to_end} == {"tokens_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"ssm_device_ms_p50.stream", "ssm_roofline_pct.stream",
            "kernels_per_step.stream", "mfu_pct.stream"} <= names
    # Nor the joins' metrics, which move that tail; besides, a join comes
    # about once a second and its step takes a quarter to half of one, so
    # the 2 s traced slice may hold no ``stream.join`` span to read.
    assert not names & {"join_step_ms_p50.stream", "join_device_ms_p50.stream",
                        "join_idle_pct.stream"}
    assert cell.own["limits"] == {"token_gap_sd": 0.25}
    # The slots hold the longest prompt and the longest output.
    assert cell.config["serving"]["cache_len"] == (
        cell.mix["prompt_tokens"][1] + cell.mix["output_tokens"][1])
    for name in names:
        assert callable(harness.metric_reader(ROOT, name))


def small_cell() -> harness.Cell:
    cell = harness.find_cell(ROOT, CELL)
    cfg = cell.config = copy.deepcopy(cell.config)
    cfg["model"] = dict(SMALL)
    cfg["serving"].update(cut="seg2_M1", slots=4, cache_len=640)
    cell.mix.update(clients=4, prompt_tokens=[300, 600],
                    output_tokens=[4, 24])
    return cell


def serve_until(system, mix, seed, finished):
    """Warm the slots as the cell does, then step until ``finished``
    requests are done, each client resubmitting as it finishes."""
    rec = harness.Record()
    closed_chat.warm(system, mix, seed, rec)
    while sum(r.done_step >= 0 for r in system.requests) < finished:
        before = {id(r) for r in system.inflight()}
        system.step()
        for r in system.requests:
            if id(r) in before and r.done_step >= 0:
                system.submit(*rec.requests.next())


def test_served_stream_is_correct_and_the_control_is_not():
    from bench.systems.stream import System
    from repro_torch.models.layers import mamba2

    cell = small_cell()
    mamba2.PREFILLS.clear()
    system = System(cell.config, 2**33 + 21, "cpu")
    calibration = mamba2.PREFILLS["recurrence"]
    serve_until(system, cell.mix, 2**33 + 21, 8)
    # Every join's prompt is longer than a chunk: no join on the recurrence.
    assert mamba2.PREFILLS["recurrence"] == calibration
    assert mamba2.PREFILLS["chunked"] >= 8 * 4
    system.close()
    limit = cell.own["limits"]["token_gap_sd"]
    sound = system.check(np.random.default_rng(1), 4)["token_gap_sd"]
    control = system.check(np.random.default_rng(1), 4,
                           control=True)["token_gap_sd"]
    assert sound <= limit < control, (sound, control)
    assert control >= 3 * sound


def ssm_stream() -> ProgramSpans:
    """Step 1 seats a request (its prefill launches 6 ms); step 2 does not:
    two Mamba2 decodes of 2 and 3 ms, one launched inside its span and run
    after it closed; step 3 has no Mamba2 decode."""
    ranges = [("stream.step", 0, 40 * MS), ("stream.join", 1 * MS, 20 * MS),
              ("ssm.prefill", 2 * MS, 8 * MS),
              ("ssm.decode", 25 * MS, 30 * MS),
              ("stream.step", 50 * MS, 80 * MS),
              ("stream.head", 51 * MS, 60 * MS),
              ("ssm.decode", 52 * MS, 55 * MS),
              ("stream.tail", 61 * MS, 70 * MS),
              ("ssm.decode", 62 * MS, 64 * MS),
              ("stream.step", 90 * MS, 95 * MS)]
    attrs = [{"active": 32}, {}, {}, {"rows": 32}, {"active": 30}, {},
             {"rows": 32}, {}, {"rows": 32}, {"active": 32}]
    launches = {1: 3 * MS, 2: 26 * MS, 3: 53 * MS, 4: 63 * MS}
    ops = [("prefill", 3 * MS, 9 * MS, 1), ("decode", 26 * MS, 29 * MS, 2),
           ("decode", 53 * MS, 55 * MS, 3), ("decode", 65 * MS, 68 * MS, 4)]
    return ProgramSpans(ranges, launches, ops, [], attrs)


def read(metric, p, monkeypatch):
    monkeypatch.setattr(program_spans, "of", lambda run: p)
    c = harness.find_cell(ROOT, CELL)
    return harness.metric_reader(ROOT, metric)(
        harness.Run(c, harness.Record(), None, 1.0))


def test_ssm_readers(monkeypatch):
    p = ssm_stream()
    assert read("ssm_device_ms_p50.stream", p, monkeypatch) == \
        pytest.approx(5.0)
    need = 2 * hybrid.ssm_decode_bytes(FULL, 30, 32)
    assert read("ssm_roofline_pct.stream", p, monkeypatch) == pytest.approx(
        100 * need / HBM_BYTES_PER_S / 5e-3)
    # One Mamba2 decode layer at 32 live rows: 52 MB of weights, 4.2 MB of
    # state a row (read and written).
    assert hybrid.ssm_decode_bytes(FULL, 32, 32) == pytest.approx(
        2 * hybrid.mamba_weight_count(FULL) + 2 * 32 * 2048 * 2
        + 2 * 32 * (64 * 128 * 64 * 4 + 3 * 4352 * 2))
    # A program without Mamba2 spans, or without their attributes.
    bare = ProgramSpans([("stream.step", 0, MS)], {}, [("k", 0, 1, 9)], [])
    unjoined = ssm_stream()
    unjoined.attrs = [None] * len(unjoined.attrs)
    assert read("ssm_device_ms_p50.stream", bare, monkeypatch) is None
    assert read("ssm_roofline_pct.stream", bare, monkeypatch) is None
    assert read("ssm_roofline_pct.stream", unjoined, monkeypatch) is None
    assert read("ssm_device_ms_p50.stream", None, monkeypatch) is None


BURST = json.loads((ROOT / "bench/traffic/fleet_burst.json").read_text())


@pytest.mark.parametrize("seed", [3, 2**33 + 9])
def test_burst_schedule(seed):
    mix = dict(BURST, rate_per_s=48.0)
    tr = fleet_burst.schedule(mix, seed, 200.0)
    n, burst = tr.n_requests, mix["burst"]
    assert n % burst == 0 and abs(n / 200.0 - 48.0) < 6.0
    assert np.all(np.diff(tr.arrival_s) >= 0) and tr.arrival_s.max() < 200
    for i in range(0, n, burst):
        due = tr.arrival_s[i:i + burst]
        devices = tr.device_ids[i:i + burst]
        assert np.all(due == due[0])
        assert len(set(devices.tolist())) == burst
    assert tr.arrival_s[burst] > tr.arrival_s[burst - 1]
    step = (tr.arrival_s / mix["dt_s"]).astype(int)
    np.testing.assert_array_equal(tr.bandwidths,
                                  tr.bw_walks[step, tr.device_ids])
    again = fleet_burst.schedule(mix, seed, 200.0)
    np.testing.assert_array_equal(again.device_ids, tr.device_ids)
    with pytest.raises(ValueError):
        fleet_burst.schedule(dict(mix, burst=17), seed, 1.0)


def test_harness_finds_the_burst_cell_by_its_entry(tmp_path):
    """``resnet50.fleet_burst`` waits for its entry in BENCHMARK.json
    (PERF.md §7): with one, the harness finds the kind, the mix and the
    cell's own file, on fleet_wifi's links and check."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench").mkdir()
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(ROOT / "bench" / sub, tmp_path / "bench" / sub)
    name = "resnet50.fleet_burst"
    bench["workloads"].append({"name": name, "config": "resnet50",
                               "traffic": "fleet_burst", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "resnet50.fleet_wifi" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(tmp_path, name)
    wifi = harness.find_cell(ROOT, "resnet50.fleet_wifi")
    assert cell.mix["kind"] == "fleet_burst"
    assert (cell.mix["n_devices"], cell.mix["burst"]) == (16, 8)
    for k in fleet_burst.WALK_KEYS + ("dt_s",):
        assert cell.mix[k] == wifi.mix[k], k
    assert cell.own["limits"] == wifi.own["limits"]
    assert cell.own["check_args"] == wifi.own["check_args"]
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in wifi.per_layer]
    assert {m["name"] for m in cell.end_to_end} == {"req_ms_p50",
                                                    "setup_s"}


class _Fleet:
    def __init__(self):
        self.calls = []

    def serve(self, uids, devices, bandwidths):
        self.calls.append((list(uids), list(devices)))
        return {"requests": len(uids), "answered": list(uids),
                "group_sizes": []}


def test_burst_warm_up_serves_whole_bursts_and_drive_answers_all():
    mix = dict(BURST, rate_per_s=200.0, warm_s=1.0)
    fleet = _Fleet()
    fleet_burst.warm(fleet, mix, 5, harness.Record())
    assert fleet.calls and all(len(u) == 8 and max(u) < 0
                               for u, _ in fleet.calls)
    assert all(len(set(d)) == 8 for _, d in fleet.calls)
    rec = harness.Record()
    fleet_burst.drive(_Fleet(), mix, 6, 0.3, rec)
    assert rec.attempted == rec.answered == len(rec.latencies_ms)
    assert all(s["requests"] % 8 == 0 for s in rec.spans)
