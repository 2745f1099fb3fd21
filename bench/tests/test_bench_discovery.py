"""The harness finds a cell, a configuration, a traffic mix and a per-layer
metric by the names in BENCHMARK.json; new ones come as new files."""
import json
import shutil
import sys
import types
from pathlib import Path

import pytest

from bench import harness, systems

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.find_cell(ROOT, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.mix["kind"] in ("fleet_open", "closed_chat")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.own["limits"]) and c.own["check_sample"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(ROOT, metric))


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]


def test_new_cell_config_and_metric_found_by_name(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (tmp_path / "bench" / sub).mkdir(parents=True)
    shutil.copy(ROOT / "bench/configs/resnet50.json",
                tmp_path / "bench/configs/toy.json")
    (tmp_path / "bench/traffic/rush.json").write_text(json.dumps(
        {"kind": "fleet_open", "trace": "diurnal", "n_devices": 4,
         "dt_s": 0.1, "rate_per_s": 8.0}))
    (tmp_path / "bench/workloads/toy.rush.json").write_text(json.dumps(
        {"traffic_params": {"rate_per_s": 12.0}, "check_sample": 2,
         "limits": {"logits_rel_err": 1e-3}}))
    (tmp_path / "bench/metrics/calls.toy.py").write_text(
        "def read(run):\n    return float(len(run.record.spans))\n")
    bench["configs"].append({"name": "toy", "source": "x",
                             "file": "bench/configs/toy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy.rush", "config": "toy",
                               "traffic": "rush", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("toy.rush")
    bench["per_layer"].append({"name": "calls.toy", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "fleet server",
                               "moves": "req_ms_p50",
                               "workloads": ["toy.rush"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(tmp_path, "toy.rush")
    assert cell.mix["rate_per_s"] == 12.0 and cell.mix["trace"] == "diurnal"
    assert [m["name"] for m in cell.per_layer] == ["calls.toy"]
    assert {m["name"] for m in cell.end_to_end} == {"req_ms_p50", "setup_s"}
    rec = harness.Record(spans=[{"name": "serve"}] * 3)
    read = harness.metric_reader(tmp_path, "calls.toy")
    assert read(harness.Run(cell, rec, None, 1.0)) == 3.0


# What each system reads from its configuration's family module.
NEEDS = {"fleet": ("layout", "forward", "port_overrides", "boundary_shape",
                   "flops_per_image"),
         "stream": ("layout", "forward", "port_overrides", "prefill_flops",
                    "decode_flops")}


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_family_offers_what_its_system_reads(config):
    data = json.loads((ROOT / config["file"]).read_text())
    ref = systems.family(data)
    assert ref.__name__ == f"bench.reference.{data['family']}"
    for name in NEEDS[data["system"]]:
        assert callable(getattr(ref, name)), name


def test_new_family_found_by_name(monkeypatch):
    toy = types.ModuleType("bench.reference.toy")
    monkeypatch.setitem(sys.modules, "bench.reference.toy", toy)
    assert systems.family({"family": "toy"}) is toy


def test_cell_keys_live_in_benchmark_only(tmp_path):
    """A cell's configuration, mix and cards come from BENCHMARK.json; its
    own file holds no copy of them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench").mkdir()
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(ROOT / "bench" / sub, tmp_path / "bench" / sub)
    entry = bench["workloads"][0]
    entry["chips"] = 4
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(tmp_path, entry["name"])
    assert cell.entry["chips"] == 4
    for w in bench["workloads"]:
        own = json.loads((ROOT / f"bench/workloads/{w['name']}.json")
                         .read_text())
        assert not {"config", "traffic", "chips"} & set(own), w["name"]
