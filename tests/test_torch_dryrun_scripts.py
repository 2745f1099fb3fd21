"""The dry run's scripts on the port: ``scripts/hillclimb_torch.py``
(rule-table variants over ``launch/dryrun.py`` ``dryrun_one(rules=,
overrides=)``), ``scripts/extrapolate_heavy_torch.py`` (the affine fit in
depth) and the reference's ``scripts/render_roofline_md.py`` reading the
port's records.

* **The depth fit is exact where the layers are alike.** Reduced olmo-1b
  counted at L = 2 and L = 6 and fitted by a + b * L gives the direct
  count at L = 8: FLOPs and argument bytes exactly, bytes within 1 %, in
  each mode, on one device. At full width on the fake 16 x 16 world
  (olmo-1b x decode_32k, the script itself in a subprocess), the
  extrapolated record equals the dry run's own count at 16 layers in the
  same way, and carries the reference script's keys.
* **The hillclimb's baseline is the dry run.** Its record equals
  ``python -m repro_torch.launch.dryrun``'s key for key (but the count's
  seconds), plus ``variant``, ``remat`` and ``microbatches``.
* **The roofline table renders** both records.

The three CLI processes run side by side with one thread each (~20 s).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

from repro_torch.config import ShapeConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.launch.dryrun import count_fake_step  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = {"train": ("tiny_train", 32, 4, "train"),
        "prefill": ("tiny_prefill", 32, 2, "prefill"),
        "decode": ("tiny_decode", 32, 2, "decode")}
FULL_DEPTH = 8
BYTES_BAND = 0.01
ARCH, SHAPE = "olmo-1b", "decode_32k"


def _script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", list(TINY))
def test_depth_fit_gives_the_direct_count(mode):
    ex = _script("extrapolate_heavy_torch")
    base = get_config("olmo-1b").reduced()
    shape = ShapeConfig(*TINY[mode])
    tc = TrainConfig(remat="blocks")
    counts = ex.count_depths(base, shape, tc, None)
    fit = ex.depth_fit(counts, FULL_DEPTH)
    direct = count_fake_step(build_model(ex.at_depth(base, FULL_DEPTH)),
                             shape, tc, None)
    assert counts[ex.L_SMALL].flops < counts[ex.L_BIG].flops < direct.flops
    assert fit(lambda c: c.flops) == direct.flops
    assert fit(lambda c: c.argument_bytes) == direct.argument_bytes
    got = fit(lambda c: c.bytes_accessed)
    assert abs(got / direct.bytes_accessed - 1) <= BYTES_BAND


def test_parse_variant():
    hc = _script("hillclimb_torch")
    assert hc.parse_variant("tp_weights+kv8") == (
        "tp_weights", {"kv_cache_bits": 8})
    assert hc.parse_variant("+kv8") == ("baseline", {"kv_cache_bits": 8})
    assert hc.parse_variant("pure_dp") == ("pure_dp", {})
    assert hc.VARIANTS["baseline"] is None
    with pytest.raises(SystemExit):
        hc.main([ARCH, SHAPE, "no_such_variant"])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The three CLIs' records of olmo-1b x decode_32k, side by side."""
    d = tmp_path_factory.mktemp("dryrun_scripts")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    jobs = {
        "dryrun": ["-m", "repro_torch.launch.dryrun", "--arch", ARCH,
                   "--shape", SHAPE, "--out", str(d / "dryrun.jsonl")],
        "hillclimb": [str(ROOT / "scripts" / "hillclimb_torch.py"), ARCH,
                      SHAPE, "baseline", "--out",
                      str(d / "hillclimb.jsonl")],
        "extrapolate": [str(ROOT / "scripts" / "extrapolate_heavy_torch.py"),
                        ARCH, SHAPE, "--out", str(d / "extrapolate.jsonl")],
    }
    procs = {k: subprocess.Popen([sys.executable, *argv], cwd=str(d),
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, argv in jobs.items()}
    out, fails = {}, []
    for k, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            fails.append(f"{k} rc={proc.returncode}:\n{log[-3000:]}")
            continue
        lines = (d / f"{k}.jsonl").read_text().splitlines()
        assert len(lines) == 1
        out[k] = json.loads(lines[0])
    assert not fails, "\n".join(fails)
    out["dir"] = d
    return out


def test_hillclimb_baseline_equals_the_dry_run(records):
    hc, dr = records["hillclimb"], records["dryrun"]
    assert (hc.pop("variant"), hc.pop("remat"), hc.pop("microbatches")) == \
        ("baseline", "blocks", 1)
    assert list(hc) == list(dr)
    for k in dr:
        if k != "count_s":
            assert hc[k] == dr[k], k


def _reference_record_keys():
    """The keys of the record ``scripts/extrapolate_heavy.py`` writes."""
    tree = ast.parse((ROOT / "scripts" / "extrapolate_heavy.py").read_text())
    keys = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "rec":
            keys += [k.value for k in node.value.keys]
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and getattr(
                node.targets[0].value, "id", None) == "rec":
            keys.append(node.targets[0].slice.value)
    return keys


def test_extrapolated_record_equals_the_full_count(records):
    ex, dr = records["extrapolate"], records["dryrun"]
    assert list(ex) == _reference_record_keys()
    assert ex["source"] == "extrapolated(L2,L6)"
    assert (ex["mesh"], ex["chips"], ex["mode"]) == ("16x16", 256, "decode")
    assert ex["flops_per_device"] == dr["flops_per_device"]
    assert ex["argument_bytes"] == dr["argument_bytes"]
    assert abs(ex["bytes_accessed_per_device"]
               / dr["bytes_accessed_per_device"] - 1) <= BYTES_BAND
    for k in ("analytic_flops_global", "model_flops_global", "compute_s"):
        assert ex[k] == dr[k], k


def test_render_roofline_reads_port_records(records):
    d = records["dir"]
    rows = {}
    for name in ("dryrun", "extrapolate"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "render_roofline_md.py"),
             str(d / f"{name}.jsonl")], check=True, capture_output=True,
            text=True, timeout=60).stdout.splitlines()
        assert out[0].startswith("| arch | shape | compute ms")
        rows[name] = next(r for r in out if f"| {SHAPE} |" in r)
    r = records["dryrun"]
    assert rows["dryrun"] == (
        f"| {ARCH} | {SHAPE} | {r['compute_s'] * 1e3:.2f} | "
        f"{r['memory_s'] * 1e3:.2f} | {r['collective_s'] * 1e3:.2f} | "
        f"{r['dominant']} | {r['useful_flops_fraction']:.2f} | "
        f"{r['hbm_gib_per_device']:.2f} | dry-run |")
    assert rows["extrapolate"].endswith("| extrapolated(L2,L6) |")
