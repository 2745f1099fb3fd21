"""The port's examples (``examples/*_torch.py``) run with ``--device cpu``
(``train_lm_torch.py`` at ``--tiny``) and print the reference examples'
columns and lines; ``train_lm``'s "loss did not improve" and the others'
own checks hold. Each runs in a subprocess with two threads."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"olmo-1b": "dense", "grok-1-314b": "moe", "xlstm-1.3b": "ssm",
            "zamba2-2.7b": "hybrid", "qwen2-vl-7b": "vlm",
            "seamless-m4t-large-v2": "audio"}


def _run(name: str, *extra: str) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
         "--device", "cpu", *extra], env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart():
    out = _run("quickstart")
    assert re.search(r"^model: resnet50 \([\d.]+M params, 20 decoupling "
                     r"points\) on cpu$", out, re.M)
    assert "calibrated A_i(c), S_i(c): base accuracy" in out
    plans = re.findall(r"^BW +(\d+) KB/s -> cut after '\w+' \(#(\d+)\), "
                       r"c=(\d+) bits, predicted [\d.]+ ms \(solved in "
                       r"[\d.]+ ms\)$", out, re.M)
    assert [p[0] for p in plans] == ["10000", "1000", "50"]
    m = re.search(r"^decoupled inference: sent (\d+) B \(raw boundary (\d+) "
                  r"B, ([\d.]+)x compression\), top-1 agreement with the "
                  r"undecoupled model: ([\d.]+)%$", out, re.M)
    assert m and int(m.group(1)) < int(m.group(2))


def test_edge_cloud_serving():
    out = _run("edge_cloud_serving")
    header = (f"{'BW':>8} {'cut':>5} {'bits':>4} {'edge':>8} {'xfer':>8} "
              f"{'cloud':>8} {'total':>8} {'sent':>8}")
    assert header in out.splitlines()
    rows = re.findall(r"^ *(\d+)KB +(\d+) +(\d+) +[\d.]+m +[\d.]+m +[\d.]+m "
                      r"+[\d.]+m +\d+B$", out, re.M)
    assert [int(r[0]) for r in rows] == [10000, 4000, 1500, 600, 100, 50,
                                         100, 600, 4000, 10000]
    assert len({r[1] for r in rows}) > 1           # the cut moved
    assert re.search(r"^latency stability: max/min = [\d.]+x over a 200x "
                     r"bandwidth swing$", out, re.M)
    assert re.search(r"^adaptation events: [1-9]\d*$", out, re.M)


def test_multiarch_decoupling():
    out = _run("multiarch_decoupling")
    header = (f"{'arch':28s} {'family':7s} {'cut':>4} {'raw B':>9} "
              f"{'sent B':>8} {'ratio':>6} {'agree':>6}")
    assert header in out.splitlines()
    rows = re.findall(r"^(\S+) +(\w+) +(\d+) +(\d+) +(\d+) +([\d.]+)x "
                      r"+([\d.]+)%$", out, re.M)
    assert {r[0]: r[1] for r in rows} == FAMILIES
    for r in rows:
        assert int(r[4]) < int(r[3])               # compressed
    assert "JALAD's cut+compress applies to every assigned family" in out


def test_train_lm():
    out = _run("train_lm", "--tiny")
    assert re.search(r"^training olmo-1b-family model: [\d.]+M params, 30 "
                     r"steps, batch 8 x seq 64 on cpu$", out, re.M)
    m = re.search(r"^loss: ([\d.]+) -> ([\d.]+) \([\d.]+ steps/s\)$", out,
                  re.M)
    assert m and float(m.group(2)) < float(m.group(1))
    assert "OK: loss improved" in out
