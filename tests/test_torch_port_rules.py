"""Rules of the port: ``repro_torch`` imports neither JAX nor anything of
the reference package ``repro``; its entry points run on the CUDA card by
default and raise without one unless the CPU is asked for; its kernel
wrappers run the plain version only for CPU tensors."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


# The dense-LM serving slice's modules: the sweep must reach each of them.
LM_MODULES = (
    "repro_torch.configs.olmo_1b", "repro_torch.configs.qwen3_8b",
    "repro_torch.models.layers.norms", "repro_torch.models.layers.rope",
    "repro_torch.models.layers.mlp", "repro_torch.models.layers.attention",
    "repro_torch.models.blocks", "repro_torch.models.transformer",
    "repro_torch.serving.scheduler", "repro_torch.serving.engine",
    "repro_torch.serving.streaming",
)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(mods), bad, ','.join(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split(" ")
    assert int(out[0]) >= 56          # every module of the port was imported
    assert out[1].strip() == "[]"
    assert set(LM_MODULES) <= set(out[2].strip().split(","))


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.codec import get_codec
    from repro_torch.config import JaladConfig, get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.config.types import EDGE_TX2
    from repro_torch.serving.edge_cloud import build_edge_cloud_server
    from repro_torch.serving.fleet import build_fleet_server
    from repro_torch.serving.three_tier import build_three_tier_server
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("resnet50").reduced()
    lm = build_model(get_config("olmo-1b").reduced())
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: build_model(cfg).init(0),
        lambda: params_from_numpy({"w": np.zeros(2)}),
        lambda: get_codec("huffman").decode(
            get_codec("huffman").encode(torch.ones(3), 4)),
        lambda: build_edge_cloud_server(cfg, JaladConfig(), calib_batches=1,
                                        calib_batch_size=1),
        lambda: build_fleet_server(cfg, JaladConfig(), [EDGE_TX2],
                                   calib_batches=1, calib_batch_size=1),
        lambda: build_three_tier_server(cfg, JaladConfig(), [EDGE_TX2],
                                        calib_batches=1, calib_batch_size=1),
        lambda: lm.init(0),
        lambda: lm.init_caches(1, 4),
        lambda: build_edge_cloud_server(lm.cfg, JaladConfig(),
                                        calib_batches=1, calib_batch_size=1,
                                        seq_len=4),
        lambda: main(["--arch", "olmo-1b", "--reduced", "--continuous"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_device_resolution_turns_tf32_off(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    resolve_device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not (torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction)


def test_wrappers_never_fall_back_for_other_devices():
    from repro_torch.kernels.entropy import ops as eops
    from repro_torch.kernels.quantize import ops as qops

    meta = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError):
        qops.fused_encode(meta, 8)
    with pytest.raises(ValueError):
        qops.fused_decode(torch.empty((1, 8), dtype=torch.uint8,
                                      device="meta"),
                          torch.zeros(1, device="meta"),
                          torch.ones(1, device="meta"), 8, 8, False)
    lut = torch.zeros((1, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        eops.huffman_pack(meta, torch.zeros(1, device="meta"),
                          torch.ones(1, device="meta"), lut,
                          lut.to(torch.uint8), 8, 128)
    with pytest.raises(ValueError):
        qops.pc_encode(torch.empty((1, 2, 8), device="meta"), 8, 0)
    with pytest.raises(ValueError):
        qops.minmax_blocks(meta)
    with pytest.raises(ValueError):
        qops.quantize_blocks(meta, torch.zeros((), device="meta"),
                             torch.ones((), device="meta"), 8)
    with pytest.raises(ValueError):
        qops.pack4_blocks(torch.empty(8, dtype=torch.uint8, device="meta"))
    ranges = torch.zeros((1, 2), device="meta")
    with pytest.raises(ValueError):
        qops.pc_decode(torch.empty((1, 2, 2), dtype=torch.int32,
                                   device="meta"),
                       ranges, ranges, 8, (2, 8), 0)


def test_unported_serve_modes_raise():
    """Token generation needs a decoder: a CNN without ``--jalad`` raises,
    in both LM modes. (The continuous-batching mode itself is ported: it
    runs on the CPU in ``test_torch_lm_serving.py``.)"""
    from repro_torch.launch.serve import main

    for argv in (["--arch", "resnet50", "--reduced", "--device", "cpu",
                  "--continuous"],
                 ["--arch", "resnet50", "--reduced", "--device", "cpu"]):
        with pytest.raises(ValueError, match="autoregressive"):
            main(argv)


def test_serve_cli_runs_on_the_cpu(caplog):
    from repro_torch.launch.serve import main

    with caplog.at_level("INFO"):
        assert main(["--arch", "vgg16", "--reduced", "--jalad", "--device",
                     "cpu", "--calib", "1", "--batch", "2", "--requests",
                     "2", "--codec", "bitpack"]) == 0
    assert "codec=bitpack" in caplog.text or "codec=png" in caplog.text


def test_pipelined_serve_cli_runs_on_the_cpu(caplog):
    from repro_torch.launch.serve import main

    with caplog.at_level("INFO"):
        assert main(["--arch", "resnet50", "--reduced", "--jalad",
                     "--pipeline", "--device", "cpu", "--calib", "1",
                     "--batch", "2", "--requests", "3", "--codec",
                     "auto"]) == 0
    assert caplog.text.count(" point=") == 3
    assert "pipelined makespan" in caplog.text
