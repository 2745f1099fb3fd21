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
        "print(len(mods), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split(" ", 1)
    assert int(out[0]) >= 25          # every module of the port was imported
    assert out[1].strip() == "[]"


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.codec import get_codec
    from repro_torch.config import JaladConfig, get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.serving.edge_cloud import build_edge_cloud_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("resnet50").reduced()
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: build_model(cfg).init(0),
        lambda: params_from_numpy({"w": np.zeros(2)}),
        lambda: get_codec("huffman").decode(
            get_codec("huffman").encode(torch.ones(3), 4)),
        lambda: build_edge_cloud_server(cfg, JaladConfig(), calib_batches=1,
                                        calib_batch_size=1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_device_resolution_turns_tf32_off(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    resolve_device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


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


def test_unported_serve_modes_raise():
    from repro_torch.launch.serve import main

    for argv in (["--arch", "resnet50", "--jalad", "--pipeline"],
                 ["--arch", "olmo-1b", "--continuous"],
                 ["--arch", "resnet50"]):
        with pytest.raises(NotImplementedError):
            main(argv)


def test_serve_cli_runs_on_the_cpu(caplog):
    from repro_torch.launch.serve import main

    with caplog.at_level("INFO"):
        assert main(["--arch", "vgg16", "--reduced", "--jalad", "--device",
                     "cpu", "--calib", "1", "--batch", "2", "--requests",
                     "2", "--codec", "bitpack"]) == 0
    assert "codec=bitpack" in caplog.text or "codec=png" in caplog.text
