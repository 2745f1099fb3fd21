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
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

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
# The recurrent-LM slice's modules (ssm and hybrid families, the two dense
# configs added beside them).
SSM_MODULES = (
    "repro_torch.configs.xlstm_1_3b", "repro_torch.configs.zamba2_2_7b",
    "repro_torch.configs.yi_6b", "repro_torch.configs.granite_34b",
    "repro_torch.models.layers.mamba2", "repro_torch.models.layers.xlstm",
)
# The compression shim and the paper's channel removal.
CORE_MODULES = ("repro_torch.core.compression",
                "repro_torch.core.channel_removal")
# The vlm and audio families' configs.
MM_MODULES = ("repro_torch.configs.qwen2_vl_7b",
              "repro_torch.configs.seamless_m4t_large_v2")
# Training and checkpoints.
TRAIN_MODULES = ("repro_torch.optim.adamw", "repro_torch.training.loop",
                 "repro_torch.checkpoint.store", "repro_torch.launch.train",
                 "repro_torch.utils.log", "repro_torch.utils.tree")
# The meshed cloud.
MESH_MODULES = ("repro_torch.sharding", "repro_torch.sharding.rules",
                "repro_torch.sharding.activation", "repro_torch.launch.mesh",
                "repro_torch.serving.meshed")
# The step accounting and the dry run.
DRYRUN_MODULES = ("repro_torch.launch.dryrun",
                  "repro_torch.launch.step_analysis")


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
                         capture_output=True, text=True,
                         timeout=300).stdout.split(" ")
    assert int(out[0]) >= 84          # every module of the port was imported
    assert out[1].strip() == "[]"
    assert set(LM_MODULES + SSM_MODULES + CORE_MODULES + MM_MODULES
               + TRAIN_MODULES + MESH_MODULES + DRYRUN_MODULES) <= \
        set(out[2].strip().split(","))


def _imported_modules(path: Path) -> set:
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_scripts_import_neither_jax_nor_the_reference():
    """The port's examples and scripts beside the reference's
    (``examples/*_torch.py``, ``scripts/*_torch.py``) and
    ``chip_smoke.py`` import no ``jax`` and nothing of ``repro`` but
    ``repro_torch``."""
    root = SRC.parent
    files = sorted(root.glob("examples/*_torch.py")) + \
        sorted(root.glob("scripts/*_torch.py")) + [root / "chip_smoke.py"]
    assert {f.name for f in files} >= {
        "quickstart_torch.py", "edge_cloud_serving_torch.py",
        "multiarch_decoupling_torch.py", "train_lm_torch.py",
        "hillclimb_torch.py", "extrapolate_heavy_torch.py"}
    for f in files:
        mods = _imported_modules(f)
        bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                            "repro"))
        assert bad == [], (f.name, bad)
        assert any(m.startswith("repro_torch") for m in mods), f.name


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
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch import mesh

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
        lambda: train_main(["--arch", "olmo-1b", "--reduced"]),
        lambda: mesh.init_process_group(),
        lambda: mesh.make_host_mesh(),
        lambda: mesh.make_production_mesh(),
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


def _kv8_block(device):
    """A reduced olmo-1b attention block with an int8 KV cache: its
    parameters, one decode token's input and context, and a cache of 2
    rows x 8 slots holding a few written positions, all on ``device``."""
    from repro_torch.config import get_config
    from repro_torch.models import blocks
    from repro_torch.models.api import build_model
    from repro_torch.utils.tree import tree_map

    cfg = get_config("olmo-1b").reduced().replace(kv_cache_bits=8)
    params = tree_map(lambda t: t[0], build_model(cfg).init(0, "cpu")
                      ["segments"][0])
    g = torch.Generator().manual_seed(0)
    cache = blocks.init_block_cache("d", cfg, 2, 8, torch.float32)
    for key in ("k", "v"):
        cache[key].copy_(torch.randint(-127, 128, cache[key].shape,
                                       generator=g))
    for key in ("ks", "vs"):
        cache[key].copy_(torch.rand(cache[key].shape, generator=g) * 0.1)
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    ctx = blocks.DecodeContext(torch.tensor([3, 9]), 0,
                               torch.tensor([True, False]))
    move = lambda t: t.to(device)  # noqa: E731
    return (cfg, tree_map(move, params), move(x),
            {k: move(t) for k, t in cache.items()},
            ctx._replace(pos=move(ctx.pos), live=move(ctx.live)))


def test_kv8_decode_never_falls_back_and_blocks_route_by_input(monkeypatch):
    """The int8 KV decode wrapper raises for a meta tensor (no plain
    fallback). ``block_apply_decode`` hands plain CPU tensors to the
    wrapper and keeps the plain composition for meta and DTensor caches,
    whose results equal the wrapper's CPU route."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.attention import ops as aops
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import blocks
    from repro_torch.utils.tree import tree_map

    cfg, params, x, cache, ctx = _kv8_block("meta")
    q = torch.empty((2, 1, cfg.num_heads, cfg.head_dim_), device="meta")
    kv = torch.empty((2, 1, cfg.num_kv_heads, cfg.head_dim_), device="meta")
    with pytest.raises(ValueError, match="kv8_decode"):
        aops.kv8_decode(q, kv, kv, cache, ctx.pos, ctx.live)

    routes = []
    kernel, plain = aops.kv8_decode, aops.kv8_decode_plain
    monkeypatch.setattr(aops, "kv8_decode", lambda *a: routes.append(
        "wrapper") or kernel(*a))
    monkeypatch.setattr(aops, "kv8_decode_plain", lambda *a: routes.append(
        "plain") or plain(*a))
    out, _ = blocks.block_apply_decode("d", params, x, cache, ctx, cfg)
    assert out.device.type == "meta" and routes == ["plain"]

    cfg, params, x, cache, ctx = _kv8_block("cpu")
    ref_cache = {k: t.clone() for k, t in cache.items()}
    routes.clear()
    want, _ = blocks.block_apply_decode("d", params, x, ref_cache, ctx, cfg)
    assert routes == ["wrapper", "plain"]

    started = not dist.is_initialized()
    assert init_process_group("cpu") == (0, 1)
    try:
        mesh = make_host_mesh(device="cpu")

        def dt(t):
            return distribute_tensor(t, mesh, [Replicate(), Replicate()])

        sharded = {k: dt(t) for k, t in cache.items()}
        routes.clear()
        with implicit_replication():
            got, _ = blocks.block_apply_decode("d", tree_map(dt, params),
                                               dt(x), sharded, ctx, cfg)
        assert routes == ["plain"]
        assert torch.equal(got.full_tensor(), want)
        for k, t in sharded.items():
            assert torch.equal(t.full_tensor(), ref_cache[k]), k
    finally:
        if started:
            dist.destroy_process_group()
