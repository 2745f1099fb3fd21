"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. The first
:func:`load` builds every source that is not built yet, all ``nvcc``
processes started together, into ``build/repro_torch/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it). A library's file name
carries a hash of its source and of the shared headers (``csrc/*.cuh``),
so an edited source or header rebuilds and a stale library is never
loaded.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, IEEE
division and square root (nvcc's default; never ``--use_fast_math``), and
``-Xptxas -v`` whose register / shared-memory report lands in
``<name>.ptxas.txt`` beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("quantize", "huffman_pack", "perchannel", "threelaunch",
           "kv8_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels build "
                       "only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name in [n for n, p in paths.items() if not p.exists()]:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                _LIBS[n] = ctypes.CDLL(str(p))
            lib = _LIBS[name]
        return lib


def check(status: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"repro_torch: {what} failed with CUDA error "
                           f"{status}")
