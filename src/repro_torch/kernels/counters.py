"""Launch counters of the kernel wrappers.

Each wrapper adds to its counter where it launches its CUDA kernel, and
nowhere else (``huffman_host_route`` counts the Huffman codec's host
route instead). The pipelined server launches kernels from its edge and
cloud threads at once, so every update takes a lock and the counts are
exact.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

NAMES = ("fused_encode", "fused_decode", "huffman_pack", "huffman_host_route",
         "pc_encode", "pc_decode", "minmax_blocks", "quantize_blocks",
         "pack4_blocks", "kv8_append", "kv8_attend")

_COUNTS: Dict[str, int] = dict.fromkeys(NAMES, 0)
_LOCK = threading.Lock()


def bump(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def launch_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def reset_launch_counts() -> None:
    with _LOCK:
        for name in _COUNTS:
            _COUNTS[name] = 0


class _Box:
    counts: Dict[str, int] = {}


@contextlib.contextmanager
def count_launches():
    """Counts made inside the block: ``box.counts`` maps each counter to
    its increase."""
    box = _Box()
    start = launch_counts()
    try:
        yield box
    finally:
        end = launch_counts()
        box.counts = {k: end[k] - start[k] for k in end}
