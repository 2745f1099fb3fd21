"""The wire kernels' share of their HBM roofline in the traced slice: the
bytes the encodes and decodes of the slice's requests need
(bench/counts/codec.py) at 3.35 TB/s, over the device time of the
kernels of K1 (bitpack encode), K2 (wire decode), K4 (per-channel
encode) and K5 (per-channel decode)."""
import re

from bench.counts.peaks import HBM_BYTES_PER_S

KERNELS = re.compile(r"\b(fused_encode_kernel|dequant_kernel|"
                     r"pc_encode_kernel|pc_decode_kernel|"
                     r"pc_decode_tiled_kernel)\b")


def read(run):
    t = run.trace
    if t is None:
        return None
    work = sum(s["codec_bytes"] for s in run.spans("serve", part="traced"))
    spent = sum(b - a for _, a, b in t.kernels_matching(KERNELS)) * 1e-9
    if not work or spent <= 0:
        return None
    return 100.0 * work / HBM_BYTES_PER_S / spent
