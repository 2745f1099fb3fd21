#!/usr/bin/env python3
"""Time the port's encode kernels K1 (``fused_encode``), K3
(``huffman_pack``) and K4 (``pc_encode``) of one checkout on one CUDA
card, and the Huffman encode's phase 1 (``_hist_ranges``: the ranges and
the histogram, PyTorch operations on the card) that feeds K3.

  python3 scripts/time_codec_kernels.py [--root DIR] [--label NAME]
      [--json PATH]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernels into ``DIR/build``, so that two checkouts can be timed
in turns on one card: for example a parent commit unpacked with ``git
archive`` into a git-ignored directory, run parent, change, change,
parent. Shapes, widths and clocks are ``chip_smoke.py``'s: K1 and K3 on
the stem, res5 and odd boundaries taken as one tensor at 2, 4, 8 and 16
bits, K1 also on the served shapes (``K1_SHAPES``) at 2 and 8 bits; K4
on the stem, res5, gap and odd boundaries (one sample) at 2, 3, 4, 5, 8
and 16 bits; "ms" is the median CUDA-event time of one call with
the L2 cache flushed before it, "warm_ms" the profiler's device time a
call over 20 back-to-back calls, with the device operations a call runs.
Prints the card and one JSON object; ``--json`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose repro_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                    # timing helpers and shapes

    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_codec_kernels: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels.entropy import ops as eops
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    if Path(repro_torch.__file__).resolve().parents[1] != root / "src":
        print(f"time_codec_kernels: imported {repro_torch.__file__}, not "
              f"{root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def timed(kernel, label, bits, fn, nbytes):
        ms = cs.device_ms(torch, fn, flush)
        warm, ops = cs.profiled_ms(torch, fn)
        rows.append(dict(kernel=kernel, shape=label, bits=bits, ms=ms,
                         warm_ms=warm, device_ops=ops,
                         bound_ms=cs.bound_ms(nbytes)))
        print(f"  {kernel:12s} {label:9s} {bits:2d} bits  {ms:.4f} ms, warm "
              f"{warm} ms, bound {rows[-1]['bound_ms']:.4f}; {ops}")

    def k1(label, xb, bits):
        got = qops.fused_encode(xb, bits)
        want = qref.fused_encode_ref(xb, bits)
        if not (torch.equal(got[0], want[0])
                and cs.same_bits(got[1], want[1])
                and cs.same_bits(got[2], want[2])):
            raise SystemExit(f"K1 differs from its plain version at "
                             f"{label} {bits}")
        timed("fused_encode", label, bits, lambda: qops.fused_encode(xb,
                                                                     bits),
              4 * xb.numel() + got[0].numel() * got[0].element_size()
              + 8 * xb.shape[0])

    for label, shape in cs.SHAPES.items():
        xb = torch.relu(torch.randn(shape, device=dev, generator=gen)
                        ).reshape(1, -1)
        for bits in cs.BITS:
            k1(label, xb, bits)
    for label, shape in cs.K1_SHAPES.items():
        xb = torch.relu(torch.randn(shape, device=dev, generator=gen))
        for bits in cs.K1_BITS:
            k1(label, xb, bits)
    for label, shape in cs.SHAPES.items():
        xb = torch.relu(torch.randn(shape, device=dev, generator=gen)
                        ).reshape(1, -1)
        n = xb.shape[1]
        for bits in cs.BITS:
            hist, mn, _, scale = eops._hist_ranges(xb, bits)
            timed("hist_ranges", label, bits,
                  lambda: eops._hist_ranges(xb, bits),
                  4 * n + 8 * (1 << bits) + 12)
            code_of, len_of, _, total = eops._sample_table(
                hist.cpu().numpy()[0], 1 << bits)
            clut = torch.from_numpy(code_of.view(np.int32)[None]).to(dev)
            llut = torch.from_numpy(len_of[None]).to(dev)
            w_words = eops._w_words(total)
            pack = (xb, mn, scale, clut, llut, bits, w_words)
            if not torch.equal(eops.huffman_pack(*pack),
                               eops.huffman_pack_ref(*pack)):
                raise SystemExit(f"K3 differs from its plain version at "
                                 f"{label} {bits}")
            timed("huffman_pack", label, bits,
                  lambda: eops.huffman_pack(*pack),
                  4 * n + 8 + 5 * (1 << bits) + (total + 7) // 8)
    for label, (shape, axis) in cs.PC_SHAPES.items():
        xb = torch.relu(torch.randn((1,) + shape, device=dev, generator=gen))
        outer, c, inner = qref.channel_dims(shape, axis)
        n = outer * c * inner
        for bits in cs.PC_BITS:
            got = qops.pc_encode(xb, bits, axis)
            want = qref.pc_encode_ref(xb, bits, axis)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"K4 differs from its plain version at "
                                 f"{label} {bits}")
            timed("pc_encode", label, bits,
                  lambda: qops.pc_encode(xb, bits, axis),
                  4 * n + 4 * got[0].numel() + 8 * c)
    out = {"label": args.label or str(root), "card": cs.card_line(),
           "torch": torch.__version__, "rows": rows}
    print(out["card"])
    print(json.dumps(out))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
