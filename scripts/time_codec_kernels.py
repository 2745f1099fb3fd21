#!/usr/bin/env python3
"""Time the port's encode kernels K1 (``fused_encode``), K3
(``huffman_pack``), K4 (``pc_encode``), K6a (``minmax_blocks``), K6b
(``quantize_blocks``) and K6c (``pack4_blocks``) and the three-launch chain
(``quantize_pack_threelaunch``) of one checkout on one CUDA card, and the
Huffman encode's phase 1 (``_hist_ranges``: the ranges and the histogram,
PyTorch operations on the card) that feeds K3.

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
and 16 bits; K6a, K6b (8 bits), K6c (on K6b's 4-bit codes, held equal
to its plain version) and the chain (4 and 8 bits, held equal to K1) on
the stem, res5 and odd boundaries. K6a and K6b are called as the
checkout defines them: ``minmax_blocks(x)`` returning the folded range or
per-block partials, ``quantize_blocks(x, mn, mx, bits)`` or ``(x, mn,
scale, bits)`` with the scale taken beforehand; the chain has one
signature everywhere. "ms" is the median CUDA-event time of one call with
the L2 cache flushed before it, "warm_ms" the profiler's device time a
call over 20 back-to-back calls, with the device operations a call runs
(their count is printed, their names are in the JSON).
Last, K2 (``fused_decode``), K6a, K6b and the chain at the stem at 8 bits
are timed cold twice: with the flush above (zeroing 64 MB, which leaves
the L2 full of dirty lines) and with a flush that then reads a second
64 MB buffer, so that the L2 holds clean lines ("flush" dirty / clean).
Prints the card and one JSON object; ``--json`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import inspect
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
    ap.add_argument("--only", default="k1,k3,k4,k6",
                    help="comma-separated kernel groups to time (k1: K1; "
                         "k3: K3 and its phase 1; k4: K4; k6: K6a, K6b, "
                         "K6c, the chain and the flush study)")
    args = ap.parse_args(argv)
    groups = set(args.only.split(","))
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
        print(f"  {kernel:12s} {label:9s} {bits or '-':>2} bits  {ms:.4f} "
              f"ms, warm {warm} ms, bound {rows[-1]['bound_ms']:.4f}; "
              f"{sum(ops.values())} device operations a call")

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

    if "k1" in groups:
        for label, shape in cs.SHAPES.items():
            xb = torch.relu(torch.randn(shape, device=dev, generator=gen)
                            ).reshape(1, -1)
            for bits in cs.BITS:
                k1(label, xb, bits)
        for label, shape in cs.K1_SHAPES.items():
            xb = torch.relu(torch.randn(shape, device=dev, generator=gen))
            for bits in cs.K1_BITS:
                k1(label, xb, bits)
    if "k3" in groups:
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
    if "k4" in groups:
        for label, (shape, axis) in cs.PC_SHAPES.items():
            xb = torch.relu(torch.randn((1,) + shape, device=dev,
                                        generator=gen))
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
    # K6a, K6b and the chain, as this checkout defines K6a and K6b.
    folded = "mx" in inspect.signature(qops.quantize_blocks).parameters
    if not folded:
        from repro_torch.core.quantization import affine_scale

    def k6(label, x):
        n = x.numel()
        _, mn, mx = qops.quantize_pack_threelaunch(x, 8)
        got = qops.minmax_blocks(x)
        if folded and not (cs.same_bits(got[0], mn)
                           and cs.same_bits(got[1], mx)):
            raise SystemExit(f"K6a differs from the chain's range at {label}")
        third = mx if folded else affine_scale(mn, mx, 8)
        k6a = ("minmax_blocks", lambda: qops.minmax_blocks(x), 4 * n + 8)
        k6b = ("quantize_blocks", lambda: qops.quantize_blocks(
            x, mn, third, 8), 4 * n + 8 + n)
        codes4 = qops.quantize_blocks(
            x, mn, mx if folded else affine_scale(mn, mx, 4), 4)
        if not torch.equal(qops.pack4_blocks(codes4),
                           qref.pack4_blocks_ref(codes4)):
            raise SystemExit(f"K6c differs from its plain version at {label}")
        k6c = ("pack4_blocks", lambda: qops.pack4_blocks(codes4),
               n + (n + 1) // 2)
        return k6a, k6b, k6c

    def study_calls(x, k6a, k6b):
        codes, mn, mx = qops.fused_encode(x.reshape(1, -1), 8)
        return {"fused_decode": lambda: qops.fused_decode(
                    codes, mn, mx, 8, x.numel(), False),
                k6a[0]: k6a[1], k6b[0]: k6b[1],
                "threelaunch_chain": lambda: qops.quantize_pack_threelaunch(
                    x, 8)}

    if "k6" in groups:
        stem_calls = {}
        for label, shape in cs.SHAPES.items():
            x = torch.relu(torch.randn(shape, device=dev, generator=gen))
            n = x.numel()
            k6a, k6b, k6c = k6(label, x)
            timed(k6a[0], label, None, k6a[1], k6a[2])
            timed(k6b[0], label, 8, k6b[1], k6b[2])
            timed(k6c[0], label, 4, k6c[1], k6c[2])
            for bits in (8, 4):
                got = qops.quantize_pack_threelaunch(x, bits)
                want = qops.quantize_pack(x, bits)
                if not (torch.equal(got[0], want[0])
                        and cs.same_bits(got[1], want[1])
                        and cs.same_bits(got[2], want[2])):
                    raise SystemExit(f"the K6 chain differs from K1 at "
                                     f"{label} {bits}")
                timed("threelaunch_chain", label, bits,
                      lambda: qops.quantize_pack_threelaunch(x, bits),
                      4 * n + 8 + got[0].numel())
            if label == "stem":
                stem_calls = study_calls(x, k6a, k6b)
        # The flush study: each call cold after the dirty and the clean flush.
        clean = torch.empty(16 << 20, dtype=torch.float32, device=dev)
        clean.fill_(1.0)
        for kernel, fn in stem_calls.items():
            for how, buf in (("dirty", None), ("clean", clean)):
                ms = cs.device_ms(torch, fn, flush, clean=buf)
                rows.append(dict(kernel=kernel, shape="stem", bits=8, ms=ms,
                                 flush=how))
                print(f"  {kernel:17s} stem 8 bits, {how} flush: {ms:.4f} ms")
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
