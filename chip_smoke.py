#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card.

  python3 chip_smoke.py

1. Prints the card's name and power limit and builds every CUDA kernel of
   the port from ``src/repro_torch/csrc`` (timed).
2. Holds each kernel against its plain PyTorch version on the card, on the
   same inputs, at the main path's shapes: the stem boundary (4, 64, 112,
   112) and the res5 boundary (4, 2048, 7, 7) of full-width ResNet-50 at
   batch 4, plus one odd-sized tensor, at 2, 4, 8 and 16 bits. Codes and
   Huffman words must be byte-identical, dequantized floats bit-identical
   (float32 and bfloat16). Times are CUDA-event medians with the L2 cache
   flushed before every call; the bound is the bytes the function must
   move over 3.35 TB/s.
3. Serves full-width ResNet-50 (random weights from a seed) through
   ``build_edge_cloud_server`` -> ``EdgeCloudServer.serve_batch`` with each
   codec pinned, under a bandwidth trace, with every launch counter set to
   0 just before and read just after. Fails unless every kernel ran, every
   codec chose a decoupled plan, the logits are finite, and one decoupled
   request's logits agree with the same plan and weights run on the CPU.
4. Prints a ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. ``--json PATH`` also writes every measurement
to PATH.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SHAPES = {"stem": (4, 64, 112, 112), "res5": (4, 2048, 7, 7),
          "odd": (1, 3, 37, 41)}
BITS = (2, 4, 8, 16)
TRACE = (300e3, 3e6, 3e7, 1e9)     # bytes/s, one request each
# Logits of the card and the CPU run of one plan: float32 convolutions sum
# in another order in cuDNN than on the CPU (~1e-6 relative), and a boundary
# element that lands that close to a rounding edge moves one quantization
# step, so the tolerance is a small share of the logits' scale.
LOGITS_RTOL = 2e-2


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    """Fail the run (not an ``assert``: the checks must hold under -O)."""
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def device_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median CUDA-event time of ``fn`` with a cold L2 and the launches
    queued behind a spin, so host overhead between launches is hidden."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ms(torch, fn, reps: int = 20):
    """Device time per call from ``torch.profiler``: the sum of every CUDA
    kernel's own time over ``reps`` warm back-to-back calls (no L2 flush,
    no gaps between launches), or None when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages())
    return total / reps / 1e3 if total > 0 else None


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_kernels(torch, results):
    """Step 2: every kernel against its plain version on the card."""
    from repro_torch.core import entropy as ent
    from repro_torch.core.quantization import dequant_step, quantize
    from repro_torch.kernels.entropy import ops as eops
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    worst = {"fused_encode": 0.0, "fused_decode": 0.0, "huffman_pack": 0.0}
    for label, shape in SHAPES.items():
        # Post-ReLU-like boundary: about half the values are exact zeros.
        x = torch.relu(torch.randn(shape, device=dev, generator=gen))
        xb = x.reshape(1, -1)
        n = xb.shape[1]
        for bits in BITS:
            # K1
            codes, mn, mx = qops.fused_encode(xb, bits)
            pc, pmn, pmx = qref.fused_encode_ref(xb, bits)
            err = (codes.to(torch.int32) - pc.to(torch.int32)).abs().max()
            worst["fused_encode"] = max(worst["fused_encode"], float(err))
            check(torch.equal(codes, pc),
                  f"K1 codes {label} {bits}")
            check(torch.equal(mn, pmn) and torch.equal(mx, pmx),
                  "K1 range")
            wire = codes.numel() * codes.element_size()
            rows.append(dict(
                kernel="fused_encode", shape=label, bits=bits,
                ms=device_ms(torch, lambda: qops.fused_encode(xb, bits),
                             flush),
                plain_ms=device_ms(torch, lambda: qref.fused_encode_ref(
                    xb, bits), flush, reps=7),
                bound_ms=bound_ms(4 * n + wire + 8), library_ms=None))
            # K2, the bitpack wire layout (packed nibbles at bits <= 4) and
            # the one-code-per-element layout of the Huffman decode.
            packed = bits <= 4
            step = dequant_step(mn, mx, bits)
            layouts = [(codes, packed)]
            if packed:
                q = torch.stack([codes & 15, codes >> 4], -1).reshape(1, -1)
                layouts.append((q[:, :n].contiguous(), False))
            for cc, pk in layouts:
                for dt, bits_view in ((torch.float32, torch.int32),
                                      (torch.bfloat16, torch.int16)):
                    got = qops.fused_decode(cc, mn, mx, bits, n, pk, dt)
                    want = qref.fused_decode_ref(cc, mn, step, n, pk, dt)
                    err = (got.float() - want.float()).abs().max()
                    worst["fused_decode"] = max(worst["fused_decode"],
                                                float(err))
                    check(torch.equal(got.view(bits_view),
                                      want.view(bits_view)),
                          f"K2 {label} {bits} {dt} packed={pk}")
            lib = None
            if bits == 8:
                mcol, scol = mn[:, None], step[:, None]
                lib = device_ms(torch, lambda: torch.addcmul(
                    mcol, codes, scol), flush)
            rows.append(dict(
                kernel="fused_decode", shape=label, bits=bits,
                ms=device_ms(torch, lambda: qops.fused_decode(
                    codes, mn, mx, bits, n, packed), flush),
                plain_ms=device_ms(torch, lambda: qref.fused_decode_ref(
                    codes, mn, step, n, packed), flush, reps=7),
                bound_ms=bound_ms(wire + 4 * n + 8), library_ms=lib))
            # K3 on the tables the encode builds from the device histogram.
            hist, hmn, _, scale = eops._hist_ranges(xb, bits)
            table = eops._sample_table(hist.cpu().numpy()[0], 1 << bits)
            check(table is not None,
                  "K3 table routed to the host")
            code_of, len_of, lengths, total_bits = table
            w_words = eops._w_words(total_bits)
            clut = torch.from_numpy(code_of.view("int32")[None]).to(dev)
            llut = torch.from_numpy(len_of[None]).to(dev)
            words = eops.huffman_pack(xb, hmn, scale, clut, llut, bits,
                                      w_words)
            pwords = eops.huffman_pack_ref(xb, hmn, scale, clut, llut, bits,
                                           w_words)
            diff = (words != pwords).sum()
            worst["huffman_pack"] = max(worst["huffman_pack"], float(diff))
            check(torch.equal(words, pwords),
                  f"K3 {label} {bits}")
            if label == "odd" or bits == 8:
                # The whole payload against the host encoder's bytes.
                qh = quantize(xb, bits).values.cpu().numpy().reshape(-1)
                payload = ent.huffman_encode(qh, 1 << bits)
                stream = words.cpu().numpy().view("uint32")[0].astype(
                    ">u4").tobytes()[: (total_bits + 7) // 8]
                check(payload[6 + (1 << bits):] == stream,
                      f"K3 payload {label} {bits}")
            rows.append(dict(
                kernel="huffman_pack", shape=label, bits=bits,
                ms=device_ms(torch, lambda: eops.huffman_pack(
                    xb, hmn, scale, clut, llut, bits, w_words), flush),
                plain_ms=device_ms(torch, lambda: eops.huffman_pack_ref(
                    xb, hmn, scale, clut, llut, bits, w_words), flush,
                    reps=5),
                bound_ms=bound_ms(4 * n + 8 + 5 * (1 << bits)
                                  + (total_bits + 7) // 8),
                library_ms=None))
            if label == "stem" and bits == 8:
                calls = {
                    "fused_encode": lambda: qops.fused_encode(xb, bits),
                    "fused_decode": lambda: qops.fused_decode(
                        codes, mn, mx, bits, n, packed),
                    "huffman_pack": lambda: eops.huffman_pack(
                        xb, hmn, scale, clut, llut, bits, w_words)}
                for r in rows[-3:]:
                    r["profiled_ms"] = profiled_ms(torch, calls[r["kernel"]])
            print(f"  {label:5s} {bits:2d} bits  " + "  ".join(
                f"{r['kernel']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
                f", bound {r['bound_ms']:.4f})" for r in rows[-3:]))
    results["kernel_rows"] = rows
    results["max_abs_err"] = worst
    return rows, worst


def stage_ms(torch, runner, batch, reps: int = 5):
    """Host-clock median of each stage of one served request, each ended
    by a synchronize: head, encode (device work + copy of the payload to
    the host), decode (copy back + device work), tail, and the whole
    undivided forward for comparison."""
    from repro_torch.codec import get_codec
    from repro_torch.models.api import batch_to

    model, params, plan = runner.model, runner.params, runner.plan
    codec = get_codec(plan.codec)
    tb = batch_to(batch, runner.device)
    acc = {k: [] for k in ("head", "encode", "decode", "tail",
                           "full_forward")}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[key].append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        for _ in range(reps + 1):
            b = timed("head", lambda: model.run_head(params, tb, plan.point))
            blob = timed("encode", lambda: codec.encode(b, plan.bits))
            x = timed("decode", lambda: codec.decode(blob,
                                                     device=runner.device))
            timed("tail", lambda: model.run_tail(params, x, plan.point))
            timed("full_forward", lambda: model.forward(params, tb))
    return {k: statistics.median(v[1:]) for k, v in acc.items()}


def serve_main_path(torch, results):
    """Step 3: full-width ResNet-50 through the served JALAD path."""
    import dataclasses

    from repro_torch.config import JaladConfig, get_config
    from repro_torch.core.decoupler import (
        DecoupledPlan,
        DecoupledRunner,
        JaladEngine,
    )
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.bridge import params_to
    from repro_torch.serving.edge_cloud import (
        EdgeCloudServer,
        build_edge_cloud_server,
    )

    cfg = get_config("resnet50")
    jc = JaladConfig(codec_choices=("huffman", "bitpack"))
    t0 = time.perf_counter()
    server, params = build_edge_cloud_server(
        cfg, jc, calib_batches=1, calib_batch_size=4, device="cuda")
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    print(f"main path: {cfg.arch_id} {cfg.image_size}x{cfg.image_size}x3 -> "
          f"{cfg.num_classes}, {cfg.dtype}, calibration {calib_s:.1f} s")
    base = server.engine
    names = base.model.decoupling_points()
    served = []
    qops.reset_launch_counts()
    for codec in ("huffman", "bitpack"):
        k = base.tables.codec_index(codec)
        tables = dataclasses.replace(
            base.tables, codecs=[codec],
            acc_drop=base.tables.acc_drop[:, :, k:k + 1],
            size_bytes=base.tables.size_bytes[:, :, k:k + 1])
        engine = JaladEngine(base.model, tables, base.latency,
                             dataclasses.replace(jc, codec_choices=(codec,)),
                             point_indices=base.point_indices)
        srv = EdgeCloudServer(engine, params)
        for i, bw in enumerate(TRACE):
            batch = make_batch(cfg, 4, 64, seed=100 + i)
            t1 = time.perf_counter()
            logits, bd = srv.serve_batch(batch, bw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            check(tuple(logits.shape) == (4, cfg.num_classes),
                  logits.shape)
            check(bool(torch.isfinite(logits).all()),
                  "non-finite logits")
            point = names[bd.plan_point] if bd.plan_point >= 0 else "cloud"
            print(f"  {codec:7s} bw={bw:9.0f} B/s  point={point:9s} "
                  f"bits={bd.plan_bits:2d} codec={bd.plan_codec:7s} "
                  f"sent={bd.bytes_sent} B  modeled={bd.total_s * 1e3:.2f} ms"
                  f"  wall={wall * 1e3:.1f} ms")
            served.append(dict(codec=codec, bandwidth=bw, point=point,
                               bits=bd.plan_bits, bytes=bd.bytes_sent,
                               modeled_s=bd.total_s, wall_s=wall,
                               batch=batch, logits=logits, plan=bd))
    torch.cuda.synchronize()
    counts = qops.launch_counts()
    print(f"main path launches: {counts}")
    for name in ("fused_encode", "fused_decode", "huffman_pack"):
        check(counts[name] > 0,
              f"{name} never launched on the main path")
    for codec in ("huffman", "bitpack"):
        check(any(s["codec"] == codec and s["point"] != "cloud"
                  for s in served),
              f"no decoupled plan for {codec}")
    # At each codec's largest decoupled boundary: the same plan and
    # weights on the CPU, and where a served request's time goes.
    cpu_params = params_to(params, "cpu")
    stages = {}
    for codec in ("huffman", "bitpack"):
        s = max((s for s in served
                 if s["codec"] == codec and s["point"] != "cloud"),
                key=lambda s: s["bytes"])
        bd = s["plan"]
        plan = DecoupledPlan(bd.plan_point, bd.plan_bits, 0.0, 0.0, 0.0,
                             codec)
        cpu_logits, cpu_bytes = DecoupledRunner(
            base.model, cpu_params, plan).run(s["batch"])
        card = s["logits"].cpu()
        diff = float((card - cpu_logits).abs().max())
        scale = float(cpu_logits.abs().max())
        print(f"  {codec} card vs cpu at {s['point']}/{bd.plan_bits} bits: "
              f"max |diff| {diff:.3e} (logits scale {scale:.3e}, rtol "
              f"{LOGITS_RTOL}), bytes {bd.bytes_sent} vs {cpu_bytes}")
        check(diff <= LOGITS_RTOL * scale, f"{codec} card/cpu logits")
        key = f"{codec}@{s['point']}/{bd.plan_bits}bits"
        stages[key] = stage_ms(torch, DecoupledRunner(base.model, params,
                                                      plan), s["batch"])
        print(f"  stages {key}: " + "  ".join(
            f"{k} {v:.3f} ms" for k, v in stages[key].items()))
    results["main_path"] = dict(
        calibration_s=calib_s, launches=counts, stages_ms=stages,
        requests=[{k: v for k, v in s.items()
                   if k not in ("batch", "logits", "plan")} for s in served])
    return counts


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    card = card_line()
    results = {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; kernel build {build_s:.1f} s")
    for name in build.SOURCES:
        log = (build.build_dir() / f"{name}.ptxas.txt")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    results["build_s"] = build_s
    rows, worst = check_kernels(torch, results)
    counts = serve_main_path(torch, results)

    def row(kernel, label="stem", bits=8):
        return next(r for r in rows if r["kernel"] == kernel
                    and r["shape"] == label and r["bits"] == bits)

    meta = {
        "fused_encode": ("src/repro_torch/csrc/quantize.cu",
                         "src/repro/kernels/quantize/quantize.py:165"),
        "fused_decode": ("src/repro_torch/csrc/quantize.cu",
                         "src/repro/kernels/quantize/quantize.py:246"),
        "huffman_pack": ("src/repro_torch/csrc/huffman_pack.cu",
                         "src/repro/kernels/entropy/huffman.py:192"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = row(name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"]})
    results["kernels"] = kernels
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
