#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card.

  python3 chip_smoke.py

1. Prints the card's name and power limit and builds every CUDA kernel of
   the port from ``src/repro_torch/csrc`` (timed).
2. Holds each kernel against its plain PyTorch version on the card, on the
   same inputs, at the main path's shapes: the stem boundary (4, 64, 112,
   112) and the res5 boundary (4, 2048, 7, 7) of full-width ResNet-50 at
   batch 4, plus one odd-sized tensor, at 2, 4, 8 and 16 bits for the
   per-tensor kernels K1-K3; the same shapes and the ``gap`` boundary
   (4, 2048) at 2, 3, 4, 5, 8 and 16 bits for the per-channel K4 / K5,
   whose B = 4 stacks must also equal four single calls, and B = 3 stacks
   of the odd shape for the decodes K2 / K5 (rows that start off every
   16-byte boundary). Codes, words and ranges must be byte-identical,
   dequantized floats bit-identical (float32 and bfloat16). Times are
   CUDA-event medians with the L2 cache flushed before every call; the
   bound is the bytes the function must move over 3.35 TB/s. Ranges are
   compared by bits (``-0.0`` is not ``+0.0``). At the stem boundary, 8
   bits, ``torch.profiler`` gives each kernel's warm time and the device
   operations a call runs, printed; K1, K2, K3, K4 and K5 must run one
   kernel, K3 beside its one memset (the look-back scratch), the others
   with none. K1 is also held at the served shapes (the ``stem_pool``
   boundary of one request and of the pipeline's micro-batch of four,
   ``fc``) and on a (4, 4,194,304) stack past what the card stages, in
   float32 and bfloat16, timed at 2 and 8 bits; both of its variants
   (solo, grid) are timed at each shape of ``K1_SWEEP``, and held on
   samples whose minimum or maximum is a zero of both signs.
   K1, K3 and K4 are also held in bfloat16; K3 on a (4, 4,194,304) stack
   of more tiles than the card holds blocks (rows equal single calls) and on
   synthetic tables (every code 8 bits, so tiles start on words; codes of
   1 to 32 bits). K5's two variants are timed on either side of the run
   length at which ``pc_decode`` picks the tiled one, K4's on either side
   of the channel length past which ``pc_encode`` streams.
3. Serves full-width ResNet-50 (random weights from a seed) through
   ``build_edge_cloud_server`` -> ``EdgeCloudServer.serve_batch`` with each
   of the three codecs pinned, then with all three in the tables, under a
   bandwidth trace, with every launch counter set to 0 just before and
   read just after. Fails unless every kernel ran, every codec chose a
   decoupled plan, the logits are finite, and one decoupled request's
   logits per codec agree with the same plan and weights run on the CPU.
4. Serves full-width ResNet-50 through ``PipelinedEdgeCloudServer``
   (micro-batches of 4) with all three codecs in the tables and with each
   pinned, under a bandwidth step, counters again set to 0 before and read
   after. Fails unless every kernel ran, a re-plan fired, every request
   has finite logits, every micro-batched blob equals the per-request
   encode of its request and plan, and every request's logits equal the
   cloud step of its blob.
5. Holds the three-launch encode chain K6a (range partials), K6b
   (quantize), K6c (nibble pack) against the plain versions at the stem,
   res5 and odd shapes, each taken as one tensor, in float32 and bfloat16,
   and on the real ``stem_pool`` boundary of a served request, at 2, 3, 4,
   8 and 16 bits: partials, codes and packed bytes byte-identical, the
   chain's ``(codes, mn, mx)`` byte-identical to K1's ``quantize_pack``,
   exactly 3 launches a call at 4 bits or fewer and 2 above. Then drives
   ``quantize_pack_threelaunch`` on the served boundary with the counters
   set to 0 before and read after.
6. Serves full-width ResNet-50 through the fleet server: D = 4
   heterogeneous edges (TX2, TK1, a mid and a fast edge) against one shared
   cloud under a flash-crowd trace (``make_trace``), batch 4 per request,
   built by ``build_fleet_server`` from the tables step 3 calibrated (so no
   second calibration), with all three codecs in the tables and with each
   pinned, counters set to 0 before each run and read after. Fails unless
   every request has finite logits; each device's breakdowns, clock and
   log equal a synchronous ``EdgeCloudServer`` over its engine serving the
   same batches, with equal logits; the scalar path (``vectorized=False``)
   gives the same plans, timelines, breakdowns and logits; the fused tail
   agrees within ``FUSED_TAIL_RTOL``; some cloud launch was batched; every
   decoupled cloud group launched exactly one decode kernel; and a re-plan
   fired.
7. Serves full-width ResNet-50 through the three-tier server: three devices
   (TX2, TK1, a mid edge) behind one shared edge server and one cloud,
   built by ``build_three_tier_server`` from step 3's tables, the first
   ``TRI_PER_DEVICE`` requests of each device of a two-link ``make_trace``
   (``TRI_TRACE``), batch 4, with each codec pinned and then all three in
   the tables, one request a ``serve`` call with the counters set to 0 just
   before and read just after it. Fails unless every request has finite
   logits; each breakdown's device, edge-server and cloud times are the
   per-device ``TriPlanSpace.stage_times`` bitwise; bitpack's transfers on
   both links are ``plan_sizes / bandwidth`` exactly; each request launched
   its plan's kernels (the device's encode, a decode and an encode at the
   edge server unless the plan relays, the cloud's decode); a relay was
   served, and its blob equals the two-tier runner's edge step; the same
   stream served on the CPU gives the same plans, breakdowns and timelines,
   and logits within ``LOGITS_RTOL``. Then, for each codec, the pinned
   two-cut plan ``TRI_PINNED`` through ``TriDecoupledRunner``: the kernels
   of each tier's step, logits within ``LOGITS_RTOL`` of the full forward,
   and each step's host-clock card time (median of 5).
8. Serves full-width olmo-1b (bfloat16, random weights from seed 0; 16
   layers, d_model 2048, vocab 50,304): (a) ``ServeSession``, batch 4,
   prompt 32, 16 greedy tokens, with split (``prefill_head`` /
   ``prefill_tail``, ``decode_head`` / ``decode_tail``) equal to unsplit
   bit for bit at the first, a middle and the last point; (b) the
   ``ContinuousBatchingEngine``, 6 staggered requests on 4 slots, each
   request's tokens, greedy and sampled (``LM_TEMPERATURE``, a generator
   a request), equal to a one-slot engine's, and one decode step of four
   live rows at their own positions equal, logits bit for bit, to each
   request decoded alone at the same row count; (c)
   ``build_edge_cloud_server`` over the three codecs (calibration timed),
   ``decide_streaming`` at two bandwidths, the stream kernels K1/K2, K3
   and K4/K5 held byte for byte against their plain versions on real
   boundary frames (k = 1..4 rows of (1, 1, 2048), one (1, 32, 2048)
   prompt), and for each codec the pinned plan ``seg0_d7`` at 8 bits
   serving the 6 requests (sampled) through ``stream_session``: the
   counters set to 0 around every step show one encode and one decode
   launch for the step's batched group plus one of each per request that
   joins in it;
   each request's tokens equal a one-slot session's; the same run, phase
   by phase with a synchronize after each (head, encode, decode, tail,
   join), gives the per-token card times, and ``torch.profiler`` over 5
   steps the device kernels and busy share of a step. Then reduced
   olmo-1b in float32, card against CPU: logits within ``LM_SMALL_RTOL``,
   equal greedy tokens.
9. Prints the card line, a ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. ``--json PATH`` also writes every measurement
to PATH.
"""
from __future__ import annotations

import json
import math
import re
import shutil
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
PC_SHAPES = {"stem": ((4, 64, 112, 112), 1), "res5": ((4, 2048, 7, 7), 1),
             "gap": ((4, 2048), 1), "odd": ((1, 3, 37, 41), 1)}
PC_BITS = (2, 3, 4, 5, 8, 16)
# Run lengths (``inner``) at which step 2 times both K5 variants.
PC_SWEEP_INNER = (1, 4, 8, 16, 32, 49, 64, 256)
# Channel lengths, as shares of the staged limit (8 x PC_SHARE_MAX_FLOATS),
# at which step 2 times both K4 variants; the limit plus 4 is streamed.
PC_ENC_SWEEP = (1 / 64, 1 / 8, 1 / 2, 1)
# K3: a stack of more tiles (4 x 1,024) than the card holds blocks at once,
# and the memsets a call runs (the look-back scratch).
K3_STRESS = (4, 4_194_304)
K3_MEMSETS = 1
# K1 at the served shapes, each a (B, n) stack: the stem_pool boundary of
# one request of batch 4 and the pipeline's micro-batch of four such
# requests, the fc boundary, and a stack past what the card stages (64 MiB
# of float32); timed at K1_BITS. K1_SWEEP: shapes at which both variants
# are timed: either side of the size at which fused_encode_plan leaves one
# block a sample (FE_SOLO_MAX), and the res5, stem_pool and pipeline
# shapes.
K1_SHAPES = {"stem_pool": (1, 802_816), "pipe4": (4, 802_816),
             "fc": (1, 4_000), "over": (4, 4_194_304)}
K1_BITS = (2, 8)
K1_SWEEP = {"n8192": (1, 8_192), "n16384": (1, 16_384),
            "n32768": (1, 32_768), "res5": (1, 401_408),
            "stem_pool": (1, 802_816), "pipe4": (4, 802_816)}
CODECS = ("huffman", "bitpack", "perchannel")
TRACE = (300e3, 3e6, 3e7, 1e9)     # bytes/s, one request each
# Pipeline: a bandwidth step, served in micro-batches of 4 requests.
PIPE_MICRO = 4
PIPE_STEP = (1e9, 3e5)
# Logits of the card and the CPU run of one plan: float32 convolutions sum
# in another order in cuDNN than on the CPU (~1e-6 relative), and a boundary
# element that lands that close to a rounding edge moves one quantization
# step, so the tolerance is a small share of the logits' scale.
LOGITS_RTOL = 2e-2
# Three-launch chain (step 5): widths, and the served boundary it encodes.
K6_BITS = (2, 3, 4, 8, 16)
K6_POINT = "stem_pool"
# Fleet (step 6): the four edge profiles and the flash-crowd trace.
FLEET_TRACE = dict(n_devices=4, n_steps=24, seed=13, kind="flash_crowd",
                   mean_bps=2e6, flash_bw_drop=16.0)
# The fused tail runs one forward over a whole cloud group, at another
# batch size than the per-request tails, so cuDNN may pick other
# convolution algorithms that sum in another order; the decoded boundary
# is the same bits on both sides, so only float32 rounding in the tail
# differs (~1e-6 relative per layer), far inside this share of the scale.
FUSED_TAIL_RTOL = 1e-3
# Table file of step 3's calibration, reloaded by build_fleet_server and
# build_three_tier_server.
TABLES_DIR = ROOT / "build" / "chip_smoke_tables"
# Three-tier (step 7): the edge profiles of the reference's three-tier
# serving test behind one edge server, a two-link trace whose fast uplinks
# and congested backhauls make the TK1 device pick a genuine second cut,
# the first TRI_PER_DEVICE requests of each device; and the pinned
# two-cut plan run for each codec (cuts and bits on both links).
TRI_TRACE = dict(n_devices=3, n_steps=16, seed=21, link2=True,
                 mean_bps=10e6, mean2_bps=2e6)
TRI_PER_DEVICE = 2
TRI_PINNED = ("stem_pool", "res3_6", 8)
ENCODE_KERNEL = {"huffman": "huffman_pack", "bitpack": "fused_encode",
                 "perchannel": "pc_encode"}
DECODE_KERNEL = {"huffman": "fused_decode", "bitpack": "fused_decode",
                 "perchannel": "pc_decode"}

# LM serving (step 8): full-width olmo-1b in bfloat16, random weights from
# seed 0. ServeSession: batch, prompt, greedy tokens; split against unsplit
# at the first, a middle and the last point. The engine and the streams
# serve LM_REQUESTS staggered requests (prompts of LM_PROMPTS tokens,
# LM_NEW new ones, two arrivals a step) on LM_MAX_BATCH slots; the streams
# pin LM_STREAM_POINT at LM_STREAM_BITS. decide_streaming is printed at
# LM_BANDWIDTHS. The stream-shape kernel checks run at LM_KERNEL_BITS.
LM_ARCH = "olmo-1b"
LM_SESSION = (4, 32, 16)
LM_SPLIT_POINTS = (0, 7, 15)
LM_REQUESTS, LM_MAX_BATCH, LM_SEQ = 6, 4, 96
LM_PROMPTS, LM_NEW = (8, 33), (4, 17)
LM_STREAM_POINT, LM_STREAM_BITS = 7, 8
LM_BANDWIDTHS = (1e5, 1e7)
LM_KERNEL_BITS = (2, 4, 8)
LM_PROFILE_STEPS = 5
# The engine also samples, and the streams sample, at this temperature.
# With random tied embeddings a token's own logit leads the others by tens
# (about |e|^2 / std(e) ~ 40 from the init scales), so greedy decoding,
# and sampling at 1, repeat one token; at 5 the tokens move.
LM_TEMPERATURE = 5.0
# Reduced olmo-1b in float32 (TF32 off), card against CPU: the matrix
# products sum in other orders, ~1e-6 of the logits' scale.
LM_SMALL_RTOL = 1e-5

KERNELS = ("fused_encode", "fused_decode", "huffman_pack", "pc_encode",
           "pc_decode")
K6_KERNELS = ("minmax_blocks", "quantize_blocks", "pack4_blocks")


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    """Fail the run (not an ``assert``: the checks must hold under -O)."""
    if not ok:
        raise SmokeFailure(what)


def same_bits(a, b) -> bool:
    """Equal float32 tensors bit for bit (``torch.equal`` takes -0.0 for
    +0.0, and a range header must not)."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


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


def profiled_ms(torch, fn, reps: int = 20, tries: int = 5):
    """Warm device time per call from ``torch.profiler`` and the device
    kernels a call runs: ``reps`` back-to-back calls (no L2 flush, no gaps
    between launches) that start and end 10 ms inside the session; the
    time is each kernel's mean own time times its launches a call, summed.
    A session that saw no kernel, or lost calls' events (a count not a
    whole multiple of ``reps``, seen on the H100), is taken again; after
    ``tries`` sessions the last one's counts are rounded to whole launches
    a call. ``(None, {})`` when no session saw a kernel."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        count, own_us = Counter(), Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                count[e.name] += 1
                own_us[e.name] += e.self_device_time_total
        whole = all(v % reps == 0 for v in count.values())
        if count and (whole or attempt == tries - 1):
            per_call = {k: max(1, round(v / reps)) for k, v in count.items()}
            return sum(own_us[k] / count[k] * per_call[k]
                       for k in count) / 1e3, per_call
    return None, {}


def profile_rows(torch, rows, calls, one_kernel=(), memsets=None):
    """Warm time and device operations a call of each ``calls[kernel]``,
    into that kernel's row; fails unless each kernel of ``one_kernel`` ran
    one device kernel once a call, beside exactly ``memsets[kernel]``
    memsets (none where it is not named)."""
    memsets = memsets or {}
    for r in rows:
        fn = calls.get(r["kernel"])
        if fn is None:
            continue
        r["profiled_ms"], r["device_kernels"] = profiled_ms(torch, fn)
        print(f"  {r['kernel']} warm {r['profiled_ms']} ms a call; device "
              f"operations a call: {r['device_kernels']}")
        if r["kernel"] in one_kernel:
            ops = r["device_kernels"]
            kernels = [v for k, v in ops.items() if not k.startswith("Memset")]
            sets = sum(v for k, v in ops.items() if k.startswith("Memset"))
            check(kernels == [1] and sets == memsets.get(r["kernel"], 0),
                  f"{r['kernel']}: {ops} device operations a call, not one "
                  f"kernel and {memsets.get(r['kernel'], 0)} memsets")


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

    def check_decode(label, bits, codes, mn, mx, n):
        """K2 on the bitpack wire layout (packed nibbles at bits <= 4) and
        the one-code-per-element layout of the Huffman decode."""
        bsz = codes.shape[0]
        step = dequant_step(mn, mx, bits)
        layouts = [(codes, bits <= 4)]
        if bits <= 4:
            q = torch.stack([codes & 15, codes >> 4], -1).reshape(bsz, -1)
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
                      f"K2 {label} B={bsz} {bits} {dt} packed={pk}")

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
            check(same_bits(mn, pmn) and same_bits(mx, pmx),
                  f"K1 range {label} {bits}")
            xh = xb.to(torch.bfloat16)
            hc, hmn, hmx = qops.fused_encode(xh, bits)
            hp = qref.fused_encode_ref(xh, bits)
            check(torch.equal(hc, hp[0]) and same_bits(hmn, hp[1])
                  and same_bits(hmx, hp[2]), f"K1 bf16 {label} {bits}")
            wire = codes.numel() * codes.element_size()
            rows.append(dict(
                kernel="fused_encode", shape=label, bits=bits,
                ms=device_ms(torch, lambda: qops.fused_encode(xb, bits),
                             flush),
                plain_ms=device_ms(torch, lambda: qref.fused_encode_ref(
                    xb, bits), flush, reps=7),
                bound_ms=bound_ms(4 * n + wire + 8), library_ms=None))
            packed = bits <= 4
            step = dequant_step(mn, mx, bits)
            check_decode(label, bits, codes, mn, mx, n)
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
            # The bf16 input the wrapper also takes, on its own tables.
            xh = xb.to(torch.bfloat16)
            hh, hhmn, _, hscale = eops._hist_ranges(xh, bits)
            ht = eops._sample_table(hh.cpu().numpy()[0], 1 << bits)
            check(ht is not None, "K3 bf16 table routed to the host")
            hargs = (xh, hhmn, hscale,
                     torch.from_numpy(ht[0].view("int32")[None]).to(dev),
                     torch.from_numpy(ht[1][None]).to(dev), bits,
                     eops._w_words(ht[3]))
            check(torch.equal(eops.huffman_pack(*hargs),
                              eops.huffman_pack_ref(*hargs)),
                  f"K3 bf16 {label} {bits}")
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
            print(f"  {label:5s} {bits:2d} bits  " + "  ".join(
                f"{r['kernel']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
                f", bound {r['bound_ms']:.4f})" for r in rows[-3:]))
            if label == "stem" and bits == 8:
                profile_rows(torch, rows[-3:], {
                    "fused_encode": lambda: qops.fused_encode(xb, bits),
                    "fused_decode": lambda: qops.fused_decode(
                        codes, mn, mx, bits, n, packed),
                    "huffman_pack": lambda: eops.huffman_pack(
                        xb, hmn, scale, clut, llut, bits, w_words)},
                    one_kernel=("fused_encode", "fused_decode",
                                "huffman_pack"),
                    memsets={"huffman_pack": K3_MEMSETS})
    # A B = 3 stack of the odd shape: rows 2 and 3 start off every 16-byte
    # boundary, in the codes and in the output.
    n = math.prod(SHAPES["odd"])
    xs = torch.relu(torch.randn((3, n), device=dev, generator=gen))
    for bits in BITS:
        codes, mn, mx = qops.fused_encode(xs, bits)
        check_decode("odd", bits, codes, mn, mx, n)
    rows += check_fused_encode(torch, results, gen, flush, worst)
    rows += check_pack_stress(torch, gen, flush, worst)
    results["kernel_rows"] = rows
    results["max_abs_err"] = worst
    return rows, worst


def check_fused_encode(torch, results, gen, flush, worst):
    """K1 at the served shapes (K1_SHAPES) in float32 and bfloat16 at every
    width of BITS, timed at K1_BITS; both variants at each shape of
    K1_SWEEP, timed, each against the plain version; and samples whose
    minimum or maximum is a zero of both signs, in every variant. Returns
    the timed rows."""
    import numpy as np

    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    dev = torch.device("cuda")
    rows = []

    def held(xb, bits, variant=None, what=""):
        got = qops._fused_encode_cuda(xb, bits, variant)
        want = qref.fused_encode_ref(xb, bits)
        err = (got[0].to(torch.int32) - want[0].to(torch.int32)).abs().max()
        worst["fused_encode"] = max(worst["fused_encode"], float(err))
        check(torch.equal(got[0], want[0]) and same_bits(got[1], want[1])
              and same_bits(got[2], want[2]),
              f"K1 {what} {tuple(xb.shape)} {xb.dtype} {bits} {variant}")
        return got

    for label, shape in K1_SHAPES.items():
        x = torch.relu(torch.randn(shape, device=dev, generator=gen))
        for xb in (x, x.to(torch.bfloat16)):
            for bits in BITS:
                held(xb, bits, what=label)
        plan = qops.fused_encode_plan(
            *shape, False, qops.fused_encode_resident(dev, False, 8))
        for bits in K1_BITS:
            wire = shape[0] * qref.wire_len(shape[1], bits) * (
                2 if bits > 8 else 1)
            rows.append(dict(
                kernel="fused_encode", shape=label, bits=bits,
                variant=plan.variant, blocks=plan.blocks,
                ms=device_ms(torch, lambda: qops.fused_encode(x, bits),
                             flush),
                plain_ms=device_ms(torch, lambda: qref.fused_encode_ref(
                    x, bits), flush, reps=5),
                bound_ms=bound_ms(4 * x.numel() + wire + 8 * shape[0]),
                library_ms=None))
            r = rows[-1]
            print(f"  K1 {label:9s} {tuple(shape)} {bits:2d} bits "
                  f"({plan.variant}, {plan.blocks} blocks a sample): "
                  f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f})")
    sweep = []
    for label, shape in K1_SWEEP.items():
        x = torch.relu(torch.randn(shape, device=dev, generator=gen))
        resident = qops.fused_encode_resident(dev, False, 8)
        picked = qops.fused_encode_plan(*shape, False, resident).variant
        for variant in qops.FE_VARIANTS:
            plan = qops.fused_encode_plan(*shape, False, resident, variant)
            held(x, 8, variant, "sweep")
            entry = dict(shape=label, dims=list(shape), variant=variant,
                         picked=variant == picked, blocks=plan.blocks,
                         ms=device_ms(torch, lambda: qops._fused_encode_cuda(
                             x, 8, variant), flush))
            entry["warm_ms"], entry["device_ops"] = profiled_ms(
                torch, lambda: qops._fused_encode_cuda(x, 8, variant))
            sweep.append(entry)
            print(f"  K1 {variant:4s} at {label} {tuple(shape)} 8 bits: "
                  f"{entry['ms']:.4f} ms cold, {entry['warm_ms']} ms warm, "
                  f"{plan.blocks} blocks a sample"
                  + (" (picked)" if entry["picked"] else ""))
    results["fused_encode_variants"] = sweep
    # Signed zeros at the minimum (even rows) and the maximum (odd rows),
    # in both orders: the ranges of every variant equal the plain
    # version's bit for bit.
    for zeros in ([0.0, -0.0], [-0.0, 0.0]):
        for bsz, n in ((2, 70_001), (1, 802_816)):
            rows_np = [np.resize(np.array(zeros + [1.0, 2.0] if b % 2 == 0
                                          else [-1.0, -2.0] + zeros,
                                          np.float32), n)
                       for b in range(bsz)]
            xz = torch.from_numpy(np.stack(rows_np)).to(dev)
            for variant in qops.FE_VARIANTS:
                for bits in (4, 8):
                    held(xz, bits, variant, f"signed zeros {zeros}")
    return rows


def check_pack_stress(torch, gen, flush, worst):
    """K3 past the card's resident blocks, and on synthetic tables: a
    (4, 4,194,304) stack (4,096 tiles) whose rows must equal single calls;
    codes all 8 bits long (every tile's bit count a multiple of 32, so
    tiles start on words) and of random lengths 1 to 32 bits, at the stem
    size. Returns the stress stack's timed row."""
    import numpy as np

    from repro_torch.kernels.entropy import ops as eops

    dev = torch.device("cuda")
    bits = 8
    xb = torch.relu(torch.randn(K3_STRESS, device=dev, generator=gen))
    hist, mn, _, scale = eops._hist_ranges(xb, bits)
    tables = [eops._sample_table(h, 1 << bits) for h in hist.cpu().numpy()]
    check(all(t is not None for t in tables), "K3 stress routed to the host")
    totals = [t[3] for t in tables]
    w_words = eops._w_words(max(totals))
    clut = torch.from_numpy(np.stack([t[0] for t in tables]).view(
        np.int32)).to(dev)
    llut = torch.from_numpy(np.stack([t[1] for t in tables])).to(dev)
    args = (xb, mn, scale, clut, llut, bits, w_words)
    words = eops.huffman_pack(*args)
    want = eops.huffman_pack_ref(*args)
    worst["huffman_pack"] = max(worst["huffman_pack"],
                                float((words != want).sum()))
    check(torch.equal(words, want), "K3 stress stack")
    for b, total in enumerate(totals):
        one = eops.huffman_pack(xb[b:b + 1], mn[b:b + 1], scale[b:b + 1],
                                clut[b:b + 1], llut[b:b + 1], bits,
                                eops._w_words(total))
        k = -(-total // 32)
        check(torch.equal(one[0, :k], words[b, :k]),
              f"K3 stress row {b} differs from its single call")
    n = xb.shape[1]
    row = dict(kernel="huffman_pack", shape="stress", bits=bits,
               ms=device_ms(torch, lambda: eops.huffman_pack(*args), flush),
               plain_ms=device_ms(torch, lambda: eops.huffman_pack_ref(*args),
                                  flush, reps=3),
               bound_ms=bound_ms(xb.numel() * 4 + 8 * len(totals)
                                 + 5 * len(totals) * (1 << bits)
                                 + sum((t + 7) // 8 for t in totals)),
               library_ms=None)
    print(f"  K3 stress {K3_STRESS} 8 bits ({len(totals) * -(-n // 4096)} "
          f"tiles): {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
          f"{row['bound_ms']:.4f})")
    rng = np.random.default_rng(7)
    x1 = xb[:1, :math.prod(SHAPES["stem"])]
    for label, lens in (("all 8", np.full(256, 8)),
                        ("1 to 32", rng.integers(1, 33, 256))):
        codes = rng.integers(0, 1 << 32, size=256, dtype=np.uint64)
        codes &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
        sargs = (x1, mn[:1], scale[:1],
                 torch.from_numpy(codes.astype(np.uint32).view(np.int32)[
                     None]).to(dev),
                 torch.from_numpy(lens.astype(np.uint8)[None]).to(dev), bits,
                 eops._w_words(32 * x1.shape[1]))
        check(torch.equal(eops.huffman_pack(*sargs),
                          eops.huffman_pack_ref(*sargs)),
              f"K3 synthetic code lengths {label}")
    return [row]


def check_perchannel_kernels(torch, results):
    """Step 2, per channel: K4 and K5 against their plain versions."""
    from repro_torch.core.quantization import dequant_step
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    worst = {"pc_encode": 0.0, "pc_decode": 0.0}

    def check_decode(label, bits, words, mn, mx, shape, axis):
        """K5 in float32 and bfloat16."""
        for dt, bits_view in ((torch.float32, torch.int32),
                              (torch.bfloat16, torch.int16)):
            got = qops.pc_decode(words, mn, mx, bits, shape, axis, dt)
            want = qref.pc_decode_ref(words, mn, mx, bits, shape, axis, dt)
            err = (got.float() - want.float()).abs().max()
            worst["pc_decode"] = max(worst["pc_decode"], float(err))
            check(torch.equal(got.view(bits_view), want.view(bits_view)),
                  f"K5 {label} B={words.shape[0]} {bits} {dt}")
    for label, (shape, axis) in PC_SHAPES.items():
        stack = torch.relu(torch.randn((4,) + shape, device=dev,
                                       generator=gen))
        xb = stack[:1]
        outer, c, inner = qref.channel_dims(shape, axis)
        n = outer * c * inner
        for bits in PC_BITS:
            words, mn, mx = qops.pc_encode(xb, bits, axis)
            pw, pmn, pmx = qref.pc_encode_ref(xb, bits, axis)
            diff = (words != pw).sum()
            worst["pc_encode"] = max(worst["pc_encode"], float(diff))
            check(torch.equal(words, pw), f"K4 words {label} {bits}")
            check(same_bits(mn, pmn) and same_bits(mx, pmx),
                  f"K4 ranges {label} {bits}")
            xh = xb.to(torch.bfloat16)
            check(all(torch.equal(a, b) for a, b in zip(
                qops.pc_encode(xh, bits, axis),
                qref.pc_encode_ref(xh, bits, axis))),
                f"K4 bf16 {label} {bits}")
            check_decode(label, bits, words, mn, mx, shape, axis)
            # A B = 4 stack against four single calls.
            sw, smn, smx = qops.pc_encode(stack, bits, axis)
            sout = qops.pc_decode(sw, smn, smx, bits, shape, axis)
            for b in range(4):
                w1, mn1, mx1 = qops.pc_encode(stack[b:b + 1], bits, axis)
                check(torch.equal(sw[b:b + 1], w1)
                      and torch.equal(smn[b:b + 1], mn1)
                      and torch.equal(smx[b:b + 1], mx1),
                      f"K4 stack {label} {bits} sample {b}")
                check(torch.equal(sout[b:b + 1], qops.pc_decode(
                    w1, mn1, mx1, bits, shape, axis)),
                    f"K5 stack {label} {bits} sample {b}")
            wire = words.numel() * 4 + 8 * c
            rows.append(dict(
                kernel="pc_encode", shape=label, bits=bits,
                ms=device_ms(torch, lambda: qops.pc_encode(xb, bits, axis),
                             flush),
                plain_ms=device_ms(torch, lambda: qref.pc_encode_ref(
                    xb, bits, axis), flush, reps=7),
                bound_ms=bound_ms(4 * n + wire), library_ms=None))
            lib = None
            if bits == 8:
                # One PyTorch call on the unpacked u8 codes, in the output
                # layout, as the yardstick of the decode.
                step = dequant_step(mn, mx, bits)
                codes = ((words.to(torch.int64)[..., None]
                          >> torch.arange(0, 32, 8, device=dev)) & 255)
                codes = (codes.reshape(1, c, -1)[:, :, :outer * inner]
                         .reshape(1, c, outer, inner).transpose(1, 2)
                         .reshape((1,) + shape).to(torch.uint8))
                rshape = [1] * (len(shape) + 1)
                rshape[axis + 1] = c
                mcol, scol = mn.reshape(rshape), step.reshape(rshape)
                lib = device_ms(torch, lambda: torch.addcmul(
                    mcol, codes, scol), flush)
            rows.append(dict(
                kernel="pc_decode", shape=label, bits=bits,
                ms=device_ms(torch, lambda: qops.pc_decode(
                    words, mn, mx, bits, shape, axis), flush),
                plain_ms=device_ms(torch, lambda: qref.pc_decode_ref(
                    words, mn, mx, bits, shape, axis), flush, reps=7),
                bound_ms=bound_ms(wire + 4 * n), library_ms=lib))
            print(f"  {label:5s} {bits:2d} bits  " + "  ".join(
                f"{r['kernel']} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}"
                f", bound {r['bound_ms']:.4f})" for r in rows[-2:]))
            if label == "stem" and bits == 8:
                profile_rows(torch, rows[-2:], {
                    "pc_encode": lambda: qops.pc_encode(xb, bits, axis),
                    "pc_decode": lambda: qops.pc_decode(
                        words, mn, mx, bits, shape, axis)},
                    one_kernel=("pc_encode", "pc_decode"))
    # A B = 3 stack of the odd shape: runs of 1,517 floats that start off
    # every 16-byte boundary.
    shape, axis = PC_SHAPES["odd"]
    stack = torch.relu(torch.randn((3,) + shape, device=dev, generator=gen))
    for bits in PC_BITS:
        words, mn, mx = qops.pc_encode(stack, bits, axis)
        check_decode("odd", bits, words, mn, mx, shape, axis)
    # K5's two variants on either side of the threshold at which pc_decode
    # picks the tiled one: (4, 2048, inner) samples, channel axis 1.
    sweep = []
    for inner in PC_SWEEP_INNER:
        shape = (4, 2048, inner)
        x = torch.relu(torch.randn((1,) + shape, device=dev, generator=gen))
        words, mn, mx = qops.pc_encode(x, 8, 1)
        want = qref.pc_decode_ref(words, mn, mx, 8, shape, 1)
        t = {}
        for tiled in (False, True):
            def call(tiled=tiled):
                return qops._pc_decode_cuda(words, mn, mx, 8, shape, 1,
                                            torch.float32, tiled)
            check(torch.equal(call(), want), f"K5 tiled={tiled} {shape}")
            t[tiled] = device_ms(torch, call, flush)
        sweep.append(dict(inner=inner, element_ms=t[False], tiled_ms=t[True],
                          picked="tiled" if inner >= qops.PC_TILE_MIN_INNER
                          else "element"))
        print(f"  K5 variants at (4, 2048, {inner}): element "
              f"{t[False]:.4f} ms, tiled {t[True]:.4f} ms; pc_decode picks "
              f"{sweep[-1]['picked']}")
    results["pc_decode_variants"] = sweep
    # K4's two variants on either side of the channel length past which a
    # cluster of 8 cannot stage its shares: (2, length) samples, channel
    # axis 0, 8 bits. Above it only the streaming variant runs.
    limit = qops.PC_MAX_CLUSTER * qops.PC_SHARE_MAX_FLOATS
    sweep = []
    for length in [int(limit * f) for f in PC_ENC_SWEEP] + [limit + 4]:
        x = torch.relu(torch.randn((1, 2, length), device=dev, generator=gen))
        want = qref.pc_encode_ref(x, 8, 0)
        t = {}
        for staged in (True, False):
            if staged and length > limit:
                continue
            def call(staged=staged):
                return qops._pc_encode_cuda(x, 8, 0, staged)
            check(all(torch.equal(a, b) for a, b in zip(call(), want)),
                  f"K4 staged={staged} length {length}")
            t[staged] = device_ms(torch, call, flush)
        plan = qops.pc_encode_plan(1, 2, length, 8)
        sweep.append(dict(length=length, cluster=plan.cluster,
                          staged_ms=t.get(True), streaming_ms=t[False],
                          bound_ms=bound_ms(4 * 2 * length + 2 * length + 16),
                          picked="staged" if plan.staged else "streaming"))
        staged_txt = (f"{t[True]:.4f} ms" if True in t
                      else "does not fit")
        print(f"  K4 variants at (2, {length}): staged {staged_txt}, "
              f"streaming {t[False]:.4f} ms; pc_encode picks "
              f"{sweep[-1]['picked']} (cluster {plan.cluster})")
    results["pc_encode_variants"] = sweep
    results["kernel_rows"] += rows
    results["max_abs_err"].update(worst)
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


def pinned_engine(base, codec: str):
    """``base`` with the tables cut to one codec."""
    import dataclasses

    from repro_torch.core.decoupler import JaladEngine

    k = base.tables.codec_index(codec)
    tables = dataclasses.replace(
        base.tables, codecs=[codec],
        acc_drop=base.tables.acc_drop[:, :, k:k + 1],
        size_bytes=base.tables.size_bytes[:, :, k:k + 1])
    return JaladEngine(base.model, tables, base.latency,
                       dataclasses.replace(base.cfg, codec_choices=(codec,)),
                       point_indices=base.point_indices)


def serve_main_path(torch, results):
    """Step 3: full-width ResNet-50 through the served JALAD path."""
    from repro_torch.config import JaladConfig, get_config
    from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.bridge import params_to
    from repro_torch.serving.edge_cloud import (
        EdgeCloudServer,
        build_edge_cloud_server,
    )

    cfg = get_config("resnet50")
    jc = JaladConfig(codec_choices=CODECS)
    shutil.rmtree(TABLES_DIR, ignore_errors=True)
    TABLES_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    server, params = build_edge_cloud_server(
        cfg, jc, calib_batches=1, calib_batch_size=4, device="cuda",
        tables_cache_dir=str(TABLES_DIR))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    print(f"main path: {cfg.arch_id} {cfg.image_size}x{cfg.image_size}x3 -> "
          f"{cfg.num_classes}, {cfg.dtype}, calibration {calib_s:.1f} s")
    base = server.engine
    names = base.model.decoupling_points()
    # One stream for the step: each make_batch call would rebuild the 1000
    # class templates of 3 x 224 x 224 (seconds of host time).
    batches = ImageStream(cfg.num_classes, 4, cfg.image_size,
                          seed=100).batches(len(TRACE))
    served = []
    qops.reset_launch_counts()
    runs = [(codec, pinned_engine(base, codec)) for codec in CODECS]
    runs.append(("all", base))
    for label, engine in runs:
        srv = EdgeCloudServer(engine, params)
        for i, bw in enumerate(TRACE):
            batch = batches[i]
            t1 = time.perf_counter()
            logits, bd = srv.serve_batch(batch, bw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            check(tuple(logits.shape) == (4, cfg.num_classes),
                  logits.shape)
            check(bool(torch.isfinite(logits).all()),
                  "non-finite logits")
            point = names[bd.plan_point] if bd.plan_point >= 0 else "cloud"
            print(f"  {label:10s} bw={bw:9.0f} B/s  point={point:9s} "
                  f"bits={bd.plan_bits:2d} codec={bd.plan_codec:10s} "
                  f"sent={bd.bytes_sent} B  modeled={bd.total_s * 1e3:.2f} ms"
                  f"  wall={wall * 1e3:.1f} ms")
            served.append(dict(tables=label, codec=bd.plan_codec,
                               bandwidth=bw, point=point, bits=bd.plan_bits,
                               bytes=bd.bytes_sent, modeled_s=bd.total_s,
                               wall_s=wall, batch=batch, logits=logits,
                               plan=bd))
    torch.cuda.synchronize()
    counts = qops.launch_counts()
    print(f"served path launches: {counts}")
    for name in KERNELS:
        check(counts[name] > 0,
              f"{name} never launched on the served path")
    for codec in CODECS:
        check(any(s["tables"] == codec and s["point"] != "cloud"
                  for s in served),
              f"no decoupled plan for {codec}")
    # At each codec's largest decoupled boundary: the same plan and
    # weights on the CPU, and where a served request's time goes.
    cpu_params = params_to(params, "cpu")
    stages = {}
    for codec in CODECS:
        s = max((s for s in served
                 if s["tables"] == codec and s["point"] != "cloud"),
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
    return counts, base, params


def serve_pipeline(torch, results, base, params):
    """Step 4: full-width ResNet-50 through the pipelined server."""
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.serving.pipeline import (
        PipelinedEdgeCloudServer,
        PipelineRequest,
    )

    cfg = base.model.cfg
    names = base.model.decoupling_points()
    streams = [("all", base, 16)]
    streams += [(codec, pinned_engine(base, codec), 8) for codec in CODECS]
    # One stream for the step, as in step 3.
    batches = ImageStream(cfg.num_classes, 4, cfg.image_size, seed=200
                          ).batches(max(n for _, _, n in streams))
    report = {}
    counts = dict.fromkeys(qops.launch_counts(), 0)
    for label, engine, n in streams:
        pipe = PipelinedEdgeCloudServer(engine, params,
                                        micro_batch=PIPE_MICRO)
        bws = [PIPE_STEP[0]] * (n // 2) + [PIPE_STEP[1]] * (n - n // 2)
        reqs = [PipelineRequest(uid=i, batch=batches[i], bandwidth=bw)
                for i, bw in enumerate(bws)]
        # One serve() call per micro-batch: each call's requests are one
        # drained group, decided after every earlier transfer was observed.
        done = []
        qops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(0, n, PIPE_MICRO):
            done += pipe.serve(reqs[i:i + PIPE_MICRO])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # Counted before the checks below, whose own encodes do not count.
        for name, v in qops.launch_counts().items():
            counts[name] += v
        # The simulated clock runs on across serve() calls.
        makespan = max(r.timeline.cloud_end for r in done)
        sync = sum(r.timeline.service_s for r in done)
        check(len(done) == n, f"pipeline {label}: {len(done)} of {n} done")
        batched = 0
        for r in done:
            check(tuple(r.logits.shape) == (4, cfg.num_classes)
                  and bool(torch.isfinite(r.logits).all()),
                  f"pipeline {label} request {r.uid} logits")
            if r.plan.is_cloud_only:
                continue
            runner = pipe.runners.get(r.plan)
            if r.encode_group > 1:
                batched += 1
                blob, _ = runner.edge_step(r.batch)
                check(blob.payload == r.blob.payload
                      and blob.x_min.tobytes() == r.blob.x_min.tobytes()
                      and blob.x_max.tobytes() == r.blob.x_max.tobytes(),
                      f"pipeline {label} request {r.uid}: micro-batched "
                      "blob differs from the per-request encode")
            check(torch.equal(r.logits, runner.cloud_step(r.blob)),
                  f"pipeline {label} request {r.uid}: logits differ from "
                  "the cloud step of its blob")
        check(batched > 0, f"pipeline {label}: no micro-batched encode")
        switches = pipe.controller.switch_count()
        plans = [(names[r.plan.point] if r.plan.point >= 0 else "cloud",
                  r.plan.bits, r.timeline.plan_codec) for r in done]
        print(f"  pipeline {label:10s} {n} requests: makespan "
              f"{makespan * 1e3:.2f} ms vs synchronous {sync * 1e3:.2f} ms "
              f"(modeled), wall {wall * 1e3:.1f} ms, {batched} "
              f"micro-batched, {switches} re-plans; plans {plans}")
        report[label] = dict(requests=n, makespan_s=makespan,
                             synchronous_s=sync, wall_s=wall,
                             microbatched=batched, replans=switches,
                             plans=plans)
    check(report["all"]["replans"] >= 1, "pipeline: no re-plan fired")
    print(f"pipeline launches: {counts}")
    for name in KERNELS:
        check(counts[name] > 0, f"{name} never launched in the pipeline")
    results["pipeline"] = dict(launches=counts, streams=report)
    return counts


def check_threelaunch_kernels(torch, results, base, params):
    """Step 5: K6a, K6b, K6c against their plain versions, the chain against
    K1, then the chain's own path on a served boundary."""
    from repro_torch.core.quantization import affine_scale
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.models.api import batch_to

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    point = base.model.decoupling_points().index(K6_POINT)
    cfg = base.model.cfg
    batch = ImageStream(cfg.num_classes, 4, cfg.image_size,
                        seed=300).batches(1)[0]
    with torch.no_grad():
        served = base.model.run_head(params, batch_to(batch, dev),
                                     point).contiguous()
    inputs = {label: torch.relu(torch.randn(shape, device=dev,
                                            generator=gen))
              for label, shape in SHAPES.items()}
    inputs[K6_POINT] = served
    rows = []
    worst = dict.fromkeys(K6_KERNELS, 0.0)
    for label, x32 in inputs.items():
        n = x32.numel()
        for x in (x32, x32.to(torch.bfloat16)):
            timed = x.dtype == torch.float32 and label in SHAPES
            esize = x.element_size()
            pmin, pmax = qops.minmax_blocks(x)
            rmin, rmax = qref.minmax_blocks_ref(x)
            worst["minmax_blocks"] = max(
                worst["minmax_blocks"], float((pmin - rmin).abs().max()),
                float((pmax - rmax).abs().max()))
            check(same_bits(pmin, rmin) and same_bits(pmax, rmax),
                  f"K6a partials {label} {x.dtype}")
            mn, mx = torch.amin(pmin), torch.amax(pmax)
            if timed:
                rows.append(dict(
                    kernel="minmax_blocks", shape=label, bits=None,
                    ms=device_ms(torch, lambda: qops.minmax_blocks(x),
                                 flush),
                    plain_ms=device_ms(torch, lambda: qref.minmax_blocks_ref(
                        x), flush, reps=7),
                    bound_ms=bound_ms(esize * n + 8 * pmin.numel()),
                    library_ms=device_ms(torch, lambda: torch.aminmax(x),
                                         flush)))
                r = rows[-1]
                print(f"  {label:5s}          minmax_blocks {r['ms']:.4f} ms "
                      f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}"
                      f", aminmax {r['library_ms']:.4f})")
            for bits in K6_BITS:
                scale = affine_scale(mn, mx, bits)
                codes = qops.quantize_blocks(x, mn, scale, bits)
                want = qref.quantize_blocks_ref(x, mn, scale, bits)
                worst["quantize_blocks"] = max(
                    worst["quantize_blocks"], float(
                        (codes.int() - want.int()).abs().max()))
                check(torch.equal(codes, want),
                      f"K6b codes {label} {x.dtype} {bits}")
                if bits <= 4:
                    packed = qops.pack4_blocks(codes)
                    pwant = qref.pack4_blocks_ref(codes)
                    worst["pack4_blocks"] = max(
                        worst["pack4_blocks"],
                        float((packed != pwant).sum()))
                    check(torch.equal(packed, pwant),
                          f"K6c bytes {label} {x.dtype} {bits}")
                with qops.count_launches() as box:
                    chain = qops.quantize_pack_threelaunch(x, bits)
                check(sum(box.counts.values()) == (3 if bits <= 4 else 2),
                      f"K6 chain launches {box.counts}")
                fused = qops.quantize_pack(x, bits)
                check(torch.equal(chain[0], fused[0])
                      and same_bits(chain[1], fused[1])
                      and same_bits(chain[2], fused[2]),
                      f"K6 chain vs K1 {label} {x.dtype} {bits}")
                if not timed:
                    continue
                wire = codes.numel() * codes.element_size()
                rows.append(dict(
                    kernel="quantize_blocks", shape=label, bits=bits,
                    ms=device_ms(torch, lambda: qops.quantize_blocks(
                        x, mn, scale, bits), flush),
                    plain_ms=device_ms(torch, lambda: qref.quantize_blocks_ref(
                        x, mn, scale, bits), flush, reps=7),
                    bound_ms=bound_ms(esize * n + 8 + wire),
                    library_ms=None))
                if bits <= 4:
                    rows.append(dict(
                        kernel="pack4_blocks", shape=label, bits=bits,
                        ms=device_ms(torch, lambda: qops.pack4_blocks(codes),
                                     flush),
                        plain_ms=device_ms(
                            torch, lambda: qref.pack4_blocks_ref(codes),
                            flush, reps=7),
                        bound_ms=bound_ms(n + (n + 1) // 2),
                        library_ms=None))
                rows.append(dict(
                    kernel="threelaunch_chain", shape=label, bits=bits,
                    ms=device_ms(
                        torch, lambda: qops.quantize_pack_threelaunch(
                            x, bits), flush),
                    fused_encode_ms=device_ms(
                        torch, lambda: qops.quantize_pack(x, bits), flush)))
                last = [r for r in rows[-3:] if r["shape"] == label
                        and r["bits"] == bits]
                print(f"  {label:5s} {bits:2d} bits  " + "  ".join(
                    f"{r['kernel']} {r['ms']:.4f} ms" for r in last)
                    + f" (K1 {last[-1]['fused_encode_ms']:.4f} ms)")
    # Warm device time per call at the stem boundary, 8 bits (K6c at 4).
    x = inputs["stem"]
    mn, mx = torch.amin(x), torch.amax(x)
    scale8 = affine_scale(mn, mx, 8)
    calls = {"minmax_blocks": (None, lambda: qops.minmax_blocks(x)),
             "quantize_blocks": (8, lambda: qops.quantize_blocks(
                 x, mn, scale8, 8))}
    codes4 = qops.quantize_blocks(x, mn, affine_scale(mn, mx, 4), 4)
    calls["pack4_blocks"] = (4, lambda: qops.pack4_blocks(codes4))
    for name, (bits, fn) in calls.items():
        r = next(r for r in rows if r["kernel"] == name
                 and r["shape"] == "stem" and r["bits"] == bits)
        r["profiled_ms"], r["device_kernels"] = profiled_ms(torch, fn)
        print(f"  {name} warm {r['profiled_ms']} ms a call; device kernels "
              f"a call: {r['device_kernels']}")
    # The chain's own path: the user's call on the served boundary, with
    # every counter set to 0 just before and read just after.
    qops.reset_launch_counts()
    for bits in K6_BITS:
        qops.quantize_pack_threelaunch(served, bits)
    torch.cuda.synchronize()
    counts = qops.launch_counts()
    print(f"threelaunch path launches: {counts}")
    for name in K6_KERNELS:
        check(counts[name] > 0, f"{name} never launched on its path")
    results["kernel_rows"] += rows
    results["max_abs_err"].update(worst)
    results["threelaunch"] = dict(launches=counts, point=K6_POINT,
                                  shape=list(served.shape))
    return rows, worst, counts


def serve_fleet(torch, results, base_params):
    """Step 6: full-width ResNet-50 through the fleet server."""
    from repro_torch.config import JaladConfig, get_config
    from repro_torch.config.types import EDGE_TK1, EDGE_TX2, DeviceProfile
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.serving.edge_cloud import EdgeCloudServer
    from repro_torch.serving.fleet import (
        FleetRequest,
        FleetServer,
        build_fleet_server,
    )
    from repro_torch.serving.workloads import make_trace
    import numpy as np

    profiles = [EDGE_TX2, EDGE_TK1, DeviceProfile("edge-mid", 1e12, 1.30),
                DeviceProfile("edge-fast", 4e12, 0.90)]
    cfg = get_config("resnet50")
    t0 = time.perf_counter()
    fleet0, params = build_fleet_server(
        cfg, JaladConfig(codec_choices=CODECS), profiles, calib_batches=1,
        calib_batch_size=4, device="cuda", tables_cache_dir=str(TABLES_DIR))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(
        _leaves(params), _leaves(base_params))),
        "fleet weights differ from the served path's")
    base = fleet0.engine
    names = base.model.decoupling_points()
    trace = make_trace(**FLEET_TRACE)
    # One stream for the whole trace: each make_batch call would rebuild
    # the 1000 class templates of 3 x 224 x 224 (seconds of host time).
    batches = ImageStream(cfg.num_classes, 4, cfg.image_size,
                          seed=500).batches(trace.n_requests)
    print(f"fleet: {len(profiles)} edges, {trace.n_requests} requests over "
          f"{trace.n_steps} steps, flash window {trace.flash_window_s} s; "
          f"build_fleet_server {build_s:.1f} s (tables reloaded)")

    def stream():
        return trace.requests(lambda uid, d: batches[uid])

    report = {}
    counts = dict.fromkeys(qops.launch_counts(), 0)
    runs = [("all", fleet0)]
    runs += [(c, FleetServer(pinned_engine(base, c), params, profiles))
             for c in CODECS]
    for label, fleet in runs:
        qops.reset_launch_counts()
        t1 = time.perf_counter()
        done = fleet.serve(stream())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        # Counted before the checks below, whose own launches do not count.
        got = qops.launch_counts()
        for name, v in got.items():
            counts[name] += v
        check(len(done) == trace.n_requests,
              f"fleet {label}: {len(done)} of {trace.n_requests} done")
        by_uid = {r.uid: r for r in done}
        for r in done:
            check(tuple(r.logits.shape) == (4, cfg.num_classes)
                  and bool(torch.isfinite(r.logits).all()),
                  f"fleet {label} request {r.uid} logits")
        # Each device alone through the synchronous server.
        for d, dev in enumerate(fleet.devices):
            ref = EdgeCloudServer(dev.engine, params)
            for uid in np.nonzero(trace.device_ids == d)[0]:
                r = by_uid[int(uid)]
                logits, bd = ref.serve_batch(batches[r.uid], r.bandwidth)
                check(r.breakdown == bd and torch.equal(r.logits, logits),
                      f"fleet {label} request {r.uid}: differs from the "
                      "synchronous server")
            check(dev.clock == ref.clock and dev.log == ref.log,
                  f"fleet {label} device {d}: clock or log differs")
        # The scalar decision plane, and the fused tail.
        scalar = FleetServer(fleet.engine, params, profiles,
                             vectorized=False).serve(stream())
        fused = FleetServer(fleet.engine, params, profiles,
                            fuse_cloud_tail=True).serve(stream())
        worst = 0.0
        for r, rs, rf in zip(done, scalar, fused):
            check(r.uid == rs.uid == rf.uid, f"fleet {label}: order")
            check(_plan(r.plan) == _plan(rs.plan)
                  and r.timeline == rs.timeline
                  and r.breakdown == rs.breakdown == rf.breakdown
                  and torch.equal(r.logits, rs.logits),
                  f"fleet {label} request {r.uid}: scalar path differs")
            scale = float(r.logits.abs().max())
            diff = float((rf.logits - r.logits).abs().max())
            worst = max(worst, diff / max(scale, 1e-30))
        check(worst <= FUSED_TAIL_RTOL,
              f"fleet {label}: fused tail off by {worst:.3e} of the scale")
        # One decode launch per decoupled cloud group.
        groups = [g for g in fleet.cloud_groups if g.key is not None]
        n_pc = sum(1 for g in groups if g.key[2] == "perchannel")
        check(got["fused_decode"] == len(groups) - n_pc
              and got["pc_decode"] == n_pc,
              f"fleet {label}: {got['fused_decode']} K2 and "
              f"{got['pc_decode']} K5 launches for {len(groups)} groups")
        check(fleet.batched_launches() >= 1,
              f"fleet {label}: no batched cloud launch")
        switches = fleet.controller.switch_count()
        check(switches >= 1, f"fleet {label}: no re-plan fired")
        plans = sorted({(names[r.plan.point] if r.plan.point >= 0
                         else "cloud", r.plan.bits, r.timeline.plan_codec)
                        for r in done})
        print(f"  fleet {label:10s} {len(done)} requests: makespan "
              f"{fleet.makespan_s * 1e3:.2f} ms vs synchronous "
              f"{fleet.synchronous_time_s() * 1e3:.2f} ms (modeled), wall "
              f"{wall * 1e3:.1f} ms, {len(fleet.cloud_groups)} cloud groups "
              f"({fleet.batched_launches()} batched), {switches} re-plans, "
              f"fused tail within {worst:.2e}; plans {plans}; launches "
              f"{ {k: v for k, v in got.items() if v} }")
        report[label] = dict(
            requests=len(done), makespan_s=fleet.makespan_s,
            synchronous_s=fleet.synchronous_time_s(), wall_s=wall,
            cloud_groups=[[list(g.key) if g.key else None, len(g.uids)]
                          for g in fleet.cloud_groups],
            batched_launches=fleet.batched_launches(), replans=switches,
            fused_tail_rel_err=worst, plans=plans, launches=got)
    print(f"fleet launches: {counts}")
    for name in KERNELS:
        check(counts[name] > 0, f"{name} never launched in the fleet")
    results["fleet"] = dict(launches=counts, build_s=build_s,
                            trace=FLEET_TRACE, runs=report)
    return counts


def tri_step_launches(plan) -> list:
    """The kernel launches of each tier's step of one three-tier request
    under ``plan``: the device's encode; at the edge server a decode and an
    encode, or nothing for a relay; the cloud's decode. None at all for
    cloud-only (the cloud runs the full forward)."""
    if plan.is_cloud_only:
        return [{}, {}, {}]
    middle = {}
    if plan.point2 != plan.point:
        middle = {DECODE_KERNEL[plan.codec]: 1, ENCODE_KERNEL[plan.codec2]: 1}
    return [{ENCODE_KERNEL[plan.codec]: 1}, middle,
            {DECODE_KERNEL[plan.codec2]: 1}]


def tri_launches(plan) -> dict:
    """The kernel launches of one three-tier request, all steps."""
    from collections import Counter

    total = Counter()
    for step in tri_step_launches(plan):
        total.update(step)
    return dict(total)


def launched(counts) -> dict:
    """Counts that moved, the Huffman host route (a deep code tree) taken
    as the encode it replaces."""
    got = {k: v for k, v in counts.items() if v}
    if "huffman_host_route" in got:
        got["huffman_pack"] = (got.get("huffman_pack", 0)
                               + got.pop("huffman_host_route"))
    return got


def tri_stage_ms(torch, runner, batch, reps: int = 5):
    """Host-clock median of each tier's step of one three-tier request,
    each ended by a synchronize, and of the three together."""
    from repro_torch.models.api import batch_to

    tb = batch_to(batch, runner.device)
    acc = {k: [] for k in ("device", "edge_server", "cloud", "request")}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps + 1):
        blob, extras = timed("device", lambda: runner.device_step(tb))
        blob2, extras = timed("edge_server", lambda: runner.edge_server_step(
            blob, extras))
        timed("cloud", lambda: runner.cloud_step(blob2, extras))
        acc["request"].append(acc["device"][-1] + acc["edge_server"][-1]
                              + acc["cloud"][-1])
    return {k: statistics.median(v[1:]) for k, v in acc.items()}


def replace_device(tri, profile):
    """The scalar three-tier space of one device: its own first tier over
    the shared pair grid (the reference test's per-device view)."""
    import dataclasses

    from repro_torch.core.planner import _readonly

    dev_vec = _readonly(profile.w * tri.cum_fmacs / profile.flops)
    return dataclasses.replace(tri, device=profile, dev_vec=dev_vec,
                               mid_vec=None).finalize()


def serve_three_tier(torch, results, base_params):
    """Step 7: full-width ResNet-50 through the three-tier server."""
    import dataclasses

    from repro_torch.config import JaladConfig, get_config
    from repro_torch.config.types import EDGE_TK1, EDGE_TX2, DeviceProfile
    from repro_torch.core.decoupler import (
        DecoupledPlan,
        DecoupledRunner,
        TriDecoupledRunner,
    )
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.api import batch_to
    from repro_torch.models.bridge import params_to
    from repro_torch.serving import (
        ThreeTierServer,
        build_three_tier_server,
        make_trace,
    )

    card = card_line()
    profiles = [EDGE_TX2, EDGE_TK1, DeviceProfile("edge-mid", 1e12, 1.30)]
    cfg = get_config("resnet50")
    t0 = time.perf_counter()
    server0, params = build_three_tier_server(
        cfg, JaladConfig(codec_choices=CODECS), profiles, calib_batches=1,
        calib_batch_size=4, device="cuda", tables_cache_dir=str(TABLES_DIR))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(
        _leaves(params), _leaves(base_params))),
        "three-tier weights differ from the served path's")
    cpu_params = params_to(params, "cpu")
    base = server0.engine
    model = base.model
    names = model.decoupling_points()
    trace = make_trace(**TRI_TRACE)
    seen = {}
    picked = []
    for r in trace.requests():
        if seen.get(r.device_id, 0) < TRI_PER_DEVICE:
            seen[r.device_id] = seen.get(r.device_id, 0) + 1
            picked.append(r)
    batches = dict(zip((r.uid for r in picked), ImageStream(
        cfg.num_classes, 4, cfg.image_size, seed=700).batches(len(picked))))
    print(f"three-tier: {len(profiles)} devices behind one edge server "
          f"({base.cfg.edge_server.name}), {len(picked)} requests of a "
          f"{trace.n_requests}-request two-link trace; "
          f"build_three_tier_server {build_s:.1f} s (tables reloaded) "
          f"[{card}]")

    def stream():
        return [dataclasses.replace(r, batch=batches[r.uid]) for r in picked]

    def name(p):
        return names[p] if p >= 0 else "cloud"

    def key(plan):
        return (plan.point, plan.bits, plan.codec, plan.point2, plan.bits2,
                plan.codec2, plan.predicted_latency, plan.predicted_acc_drop)

    report = {}
    counts = dict.fromkeys(qops.launch_counts(), 0)
    runs = [(c, ThreeTierServer(pinned_engine(base, c), params, profiles))
            for c in CODECS]
    runs.append(("all", server0))
    two_cut_served = relay_served = 0
    for label, srv in runs:
        tri = srv.fleet_space.tri
        views = [replace_device(tri, p) for p in profiles]
        done, per_request = [], []
        wall = 0.0
        # One request a serve() call: the counters are set to 0 just
        # before it and read just after it.
        for r in stream():
            qops.reset_launch_counts()
            t1 = time.perf_counter()
            done += srv.serve([r])
            torch.cuda.synchronize()
            wall += time.perf_counter() - t1
            got = qops.launch_counts()
            for k, v in got.items():
                counts[k] += v
            want = tri_launches(r.plan)
            check(launched(got) == want,
                  f"three-tier {label} request {r.uid} "
                  f"({name(r.plan.point)}>{name(r.plan.point2)}): launches "
                  f"{launched(got)}, expected {want}")
            per_request.append(launched(got))
        check(len(done) == len(picked),
              f"three-tier {label}: {len(done)} of {len(picked)} done")
        for r in done:
            bd = r.breakdown
            check(tuple(r.logits.shape) == (4, cfg.num_classes)
                  and bool(torch.isfinite(r.logits).all()),
                  f"three-tier {label} request {r.uid} logits")
            check((bd.edge_s, bd.edge_server_s, bd.cloud_s)
                  == views[r.device_id].stage_times(r.plan),
                  f"three-tier {label} request {r.uid}: stage times are "
                  "not the planner's")
            if label == "bitpack":
                s1, s2 = tri.plan_sizes(r.plan)
                check(bd.bytes_sent == int(s1) and bd.bytes_sent2 == int(s2)
                      and bd.transfer_s == s1 / r.bandwidth
                      and bd.transfer2_s == s2 / r.bandwidth2,
                      f"three-tier bitpack request {r.uid}: transfers are "
                      "not plan_sizes / bandwidth")
        two_cut = [r for r in done if r.plan.point2 > r.plan.point]
        relays = [r for r in done if not r.plan.is_cloud_only
                  and r.plan.point2 == r.plan.point]
        two_cut_served += len(two_cut)
        relay_served += len(relays)
        # A relay's blob is the two-tier runner's edge-step blob.
        for r in relays[:1]:
            p = r.plan
            tri_run = TriDecoupledRunner(model, params, p)
            blob, _ = tri_run.device_step(batches[r.uid])
            blob2, _ = tri_run.edge_server_step(blob)
            two, _ = DecoupledRunner(model, params, DecoupledPlan(
                p.point, p.bits, 0.0, 0.0, 0.0, p.codec)).edge_step(
                    batches[r.uid])
            check(blob2 is blob and blob.payload == two.payload
                  and blob.x_min.tobytes() == two.x_min.tobytes()
                  and blob.x_max.tobytes() == two.x_max.tobytes()
                  and r.breakdown.bytes_sent == r.breakdown.bytes_sent2
                  == two.nbytes,
                  f"three-tier {label} relay {r.uid}: blob differs from the "
                  "two-tier edge step")
        # The same stream on the CPU: same plans, breakdowns, timelines.
        cpu = ThreeTierServer(srv.engine, cpu_params, profiles)
        cpu_done = []
        for r in stream():
            cpu_done += cpu.serve([r])
        worst = 0.0
        for r, c in zip(done, cpu_done):
            check(r.uid == c.uid and key(r.plan) == key(c.plan)
                  and r.breakdown == c.breakdown
                  and srv.timeline_for(r.uid) == cpu.timeline_for(c.uid),
                  f"three-tier {label} request {r.uid}: the CPU run differs")
            scale = float(c.logits.abs().max())
            diff = float((r.logits.cpu() - c.logits).abs().max())
            worst = max(worst, diff / max(scale, 1e-30))
        check(worst <= LOGITS_RTOL,
              f"three-tier {label}: card vs CPU logits {worst:.3e} of scale")
        plans = sorted({(name(r.plan.point), name(r.plan.point2),
                         r.plan.bits, r.plan.bits2, r.breakdown.plan_codec)
                        for r in done})
        print(f"  three-tier {label:10s} {len(done)} requests: makespan "
              f"{srv.makespan_s * 1e3:.2f} ms vs synchronous "
              f"{srv.synchronous_time_s() * 1e3:.2f} ms (modeled), wall "
              f"{wall * 1e3:.1f} ms; {len(two_cut)} two-cut, {len(relays)} "
              f"relay; card vs CPU logits within {worst:.2e}; plans {plans} "
              f"[{card}]")
        report[label] = dict(
            requests=len(done), makespan_s=srv.makespan_s,
            synchronous_s=srv.synchronous_time_s(), wall_s=wall,
            two_cut=len(two_cut), relay=len(relays), plans=plans,
            cpu_rel_err=worst, launches=per_request)
    check(relay_served > 0, "three-tier: no relay plan served")
    # The pinned two-cut plan through TriDecoupledRunner, for each codec:
    # per-step launches, logits against the full forward, card times.
    p1, p2 = names.index(TRI_PINNED[0]), names.index(TRI_PINNED[1])
    bits = TRI_PINNED[2]
    batch = batches[picked[0].uid]
    with torch.no_grad():
        full = model.forward(params, batch_to(batch, "cuda"))
    pinned = {}
    for codec in CODECS:
        plan = DecoupledPlan(p1, bits, 0.0, 0.0, 0.0, codec, point2=p2,
                             bits2=bits, codec2=codec)
        runner = TriDecoupledRunner(model, params, plan)
        with qops.count_launches() as b1:
            blob, _ = runner.device_step(batch)
        with qops.count_launches() as b2:
            blob2, _ = runner.edge_server_step(blob)
        with qops.count_launches() as b3:
            logits = runner.cloud_step(blob2)
        steps = [launched(b.counts) for b in (b1, b2, b3)]
        check(steps == tri_step_launches(plan),
              f"three-tier pinned {codec}: launches a step {steps}, "
              f"expected {tri_step_launches(plan)}")
        scale = float(full.abs().max())
        rel = float((logits - full).abs().max()) / max(scale, 1e-30)
        check(bool(torch.isfinite(logits).all()) and rel <= LOGITS_RTOL,
              f"three-tier pinned {codec}: logits off the full forward by "
              f"{rel:.3e} of the scale")
        ms = tri_stage_ms(torch, runner, batch)
        modeled = base.tri_space.stage_times(plan)
        pinned[codec] = dict(plan=[TRI_PINNED[0], TRI_PINNED[1], bits],
                             bytes=[blob.nbytes, blob2.nbytes],
                             launches=steps, full_forward_rel_err=rel,
                             card_ms=ms, modeled_s=list(modeled))
        print(f"  three-tier pinned {codec:10s} {TRI_PINNED[0]}>"
              f"{TRI_PINNED[1]} {bits} bits: bytes {blob.nbytes} + "
              f"{blob2.nbytes}, logits within {rel:.2e} of the full forward;"
              f" card device {ms['device']:.3f} ms, edge server "
              f"{ms['edge_server']:.3f} ms, cloud {ms['cloud']:.3f} ms, "
              f"request {ms['request']:.3f} ms (host clock, median of 5) "
              f"[{card}]")
    print(f"three-tier launches: {counts}; two-cut plans served: "
          f"{two_cut_served} [{card}]")
    for kname in KERNELS:
        check(counts[kname] > 0, f"{kname} never launched on three tiers")
    results["three_tier"] = dict(
        card=card, launches=counts, build_s=build_s, trace=TRI_TRACE,
        per_device=TRI_PER_DEVICE, two_cut_served=two_cut_served,
        relay_served=relay_served, runs=report, pinned=pinned)
    return counts


def lm_requests(vocab: int, n: int, seed: int):
    """Step 8's staggered requests: (prompt, max_new_tokens, arrival)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(*LM_PROMPTS)))
             .astype(np.int32), int(rng.integers(*LM_NEW)), i // 2)
            for i in range(n)]


def lm_run(engine, reqs, solo: bool = False,
           temperature: float = 0.0) -> dict:
    """Serve ``reqs`` through ``engine`` (arrivals dropped when ``solo``);
    the tokens of each request by uid."""
    from repro_torch.serving.scheduler import GenRequest

    for i, (prompt, new, arrival) in reqs:
        engine.submit(GenRequest(uid=i, tokens=prompt, max_new_tokens=new,
                                 temperature=temperature,
                                 arrival=0 if solo else arrival))
    return {r.uid: r.result.tolist() for r in engine.run()}


def lm_solo_equal(make, reqs, batched: dict, what: str,
                  temperature: float = 0.0) -> None:
    """Each request served alone by a one-slot ``make()`` gives the tokens
    of the batched run."""
    for i, req in reqs:
        alone = lm_run(make(), [(i, req)], solo=True,
                       temperature=temperature)
        check(alone[i] == batched[i],
              f"{what}: request {i} batched {batched[i]} != alone "
              f"{alone[i]}")


def check_rows_invariant(torch, model, params, reqs) -> int:
    """One batched decode step of the engine's shape (``DECODE_ROWS``
    rows, the first LM_MAX_BATCH live, each at its own position) against
    each request decoded alone in row 0 of a decode of the same shape:
    the logits must be equal bit for bit. Returns the rows compared."""
    from repro_torch.serving.scheduler import DECODE_ROWS, copy_into_row

    dev = torch.device("cuda")
    rows = -(-LM_MAX_BATCH // DECODE_ROWS) * DECODE_ROWS

    def zeros():
        return (model.init_caches(rows, LM_SEQ, dev),
                torch.zeros((rows, 1), dtype=torch.int64, device=dev),
                torch.zeros(rows, dtype=torch.int64, device=dev),
                torch.zeros(rows, dtype=torch.bool, device=dev))

    caches, last, pos, live = zeros()
    alone = []
    with torch.no_grad():
        for r, (_, (prompt, _, _)) in enumerate(reqs[:LM_MAX_BATCH]):
            tokens = torch.as_tensor(prompt[None], dtype=torch.int64,
                                     device=dev)
            lg, one = model.prefill(params, {"tokens": tokens}, LM_SEQ)
            solo = zeros()
            for row, (c, t, p, lv) in ((r, (caches, last, pos, live)),
                                       (0, solo)):
                copy_into_row(c, one, row)
                t[row, 0] = lg[0, -1].argmax()
                p[row] = len(prompt)
                lv[row] = True
            alone.append(solo)
        logits, _ = model.decode_step(params, last, pos, caches, live)
        for r, (c, t, p, lv) in enumerate(alone):
            lg, _ = model.decode_step(params, t, p, c, lv)
            check(torch.equal(logits[r], lg[0]),
                  f"decode row {r} of {rows} != the request alone")
    return len(alone)


def check_stream_kernels(torch, frames):
    """K1/K2, K3 and K4/K5 on real boundary frames of the stream: stacks
    of k = 1..4 rows of (1, 1, d) and one prompt frame (1, S, d), bf16,
    at every width of LM_KERNEL_BITS: codes, words and ranges byte for
    byte, decodes bit for bit (bf16 out, the cloud's dtype). Returns the
    largest difference of each kernel and its time on the k = 4 stack."""
    import numpy as np

    from repro_torch.core.quantization import dequant_step
    from repro_torch.kernels.entropy import ops as eops
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    worst = dict.fromkeys(KERNELS, 0.0)
    times = {}
    rows, prompt = frames
    stacks = [rows[:k] for k in range(1, rows.shape[0] + 1)] + [prompt]
    for x in stacks:
        k, shape = x.shape[0], tuple(x.shape[1:])
        xb = x.reshape(k, -1)
        n = xb.shape[1]
        label = f"{k}x{shape}"
        for bits in LM_KERNEL_BITS:
            packed = bits <= 4
            codes, mn, mx = qops.fused_encode(xb, bits)
            pc, pmn, pmx = qref.fused_encode_ref(xb, bits)
            worst["fused_encode"] = max(worst["fused_encode"], float(
                (codes.to(torch.int32) - pc.to(torch.int32)).abs().max()))
            check(torch.equal(codes, pc) and same_bits(mn, pmn)
                  and same_bits(mx, pmx), f"K1 stream {label} {bits}")
            layouts = [(codes, packed)]
            if packed:
                q = torch.stack([codes & 15, codes >> 4], -1).reshape(k, -1)
                layouts.append((q[:, :n].contiguous(), False))
            step = dequant_step(mn, mx, bits)
            for cc, pk in layouts:
                got = qops.fused_decode(cc, mn, mx, bits, n, pk,
                                        torch.bfloat16)
                want = qref.fused_decode_ref(cc, mn, step, n, pk,
                                             torch.bfloat16)
                worst["fused_decode"] = max(worst["fused_decode"], float(
                    (got.float() - want.float()).abs().max()))
                check(torch.equal(got.view(torch.int16),
                                  want.view(torch.int16)),
                      f"K2 stream {label} {bits} packed={pk}")
            hist, hmn, _, scale = eops._hist_ranges(xb, bits)
            tables = [eops._sample_table(h, 1 << bits)
                      for h in hist.cpu().numpy()]
            check(all(t is not None for t in tables),
                  f"K3 stream {label} {bits}: a table took the host route")
            hargs = (xb, hmn, scale,
                     torch.from_numpy(np.stack(
                         [t[0] for t in tables]).view("int32")).cuda(),
                     torch.from_numpy(np.stack(
                         [t[1] for t in tables])).cuda(), bits,
                     eops._w_words(max(t[3] for t in tables)))
            words = eops.huffman_pack(*hargs)
            pwords = eops.huffman_pack_ref(*hargs)
            worst["huffman_pack"] = max(worst["huffman_pack"],
                                        float((words != pwords).sum()))
            check(torch.equal(words, pwords), f"K3 stream {label} {bits}")
            axis = len(shape) - 1          # perchannel.channel_axis(3) == 2
            pw, pmn2, pmx2 = qops.pc_encode(x, bits, axis)
            rw, rmn, rmx = qref.pc_encode_ref(x, bits, axis)
            worst["pc_encode"] = max(worst["pc_encode"],
                                     float((pw != rw).sum()))
            check(torch.equal(pw, rw) and same_bits(pmn2, rmn)
                  and same_bits(pmx2, rmx), f"K4 stream {label} {bits}")
            got = qops.pc_decode(pw, pmn2, pmx2, bits, shape, axis,
                                 torch.bfloat16)
            want = qref.pc_decode_ref(pw, pmn2, pmx2, bits, shape, axis,
                                      torch.bfloat16)
            worst["pc_decode"] = max(worst["pc_decode"], float(
                (got.float() - want.float()).abs().max()))
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"K5 stream {label} {bits}")
            if k == rows.shape[0] and shape == tuple(rows.shape[1:]) \
                    and bits == 8:
                times = {
                    "shape": label,
                    "fused_encode": device_ms(
                        torch, lambda: qops.fused_encode(xb, bits), flush),
                    "fused_decode": device_ms(
                        torch, lambda: qops.fused_decode(
                            codes, mn, mx, bits, n, False, torch.bfloat16),
                        flush),
                    "huffman_pack": device_ms(
                        torch, lambda: eops.huffman_pack(*hargs), flush),
                    "pc_encode": device_ms(
                        torch, lambda: qops.pc_encode(x, bits, axis), flush),
                    "pc_decode": device_ms(
                        torch, lambda: qops.pc_decode(
                            pw, pmn2, pmx2, bits, shape, axis,
                            torch.bfloat16), flush)}
    return worst, times


def timed_stream_run(torch, sess, reqs, temperature: float) -> dict:
    """The batched session's engine loop, phase by phase, with a
    synchronize and a host-clock reading after each phase: per join
    (prefill across the cut) and per step the head decode, the encode,
    the decode and the tail (tail decode + token select). Returns the
    tokens and the per-phase times."""
    from repro_torch.serving.scheduler import GenRequest

    for i, (prompt, new, arrival) in reqs:
        sess.submit(GenRequest(uid=i, tokens=prompt, max_new_tokens=new,
                               temperature=temperature, arrival=arrival))
    phases = {"join": [], "head": [], "encode": [], "decode": [],
              "tail": [], "frame_bytes": []}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    with torch.no_grad():
        while sess.queue or sess.num_active:
            sess.step_count += 1
            t0 = clock()
            joins = len(sess.events)
            sess._admit()
            t1 = clock()
            n_join = sum(1 for e in sess.events[joins:] if e[0] == "join")
            if n_join:
                phases["join"].append((t1 - t0) * 1e3 / n_join)
            active = sess._active_slots()
            if not active:
                continue
            rows, live = sess._head_phase(active)
            t2 = clock()
            blobs = sess._codec.encode_batch(rows, sess.plan.bits)
            t3 = clock()
            sess._account_encode(active, blobs)
            xs = sess._codec.decode_batch(blobs, out_dtype=sess._cloud_dtype,
                                          device=sess.device)
            t4 = clock()
            sess._finish_step(active, sess._tail_phase(active, live, xs))
            t5 = clock()
            for key, (a, b) in (("head", (t1, t2)), ("encode", (t2, t3)),
                                ("decode", (t3, t4)), ("tail", (t4, t5))):
                phases[key].append((b - a) * 1e3)
            phases["frame_bytes"] += [b.stream_nbytes for b in blobs]
    phases["tokens"] = {r.uid: r.result.tolist() for r in sess.completed}
    return phases


def profile_stream_steps(torch, sess, vocab: int) -> dict:
    """Where a stream step's time goes: LM_MAX_BATCH long requests join,
    two warm steps run, then ``torch.profiler`` traces LM_PROFILE_STEPS
    steps. Returns the host-clock time a step, the device kernels a step
    and their summed device time; busy share = device time / step time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import GenRequest

    rng = np.random.default_rng(2)
    for i in range(LM_MAX_BATCH):
        sess.submit(GenRequest(uid=i, tokens=rng.integers(
            1, vocab, size=16).astype(np.int32), max_new_tokens=32))
    for _ in range(2):
        sess.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_STEPS):
            sess.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    step_ms = wall * 1e3 / LM_PROFILE_STEPS
    return dict(step_ms=step_ms,
                kernels_per_step=len(kernels) / LM_PROFILE_STEPS,
                device_ms_per_step=busy_ms / LM_PROFILE_STEPS,
                busy_share=busy_ms / LM_PROFILE_STEPS / step_ms)


def serve_lm(torch, results):
    """Step 8: full-width olmo-1b (bfloat16, random weights from seed 0)
    through ServeSession, the continuous-batching engine and token
    streaming across the JALAD cut with each codec."""
    import numpy as np

    from repro_torch.config import JaladConfig, ServeConfig, get_config
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.api import batch_to, build_model
    from repro_torch.models.bridge import params_to
    from repro_torch.serving.edge_cloud import build_edge_cloud_server
    from repro_torch.serving.engine import ServeSession
    from repro_torch.serving.scheduler import (
        ContinuousBatchingEngine,
        GenRequest,
    )

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    names = model.decoupling_points()
    print(f"LM: {cfg.arch_id} ({model.param_count():,} parameters, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}); "
          f"weights from seed 0 in {init_s:.1f} s")
    out = dict(card=card_line(), arch=cfg.arch_id,
               params=model.param_count(), init_s=init_s)

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    # (a) ServeSession, and split against unsplit at three points.
    b, s, new = LM_SESSION
    sc = ServeConfig(max_batch=b, max_seq_len=s + new)
    batch = make_batch(cfg, b, s, seed=0)
    tb = batch_to(batch, dev)
    with torch.no_grad():
        prefill_ms = []
        for _ in range(3):
            t1 = clock()
            ref_logits, ref_caches = model.prefill(params, tb, s + new)
            prefill_ms.append((clock() - t1) * 1e3)
        check(tuple(ref_logits.shape) == (b, s, cfg.vocab_size)
              and bool(torch.isfinite(ref_logits).all()),
              "LM prefill logits")
        nxt = ref_logits[:, -1].argmax(-1)[:, None]
        ref_step, _ = model.decode_step(params, nxt, s, [
            {k: v.clone() for k, v in c.items()} for c in ref_caches])
        for point in LM_SPLIT_POINTS:
            boundary, head = model.prefill_head(params, tb, s + new, point)
            logits, tail = model.prefill_tail(params, boundary, s + new,
                                              point)
            check(torch.equal(logits, ref_logits),
                  f"split prefill at {names[point]} != unsplit")
            bnd, _ = model.decode_head(params, nxt, s, head, point, s + new)
            step, _ = model.decode_tail(params, bnd, s, tail, point, s + new)
            check(torch.equal(step, ref_step),
                  f"split decode at {names[point]} != unsplit")
    t1 = clock()
    toks = ServeSession(model, params, sc).generate(batch, new)
    gen_ms = (clock() - t1) * 1e3
    check(toks.shape == (b, new), f"ServeSession tokens {toks.shape}")
    session = dict(batch=b, prompt=s, tokens=new,
                   prefill_ms=statistics.median(prefill_ms),
                   generate_ms=gen_ms,
                   per_token_ms=(gen_ms - statistics.median(prefill_ms))
                   / (new - 1),
                   split_points=[names[p] for p in LM_SPLIT_POINTS])
    print(f"  (a) ServeSession batch {b}, prompt {s}, {new} greedy tokens "
          f"in {gen_ms:.1f} ms (prefill {session['prefill_ms']:.2f} ms, "
          f"{session['per_token_ms']:.2f} ms a decode step); split == "
          f"unsplit bitwise at {session['split_points']}")

    # (b) Continuous batching: batched against one-slot engines.
    reqs = list(enumerate(lm_requests(cfg.vocab_size, LM_REQUESTS, seed=1)))
    esc = ServeConfig(max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ)
    eng = ContinuousBatchingEngine(model, params, esc)
    t1 = clock()
    batched = lm_run(eng, reqs)
    eng_ms = (clock() - t1) * 1e3
    solo_engine = lambda: ContinuousBatchingEngine(  # noqa: E731
        model, params, ServeConfig(max_batch=1, max_seq_len=LM_SEQ))
    lm_solo_equal(solo_engine, reqs, batched, "engine")
    # Random weights make greedy decoding repeat a token, so the same
    # requests also sample (each from its own generator): a row that
    # rounded differently batched would draw other tokens from then on.
    sampled = lm_run(ContinuousBatchingEngine(model, params, esc), reqs,
                     temperature=LM_TEMPERATURE)
    lm_solo_equal(solo_engine, reqs, sampled, "engine, sampled",
                  LM_TEMPERATURE)
    n_rows = check_rows_invariant(torch, model, params, reqs)
    n_tok = sum(len(v) for v in batched.values())
    engine = dict(requests=len(reqs), max_batch=LM_MAX_BATCH,
                  steps=eng.step_count, tokens=n_tok, wall_ms=eng_ms,
                  tokens_per_s=n_tok / eng_ms * 1e3,
                  distinct_tokens=[len(set(v)) for _, v in
                                   sorted(batched.items())],
                  distinct_sampled=[len(set(v)) for _, v in
                                    sorted(sampled.items())])
    print(f"  (b) engine: {len(reqs)} requests on {LM_MAX_BATCH} slots, "
          f"{eng.step_count} steps, {n_tok} tokens in {eng_ms:.1f} ms "
          f"({engine['tokens_per_s']:.1f} tokens/s; distinct tokens a "
          f"request {engine['distinct_tokens']}, sampled at "
          f"T={LM_TEMPERATURE} {engine['distinct_sampled']}); each "
          f"request's tokens, greedy and sampled, == a one-slot engine's; "
          f"decode logits of {n_rows} live rows == each alone, bitwise")

    # (c) Streaming across the cut.
    jc = JaladConfig(codec_choices=CODECS)
    t1 = clock()
    server, _ = build_edge_cloud_server(
        cfg, jc, calib_batches=1, calib_batch_size=2, seq_len=s,
        params=params)
    calib_s = clock() - t1
    print(f"  (c) build_edge_cloud_server: calibration over "
          f"{len(names)} points x {len(jc.bits_choices)} widths x "
          f"{len(CODECS)} codecs, batch 2 x {s} tokens, in {calib_s:.1f} s")
    decisions = {}
    for bw in LM_BANDWIDTHS:
        p = server.engine.decide_streaming(bw, expected_tokens=128.0)
        decisions[bw] = _plan(p)
        where = names[p.point] if p.point >= 0 else "cloud"
        print(f"  (c) decide_streaming at {bw:.0e} B/s, 128 tokens: "
              f"{where} {p.bits} bits {p.codec or '-'} (predicted "
              f"{p.predicted_latency:.4f} s)")
    with torch.no_grad():
        prompt_b, _ = model.prefill_head(
            params, batch_to({"tokens": batch["tokens"][:1]}, dev), s,
            LM_STREAM_POINT)
    frames = (prompt_b[0, :LM_MAX_BATCH].reshape(LM_MAX_BATCH, 1, 1, -1),
              prompt_b)
    worst, kernel_ms = check_stream_kernels(torch, frames)
    print(f"  stream-shape kernels == plain versions (max diff {worst}); "
          f"8-bit times on {kernel_ms['shape']}: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in kernel_ms.items()
              if k != "shape"))
    ssc = ServeConfig(max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ)
    enc_of = {"bitpack": "fused_encode", "huffman": "huffman_pack",
              "perchannel": "pc_encode"}
    dec_of = {"bitpack": "fused_decode", "huffman": "fused_decode",
              "perchannel": "pc_decode"}
    counts = dict.fromkeys(qops.launch_counts(), 0)
    streams = {}
    for codec in CODECS:
        plan = DecoupledPlan(LM_STREAM_POINT, LM_STREAM_BITS, 0.0, 0.0, 0.0,
                             codec)
        runner = server.engine.make_runner(params, plan)
        sess = runner.stream_session(ssc)
        for i, (prompt, n_new, arrival) in reqs:
            sess.submit(GenRequest(uid=i, tokens=prompt,
                                   max_new_tokens=n_new,
                                   temperature=LM_TEMPERATURE,
                                   arrival=arrival))
        steps = grouped_steps = 0
        t1 = clock()
        while sess.queue or sess.num_active:
            joins, groups = len(sess.events), len(sess.encode_groups)
            qops.reset_launch_counts()
            sess.step()
            got = qops.launch_counts()
            n_join = sum(1 for e in sess.events[joins:] if e[0] == "join")
            grouped = len(sess.encode_groups) - groups
            want = dict.fromkeys(got, 0)
            want[enc_of[codec]] += n_join + grouped
            want[dec_of[codec]] += n_join + grouped
            check(grouped <= 1 and got == want,
                  f"stream {codec} step {sess.step_count}: launches "
                  f"{ {k: v for k, v in got.items() if v} }, expected "
                  f"{ {k: v for k, v in want.items() if v} } ({n_join} "
                  f"joins, {grouped} grouped encode)")
            for k, v in got.items():
                counts[k] += v
            steps += 1
            grouped_steps += grouped
        wall_ms = (clock() - t1) * 1e3
        toks = {r.uid: r.result.tolist() for r in sess.completed}
        lm_solo_equal(lambda: runner.stream_session(ServeConfig(
            max_batch=1, max_seq_len=LM_SEQ)), reqs, toks,
            f"stream {codec}", LM_TEMPERATURE)
        timed = timed_stream_run(torch, runner.stream_session(ssc), reqs,
                                 LM_TEMPERATURE)
        check(timed["tokens"] == toks,
              f"stream {codec}: the timed run's tokens differ")
        med = {k: statistics.median(timed[k])
               for k in ("join", "head", "encode", "decode", "tail")}
        prof = profile_stream_steps(torch, runner.stream_session(ssc),
                                    cfg.vocab_size)
        streams[codec] = dict(
            plan=dict(point=names[LM_STREAM_POINT], bits=LM_STREAM_BITS),
            steps=steps, grouped_steps=grouped_steps,
            tokens=sess.tokens_out, wall_ms=wall_ms,
            tokens_per_s=sess.tokens_out / wall_ms * 1e3,
            bytes_sent=sess.bytes_sent, header_bytes=sess.header.nbytes,
            frame_bytes=statistics.mean(timed["frame_bytes"]),
            kv_bytes_ratio=sess.kv_bytes_ratio, ms=med, profile=prof,
            distinct_tokens=[len(set(v)) for _, v in sorted(toks.items())])
        print(f"  (c) {codec:10s} at {names[LM_STREAM_POINT]}/"
              f"{LM_STREAM_BITS} bits: {steps} steps ({grouped_steps} "
              f"grouped encodes), {sess.tokens_out} tokens in "
              f"{wall_ms:.1f} ms ({streams[codec]['tokens_per_s']:.1f} "
              f"tokens/s); a token: head {med['head']:.3f} ms, encode "
              f"{med['encode']:.3f}, decode {med['decode']:.3f}, tail "
              f"{med['tail']:.3f}; a join {med['join']:.2f} ms; "
              f"{streams[codec]['frame_bytes']:.1f} B a frame; int8 KV "
              f"{sess.kv_bytes_ratio:.4f} of bf16; sampled tokens (distinct "
              f"a request {streams[codec]['distinct_tokens']}) == alone")
        print(f"      profiled ({LM_MAX_BATCH} active slots, "
              f"{LM_PROFILE_STEPS} steps): {prof['step_ms']:.2f} ms a step, "
              f"{prof['kernels_per_step']:.0f} device kernels a step, "
              f"{prof['device_ms_per_step']:.3f} ms of device time "
              f"(busy {prof['busy_share']:.1%}, idle "
              f"{1 - prof['busy_share']:.1%})")
    for codec in CODECS:
        for name in (enc_of[codec], dec_of[codec]):
            check(counts[name] > 0, f"{name} never launched on the stream")
    check(counts["huffman_host_route"] == 0, "a Huffman frame took the host")

    # The same path at a small size, card against CPU: reduced olmo-1b in
    # float32, its prefill logits and greedy tokens.
    small = get_config(LM_ARCH).reduced()
    sm = build_model(small)
    cpu_p = sm.init(0, "cpu")
    card_p = params_to(cpu_p, dev)
    sb = make_batch(small, 2, 12, seed=3)
    with torch.no_grad():
        lc = sm.forward(card_p, batch_to(sb, dev)).cpu()
        lh = sm.forward(cpu_p, batch_to(sb, "cpu"))
    rel = float((lc - lh).abs().max() / lh.abs().max())
    check(rel <= LM_SMALL_RTOL, f"reduced LM card/cpu logits {rel:.2e}")
    ssc2 = ServeConfig(max_batch=2, max_seq_len=24)
    tc = ServeSession(sm, card_p, ssc2).generate(sb, 8)
    th = ServeSession(sm, cpu_p, ssc2).generate(sb, 8)
    check((tc == th).all(), "reduced LM card/cpu tokens")
    print(f"  reduced {LM_ARCH} f32: card vs CPU logits {rel:.2e} of scale "
          f"(rtol {LM_SMALL_RTOL}), greedy tokens equal; lm stream "
          f"launches {({k: v for k, v in counts.items() if v})}")
    out.update(session=session, engine=engine, calibration_s=calib_s,
               decisions={str(k): v for k, v in decisions.items()},
               kernel_max_diff=worst, kernel_ms=kernel_ms, streams=streams,
               launches=counts, small_rel=rel)
    results["lm"] = out
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _plan(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


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
            text = log.read_text()
            regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
            smem = [int(v) for v in re.findall(r"(\d+) bytes smem", text)]
            spills = sum(int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", text))
            print(f"  ptxas {name}: {len(regs)} kernels, registers "
                  f"{min(regs, default=0)}-{max(regs, default=0)}, smem up to "
                  f"{max(smem, default=0)} B, spill bytes {spills}")
    results["build_s"] = build_s
    step_s = results["step_s"] = {}

    def step(name, fn, *a):
        t1 = time.perf_counter()
        out = fn(torch, results, *a)
        step_s[name] = time.perf_counter() - t1
        print(f"[{name}: {step_s[name]:.1f} s]")
        return out

    rows, worst = step("kernels", check_kernels)
    pc_rows, _ = step("perchannel kernels", check_perchannel_kernels)
    rows = rows + pc_rows
    served, base, params = step("served path", serve_main_path)
    piped = step("pipeline", serve_pipeline, base, params)
    k6_rows, _, k6_path = step("three-launch chain",
                               check_threelaunch_kernels, base, params)
    rows += k6_rows
    fleet = step("fleet", serve_fleet, params)
    three = step("three-tier", serve_three_tier, params)
    lm = step("lm serving", serve_lm)
    paths = {"served": served, "pipeline": piped, "fleet": fleet,
             "threelaunch": k6_path, "three_tier": three, "lm_stream": lm}

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
        "pc_encode": ("src/repro_torch/csrc/perchannel.cu",
                      "src/repro/kernels/quantize/quantize.py:321"),
        "pc_decode": ("src/repro_torch/csrc/perchannel.cu",
                      "src/repro/kernels/quantize/quantize.py:376"),
        "minmax_blocks": ("src/repro_torch/csrc/threelaunch.cu",
                          "src/repro/kernels/quantize/quantize.py:430"),
        "quantize_blocks": ("src/repro_torch/csrc/threelaunch.cu",
                            "src/repro/kernels/quantize/quantize.py:462"),
        "pack4_blocks": ("src/repro_torch/csrc/threelaunch.cu",
                         "src/repro/kernels/quantize/quantize.py:491"),
    }
    # The kernels line's times: the stem boundary at 8 bits (K6a has no
    # width; K6c runs at 4 bits or fewer).
    line_bits = {"minmax_blocks": None, "pack4_blocks": 4}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = row(name, bits=line_bits.get(name, 8))
        by_path = {p: c[name] for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": worst[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "warm_ms": r.get("profiled_ms"),
            "device_kernels": r.get("device_kernels")})
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
