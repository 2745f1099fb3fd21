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
5. Holds the three-launch encode chain K6a (range), K6b (quantize), K6c
   (nibble pack) against the plain versions at the stem, res5 and odd
   shapes, each taken as one tensor, in float32 and bfloat16, on the real
   ``stem_pool`` boundary of a served request, on signed-zero inputs and on
   the odd shape off every 16-byte boundary, at 2, 3, 4, 8 and 16 bits:
   K6a's range by bits (also against ``ordered_aminmax``), codes and
   packed bytes byte-identical, the chain's ``(codes, mn, mx)``
   byte-identical to K1's ``quantize_pack``, exactly 3 launches a call at
   4 bits or fewer and 2 above; under ``torch.profiler`` the chain must run
   exactly those kernels and at most one memset a call. Its cold time is
   printed beside K1's. Then drives ``quantize_pack_threelaunch`` on the
   served boundary with the counters set to 0 before and read after.
   K6c is also held on that boundary's 4-bit codes taken 1 to 15 bytes
   off their 16-byte boundary (its byte-wise branch).
5b. The paper's RL channel removal on the same served ``stem_pool``
   boundary, counters set to 0 before and read after: a
   ``ChannelRemovalPolicy`` over its 64 channels at ``JaladConfig``'s
   budget trains for ``CR_STEPS`` steps, each ``evaluate(mask)`` the top-1
   disagreement of the port's tail on the masked boundary with the tail on
   the unmasked one, on the card; its deterministic mask is applied with
   ``apply_channel_mask`` and both boundaries are encoded by ``compress``
   (K3) at ``CR_BITS``. Prints the kept channels, the bytes unmasked and
   masked (Huffman and ``transfer_size_bytes``), the disagreement and the
   phase's wall time. Fails unless the masked boundary equals the CPU run
   of ``apply_channel_mask`` bit for bit, ``compress``'s payload equals the
   Huffman codec's blob payload and the CPU run's, ``decompress`` is
   within half a quantization step (and 8 float32 ulps of the range), and
   ``transfer_size_bytes`` equals the exact Huffman size of the decoded
   codes, the CPU run's, and lies within 64 bytes of ``nbytes``.
5c. K7a (append) and K7b (attend), the int8 KV cache's decode step
   (``kernels/attention/ops.py`` ``kv8_decode``), at the olmo-1b.stream_chat
   cell's shapes (``KV8_SHAPE``: 32 rows of 2,048 slots, 16 kv heads of
   128, bf16, lengths from ``bench/traffic/closed_chat.py``'s grid):
   codes, scales and cache rows equal the plain composition's bit for bit,
   one launch of each counter a call, the output's error against float64
   attention at most 2^-8 of its scale and no more than the plain
   version's plus 2^-9. Times one layer's call cold, eight layers' calls
   (eight caches) back to back, each kernel warm and the plain composition,
   beside the bound (the valid slots' codes and scales at 3.35 TB/s).
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
   steps the device kernels and busy share of a step; (f) two sessions of
   three of the requests each, on one plan (``seg0_d7``, 8 bits,
   bitpack), attached to one ``FleetServer`` and stepped by
   ``step_streams`` with the counters set to 0 around each step: one K1
   and one K2 launch for the step's cloud group (both sessions' rows in
   one launch) plus one of each a join, and each session's tokens equal to
   the same session run alone. Then reduced olmo-1b in float32, card
   against CPU: logits within ``LM_SMALL_RTOL``, equal greedy tokens.
9. Serves the recurrent families at full width and cut depth, bfloat16,
   random weights from seed 0: zamba2-2.7b at 24 of its 54 Mamba2 blocks
   (one shared attention block after every 6) and xlstm-1.3b at its first
   24 of 48 blocks (21 mLSTM, 3 sLSTM), each through the phases of step
   8: (a) ``ServeSession``
   (batch 4, prompt 32, 16 tokens; prefill and decode-step times), split
   equal to unsplit bit for bit at the points of ``RNN_ARCHS`` (zamba2:
   either side of an ``A`` too), and for zamba2 one 512-token prefill,
   which takes the chunked SSD, held against the sequential scan within
   ``RNN_CHUNK_RTOL``; (b) the engine, greedy and sampled, batched equal
   to solo; (c) ``build_edge_cloud_server`` and ``decide_streaming``, the
   stream kernels K1–K5 byte for byte on real frames of k = 1..4 rows of
   (1, 1, 2560) or (1, 1, 2048), and for each codec the stream pinned at
   the middle point, 8 bits, with one encode and one decode launch a step
   group plus one of each a join, batched equal to solo for
   ``RNN_SOLO_CODEC`` (zamba2's tail KV stays bf16:
   ``RNN_CLOUD_KV_BITS``; int8 is refused, checked); (d)
   ``compress_state`` at 8 bits on the prefill's caches, each leaf within
   half a quantization step of its range; (e) 5 profiled stream steps.
   Then each model reduced, float32, card against CPU.
10. Serves the MoE family at full width and cut depth, bfloat16, random
   weights from seed 0 drawn on the card (``draw="device"``):
   grok-1-314b at its first 4 blocks (``eeee``, 21.3 B parameters) and
   llama4-maverick-400b-a17b at its first 3 (``ded``, 18.6 B); 80 GB hold
   no more. Each through the phases of step 8: (a) ``ServeSession``
   (batch 4, prompt 32, 16 tokens), split equal to unsplit bit for bit at
   the points of ``MOE_ARCHS``, and one 512-token prefill (two routing
   groups of 256) whose capacity drops the port counts, held against a
   plain recount of the same routing (one row of random tokens, one of
   a repeated token, which must drop); (b) the engine, greedy and
   sampled, batched equal to solo; (c) ``build_edge_cloud_server`` and
   ``decide_streaming``, K1–K5 byte for byte on real frames of k = 1..4
   rows of (1, 1, 6144) or (1, 1, 5120) and a 32-token prompt, and for
   each codec the stream pinned at ``MOE_ARCHS``' point, 8 bits, int8
   tail KV (its bytes ratio checked), one encode and one decode launch a
   step group plus one of each a join, batched equal to solo for
   ``RNN_SOLO_CODEC``; (d) 5 profiled stream steps; (e) each model
   reduced, float32, card against CPU. Prints each model's weight-draw
   time and peak device memory.
11. Serves the vlm and audio families at full width and depth, bfloat16,
   random weights from seed 0 drawn on the card: qwen2-vl-7b (28 blocks,
   M-RoPE, a 16-row stub vision prefix) and seamless-m4t-large-v2 (24
   encoder and 24 cross-attention decoder blocks, 8 stub source frames),
   across the one-shot cut (their token streams are refused, as in the
   reference): (a) ``ServeSession`` (batch 4, prompt 32, 16 tokens;
   prefill and decode-step times), ``run_head`` -> ``run_tail`` with the
   extras equal to the forward bit for bit at the first, middle and last
   points, and ``run_segment`` chained the same way; (b)
   ``build_edge_cloud_server`` over the three codecs (calibration timed),
   ``decide`` at two bandwidths, and for each codec the plan pinned at the
   middle point, 8 bits, serving 4 requests through ``serve_batch`` with
   the counters set to 0 before and read after each: one encode and one
   decode launch a request, logits equal to the plain path's bit for bit
   and within ``MM_LOGITS_SHARE`` of the full forward's scale, and K1–K5
   byte for byte against their plain versions on the real boundary; (c)
   the vlm's engine on text prompts, greedy and sampled, batched equal to
   solo; the audio engine refused (no ``src_frames``); (d) each model
   reduced, float32, card against CPU.
12. Trains full-width olmo-1b (bfloat16, 1,176,764,416 parameters,
   random weights from seed 0 drawn on the card): (a) reduced olmo-1b and
   reduced grok-1-314b (its load-balance loss in the loss), float32, TF32
   off, ``TRAIN_SMALL_STEPS`` steps of ``train`` on the card and on the
   CPU from the same weights and batches: losses within
   ``TRAIN_SMALL_LOSS_RTOL``, AdamW moments within
   ``TRAIN_SMALL_MOMENT_RTOL`` of each leaf's scale, parameters within
   ``TRAIN_SMALL_LRS`` times the summed learning rate; (b) ``train()``
   at full width and depth, ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x
   ``TRAIN_SEQ`` tokens from ``ShardedLoader``: the median step time,
   tokens/s, peak memory, the
   losses (the mean of the last three must be below the first three's)
   and the step's share of the bf16 peak (the model's own
   ``analytic_step_flops``); (c) ``save_checkpoint`` of the
   parameters and the AdamW state to a temporary directory and
   ``restore_checkpoint``, every leaf equal bit for bit; (d) the restored
   weights served: ``ServeSession``'s greedy tokens and a token stream at
   ``seg0_d7``, 8 bits, bitpack (its K1 and K2 launches counted as the
   ``train_serve`` path, the counters set to 0 just before and read just
   after) equal to the trained weights' in memory; (e) one more train
   step under ``torch.profiler``: device kernels, device time, busy share;
   (f) train_4k's sequence length: ``chunked_attention``'s gradients at
   ``LONG_ATTN`` (bfloat16 and float32) against ``full_attention``'s
   autograd ones within ``LONG_ATTN_SHARE``, with the bytes one call saves
   for its backward beside those of autograd through the forward loop;
   then ``train()`` on fresh full-width olmo-1b weights at ``LONG_BATCH``
   x ``LONG_SEQ`` tokens, remat "none", ``LONG_STEPS`` steps: finite
   losses, a peak inside the card's 80 GB, the median step after the
   warm-up and ``mfu`` on ``analytic_step_flops``; one more step under
   ``torch.profiler``, as (e).
13. The meshed cloud on the card as a mesh of one (``make_host_mesh``:
   ("data", "model") = (1, 1) over an ``nccl`` group of one): (a) the
   sharded bitpack and Huffman-codes decodes of step 3's ``stem_pool``
   boundary, one blob a sample, at 2, 4, 8 and 16 bits, byte-equal to
   each blob's own decode, one K2 launch a call (times beside the plain
   batched decode); (b) full-width ResNet-50 through
   ``FleetServer(cloud_mesh=...)`` on step 6's trace (the three codecs'
   tables, then bitpack and per-channel pinned) against the
   single-device fused tail (``fuse_cloud_tail=True``): plans and
   breakdowns equal, logits within ``FUSED_TAIL_RTOL`` of their scale, one
   K2 launch a bitpack or Huffman group and one K5 a per-channel group;
   (c) full-width granite-34b at ``MESH_LM_LAYERS`` of its 88 layers
   (weights drawn on the card), the same way at the pinned cut
   ``MESH_LM_POINT``, printing the logits' max |diff|, then both fleets
   served again to time them warm. For each worker,
   ``torch.cuda.memory_allocated`` before and after building it must grow
   by less than ``MESH_GROWTH_SHARE`` of the parameter bytes (the shards
   are views of the parameters). The counters are set to 0 just before
   each meshed serve and read just after (the ``meshed`` path). One
   tail of the granite-34b worker (``ACCT_TAIL_BATCH`` boundaries) is
   counted by ``launch/step_analysis.py``'s ``StepCounter`` for step 14.
14. The step accounting (``launch/step_analysis.py``, ``launch/dryrun.py``),
   on the card's host; no kernel launches. (a) ``aot_tail_report`` of
   full-width, full-depth granite-34b (94.5 GB of bfloat16 weights, none
   allocated) at its middle cut, ``ACCT_BATCH`` x ``ACCT_SEQ``, without a
   mesh and on step 13's mesh of one: ``torch.cuda.memory_allocated``
   grows by less than ``ACCT_GROWTH_BYTES``, the two reports agree on
   every key, and the report of step 13's 36-layer config at its cut
   counts the FLOPs the real meshed tail of step 13 counted, exactly.
   (b) Full-width olmo-1b in bfloat16 takes ``build_step``'s train step
   (forward, backward, AdamW) on the mesh of one at ``TRAIN_BATCH`` x
   ``TRAIN_SEQ``: its counted FLOPs equal the fake dry run's of the same
   step exactly and lie within ``ACCT_BAND`` of ``analytic_step_flops``,
   and its loss equals ``Model.loss_fn``'s on the same weights and batch
   within ``TRAIN_SMALL_LOSS_RTOL``; the median of ``ACCT_TIMED_STEPS``
   warm steps (host clock around ``synchronize``) and ``mfu``, the
   analytic FLOPs over that time at the bf16 dense peak, beside the card
   line. (c) ``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
   decode_32k``, and the same with ``--multi-pod``, each in a subprocess
   started at the step's start and waited for before (b)'s timed steps,
   which so run with no other work on the host: each must exit 0 and
   print its record; their seconds. (d) ``scripts/hillclimb_torch.py``
   on the first CLI's combination under each of ``ACCT_HILLCLIMB``, in
   subprocesses started with (c)'s: the baseline's record equals the
   first CLI's key for key (but the count's seconds). (e) Full-width
   xlstm-1.3b at the published pattern's first period (``ACCT_RNN_LAYERS``
   blocks, ``lllllll s``, weights drawn on the card) takes one real
   ``build_step`` train step (remat "blocks") at ``ACCT_RNN_TRAIN`` and
   one prefill at ``ACCT_RNN_PREFILL`` (batch, tokens) under the step
   counter, which run the loops over time step by step: each must count
   exactly the FLOPs of the fake step of the same geometry, whose loops
   over time roll, and give finite outputs. Started with (c)'s CLIs and
   printed as they are: the two full-depth xlstm-1.3b CLIs of
   ``ACCT_CLI_RNN``, and olmo-1b x train_4k with and without
   ``--no-unroll`` (``ACCT_UNROLL``), whose records must agree key for key
   but the count's seconds.
15. The four examples (``examples/*_torch.py``) as subprocesses on the
   card at their default sizes, side by side, each within
   ``EXAMPLE_TIMEOUT_S``: each must exit 0 with its own last check's line
   (``train_lm``'s "loss did not improve" assertion among them), and the
   quickstart and the serving example an encode and a decode kernel each
   (the codec their plans pick); their wall times.
16. Prints the card line, a ``{"kernels": [...]}`` line, then, last,
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

# The H100's figures (NVIDIA's data sheet, SXM, 700 W; config/types.py).
from repro_torch.config.types import H100, H100_HBM_BW  # noqa: E402

HBM_BYTES_PER_S = H100_HBM_BW
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
# Step 5c: (rows, slots, heads, kv heads, head dim, tail layers) of the
# olmo-1b.stream_chat cell's int8 tail KV cache.
KV8_SHAPE = (32, 2048, 16, 16, 128, 8)
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

# Recurrent LM serving (step 9): full-width zamba2-2.7b (Mamba2 + the one
# shared attention block every 6) and xlstm-1.3b (mLSTM + sLSTM), bfloat16,
# random weights from seed 0, through the same phases as step 8
# (LM_SESSION, LM_REQUESTS on LM_MAX_BATCH slots, LM_STREAM_BITS), each cut
# to 24 blocks (a prefix of its published pattern): the step is host-bound
# (3,700-4,500 kernels a decode step at full depth), and at full depth it
# took 340-495 s of the script's 1,200 on an H100 80GB HBM3 at 700 W (step
# 13 took the rest of the room). Each arch's stream cut and its split
# points: zamba2's middle point (16 of 28,
# counting each A as a point; between the A invocations at 13 and 20), the
# first, the points right before (5) and at (6) the first A, and the last;
# xlstm after block 16 of 24 (point 15, an sLSTM block).
RNN_ARCHS = {"zamba2-2.7b": dict(point=16, split=(0, 5, 6, 16, 27),
                                 cut=dict(num_layers=24,
                                          block_pattern="m" * 24)),
             "xlstm-1.3b": dict(point=15, split=(0, 15, 23),
                                cut=dict(num_layers=24,
                                         block_pattern="lllllllslllllll"
                                                       "sllllllls"))}
# zamba2: one 512-token prefill at batch 1 takes the chunked SSD; its
# next-token logits against the sequential scan (a 511-token prefill, then
# one decode step), as a share of the logits' scale. The SSD runs in float32
# either way, but its output is rounded to bfloat16 before each out_proj,
# and an element the two sum orders leave either side of a bfloat16
# rounding edge moves by 2^-8 of itself, through every block.
RNN_CHUNK_PROMPT, RNN_CHUNK_RTOL = 512, 5e-2
# A full-width zamba2 tail holds float32 Mamba2 states (1.3 MiB a row a
# block; 9 past the stream's cut) beside its attention KV caches (2): int8
# KV leaves the tail near 0.9 of its bfloat16 bytes (0.94 at full depth's
# 27 states and 4-5 caches), which the session's bytes-halved check (the
# reference's rule: whole tail tree, recurrent state included) refuses. So
# its streams keep the tail KV in bfloat16; xlstm's tail has no KV at all.
RNN_CLOUD_KV_BITS = {"zamba2-2.7b": 0, "xlstm-1.3b": 8}
# Reduced models in float32, card against CPU (as LM_SMALL_RTOL).
RNN_SMALL_RTOL = 1e-5
# To keep the whole script near half its time limit: the streams' batched
# tokens are held against one-slot sessions for one codec (the engine's
# for every request, greedy and sampled, in (b)); calibration runs on
# prompts of RNN_CALIB_SEQ tokens.
RNN_SOLO_CODEC = "bitpack"
RNN_CALIB_SEQ = 16

# MoE LM serving (step 10): full-width grok-1-314b and llama4, bfloat16,
# random weights from seed 0 drawn on the card, each at the depth one 80 GB
# card holds (a prefix of the published block pattern), through the phases
# of step 8. Each arch's cut (the stream's point) and its split points:
# grok after its second block (``seg0_e1``); llama4 after its dense first
# block (``seg0_d0``), so the 32 GB expert layer sits in the cloud tail.
MOE_ARCHS = {
    "grok-1-314b": dict(cut=dict(num_layers=4, block_pattern="eeee"),
                        point=1, split=(0, 1, 2)),
    "llama4-maverick-400b-a17b": dict(
        cut=dict(num_layers=3, block_pattern="ded"), point=0,
        split=(0, 1)),
}
# One prefill of two rows of MOE_DROP_PROMPT tokens (two routing groups of
# 256 a row): random tokens, and one token repeated, whose identical
# hidden rows all choose the same experts and must overflow them.
MOE_DROP_PROMPT = 512
# The int8 tail KV of a bf16 model: codes at half the bytes plus one
# float32 scale a (position, kv-head) of head_dim 128.
MOE_KV_RATIO = 0.5 + 4 / 256
# Reduced models in float32, card against CPU (as LM_SMALL_RTOL).
MOE_SMALL_RTOL = 1e-5

# Multimodal LM serving (step 11): full-width qwen2-vl-7b (family vlm: a
# stub vision prefix, M-RoPE) and seamless-m4t-large-v2 (family audio: an
# encoder over stub frames, cross attention), bfloat16, full depth, random
# weights from seed 0 drawn on the card. Both serve across the cut one-shot
# only (the reference refuses their token streams). Each arch's split
# points (the first, the middle, the last) and its middle point, where the
# plans of (b) are pinned at MM_BITS bits. ServeSession at LM_SESSION: the
# vlm prompt is 16 stub vision rows + 16 text tokens, the audio prompt 32
# tokens with 8 stub frames (make_batch).
MM_ARCHS = {"qwen2-vl-7b": dict(point=14, split=(0, 14, 27)),
            "seamless-m4t-large-v2": dict(point=12, split=(0, 12, 23))}
MM_BITS = 8
MM_REQUESTS = 4
MM_BANDWIDTHS = (1e5, 1e7)
# A served request's logits against the full forward's: 8-bit per-tensor
# codes of a boundary whose range is ~10 of its standard deviations put a
# noise of ~1e-2 of the boundary's scale on it, ~1e-2 of the logits' scale
# after the tail; bf16 adds its own rounding. The bound leaves 10x.
MM_LOGITS_SHARE = 0.1
# Calibration batch: 2 prompts of the session's length.
MM_CALIB = (2, 32)
# Reduced models in float32, card against CPU (as LM_SMALL_RTOL); the vlm's
# prompt must hold its 16 stub vision rows and some text.
MM_SMALL_RTOL = 1e-5
MM_SMALL_SEQ = {"qwen2-vl-7b": 24, "seamless-m4t-large-v2": 12}

# Training (step 12): full-width olmo-1b in bfloat16, random weights from
# seed 0 drawn on the card, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
# tokens from ShardedLoader (random tokens, so the loss falls toward
# ln(vocab) from the random weights' higher one) at TRAIN_LR with a short
# warm-up. The first step carries cuBLAS's set-up, so the median is over
# the rest. The model's analytic FLOPs of a step (analytic_step_flops), at
# the H100's bf16 dense peak (989 TFLOP/s, NVIDIA's data sheet, 700 W).
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 12
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
BF16_PEAK_FLOPS = H100.flops
# (a) reduced models in float32 (TF32 off), TRAIN_SMALL_STEPS steps on the
# card and on the CPU from the same weights and batches: each step's loss
# within TRAIN_SMALL_LOSS_RTOL of the CPU's (the products sum in other
# orders, ~1e-6); the float32 AdamW moments, which hold the gradients
# (mu their running mean, nu their squares'), within
# TRAIN_SMALL_MOMENT_RTOL of each leaf's largest magnitude (a gradient
# fault, such as half the batch or a lost scale, moves them by O(1)); and,
# coarsely, every parameter within TRAIN_SMALL_LRS times the summed
# learning rate: AdamW moves a parameter by about the learning rate a step
# whatever its gradient's size, so a gradient that rounds across zero
# moves it the other way.
TRAIN_SMALL = ("olmo-1b", "grok-1-314b")
TRAIN_SMALL_STEPS = 3
TRAIN_SMALL_LOSS_RTOL = 1e-5
TRAIN_SMALL_MOMENT_RTOL = 1e-3
TRAIN_SMALL_LRS = 2.5
# The profiled train step lists the PROFILE_TOP operators whose kernels
# took the most device time.
PROFILE_TOP = 8

# Training at train_4k's sequence length (step 12 (f)): full-width olmo-1b
# in bfloat16, remat "none", LONG_BATCH x LONG_SEQ tokens (past the 2,048
# dense threshold, so every layer's attention is the chunked one with its
# recomputing backward), LONG_STEPS steps of which the first warms up; the
# peak must stay inside the card (H100_HBM_BYTES). The one-layer check:
# chunked_attention's gradients against full_attention's autograd ones at
# LONG_ATTN (batch, seq, heads, head_dim), causal, 1,024-wide chunks,
# each gradient within LONG_ATTN_SHARE[dtype] of its largest magnitude
# (bfloat16: measured ~5e-3 on the CPU at (1, 2,048, 8, 128), one bf16
# rounding of the output and of each probability; float32 with TF32 off:
# ~1e-6), and the bytes saved_tensors_hooks packs for one call, beside
# those of autograd through the forward loop alone (the S^2 blocks).
LONG_BATCH, LONG_SEQ, LONG_STEPS = 2, 4096, 4
LONG_ATTN = (1, 4096, 16, 128)
LONG_ATTN_CHUNK = 1024
LONG_ATTN_SHARE = {"bfloat16": 2e-2, "float32": 1e-5}

# Meshed cloud (step 13): the bit widths of the sharded decodes (a); the
# granite-34b depth one 80 GB card holds with room to serve (36 of 88
# layers, 39.4 GB of bfloat16 weights), its pinned cut (after block 9: 26
# blocks and the logits in the meshed tail), its prompts and requests (2
# waves of the 4 MESH_LM_EDGES); the edges are faster than the cloud
# profile, since a token prompt costs the link next to nothing and a
# slower edge would leave every request on the cloud. A worker's shards
# are views of the parameters: building one may allocate at most this
# share of their bytes.
MESH_DECODE_BITS = (2, 4, 8, 16)
MESH_LM_ARCH = "granite-34b"
MESH_LM_LAYERS = 36
MESH_LM_POINT = 8
MESH_LM_SEQ = 32
MESH_LM_WAVES = 2
MESH_GROWTH_SHARE = 0.01
# Step 13's real meshed tail that step 14 counts: a group of this many
# boundaries.
ACCT_TAIL_BATCH = 4

# Step accounting (step 14): granite-34b's tail report at the reference
# benchmark's geometry (benchmarks/meshed_tail.py), which may allocate
# less than ACCT_GROWTH_BYTES on the card; the dense band of
# tests/test_torch_dryrun.py for the counted FLOPs of a train step against
# analytic_step_flops; warm train steps timed; the dry-run CLI calls.
ACCT_ARCH = "granite-34b"
ACCT_BATCH, ACCT_SEQ = 8, 64
ACCT_GROWTH_BYTES = 1 << 20
ACCT_BAND = (0.95, 1.05)
ACCT_TIMED_STEPS = 5
ACCT_CLI = (("--arch", "olmo-1b", "--shape", "decode_32k"),
            ("--arch", "olmo-1b", "--shape", "decode_32k", "--multi-pod"))
# (e): xlstm-1.3b's first period of blocks, its real train and prefill
# steps (batch, tokens) against the fake rolled ones; the full-depth xlstm
# CLIs and the --no-unroll pair, beside the CLIs above.
ACCT_RNN_ARCH = "xlstm-1.3b"
ACCT_RNN_LAYERS = 8
ACCT_RNN_TRAIN = (1, 128)
ACCT_RNN_PREFILL = (1, 1024)
ACCT_CLI_RNN = (("--arch", "xlstm-1.3b", "--shape", "train_4k"),
                ("--arch", "xlstm-1.3b", "--shape", "prefill_32k"))
ACCT_UNROLL = ("--arch", "olmo-1b", "--shape", "train_4k")
ACCT_CLI_TIMEOUT_S = 600
# scripts/hillclimb_torch.py on the first CLI's combination, one process a
# variant, started with the CLIs; the baseline's record must equal the
# first CLI's (``--out``) but for the count's seconds.
ACCT_HILLCLIMB = ("baseline", "tp_weights")

# The examples (step 15): each ``examples/<name>_torch.py`` at its default
# size on the card, the four side by side, each within EXAMPLE_TIMEOUT_S,
# must print its last check's line. The two JALAD examples print the
# kernels they launched: an encode (K1, K3 or K4, by the codec its plans
# pick) and a decode (K2 or K5) each.
EXAMPLES = {
    "quickstart": (True, "decoupled inference: sent"),
    "edge_cloud_serving": (True, "adaptation events:"),
    "multiarch_decoupling": (False, "JALAD's cut+compress applies"),
    "train_lm": (False, "OK: loss improved"),
}
EXAMPLE_TIMEOUT_S = 300
ENCODE_KERNELS = ("fused_encode", "huffman_pack", "pc_encode")
DECODE_KERNELS = ("fused_decode", "pc_decode")

KERNELS = ("fused_encode", "fused_decode", "huffman_pack", "pc_encode",
           "pc_decode")
K6_KERNELS = ("minmax_blocks", "quantize_blocks", "pack4_blocks")
# Channel removal (step 5b): REINFORCE steps of the policy (each one tail
# forward of the served request on the card) and the width it compresses at.
CR_STEPS = 300
CR_BITS = 4


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


def device_ms(torch, fn, flush, reps: int = 15, clean=None) -> float:
    """Median CUDA-event time of ``fn`` with a cold L2 and the launches
    queued behind a spin, so host overhead between launches is hidden.
    The L2 is flushed by zeroing ``flush``, which leaves it full of dirty
    lines that the timed call's misses write back; with ``clean`` (a
    second buffer larger than the L2) it is read after the zeroing, so the
    timed call finds clean lines."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        flush.zero_()
        if clean is not None:
            clean.amax()
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


def served_boundary(torch, base, params):
    """The ``K6_POINT`` boundary of one served request (batch 4) on the
    card, and the point's index."""
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.models.api import batch_to

    point = base.model.decoupling_points().index(K6_POINT)
    cfg = base.model.cfg
    batch = ImageStream(cfg.num_classes, 4, cfg.image_size,
                        seed=300).batches(1)[0]
    with torch.no_grad():
        served = base.model.run_head(params, batch_to(batch, "cuda"),
                                     point).contiguous()
    return served, point


def check_threelaunch_kernels(torch, results, base, params):
    """Step 5: K6a, K6b, K6c against their plain versions, K6a's range by
    bits against ``ordered_aminmax``, the chain against K1 and its device
    operations a call, then the chain's own path on a served boundary."""
    from repro_torch.core.quantization import ordered_aminmax
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    served, _ = served_boundary(torch, base, params)

    def both(x):
        return x, x.to(torch.bfloat16)

    inputs = {label: both(torch.relu(torch.randn(shape, device=dev,
                                                 generator=gen)))
              for label, shape in SHAPES.items()}
    inputs[K6_POINT] = both(served)
    # Signed zeros: the stem with -0.0 among its +0.0 minima, and zeros
    # only, one sign at element 7 and the other everywhere else (range
    # (-0.0, +0.0), every code 0). The odd shape one element off every
    # 16-byte boundary (scalar head and tail, codes stored one by one).
    signed = inputs["stem"][0].clone()
    signed.view(-1)[::1001] = -0.0
    inputs["stem -0"] = both(signed)
    zeros = torch.zeros(SHAPES["stem"], device=dev)
    zeros.view(-1)[7] = -0.0
    inputs["zeros -0 at 7"] = both(zeros)
    inputs["zeros +0 at 7"] = both(-zeros)
    off = torch.relu(torch.randn(math.prod(SHAPES["odd"]) + 1, device=dev,
                                 generator=gen))
    inputs["odd off"] = (off[1:], off.to(torch.bfloat16)[1:])
    rows = []
    worst = dict.fromkeys(K6_KERNELS, 0.0)
    for label, pair in inputs.items():
        for x in pair:
            n = x.numel()
            timed = x.dtype == torch.float32 and label in SHAPES
            esize = x.element_size()
            mn, mx = qops.minmax_blocks(x)
            rmn, rmx = qref.minmax_blocks_ref(x)
            amn, amx = ordered_aminmax(x.float())
            worst["minmax_blocks"] = max(
                worst["minmax_blocks"], float((mn - rmn).abs()),
                float((mx - rmx).abs()))
            check(same_bits(mn, rmn) and same_bits(mx, rmx)
                  and same_bits(mn, amn) and same_bits(mx, amx),
                  f"K6a range {label} {x.dtype}: ({float(mn)!r}, "
                  f"{float(mx)!r}) against ({float(amn)!r}, {float(amx)!r})")
            if timed:
                rows.append(dict(
                    kernel="minmax_blocks", shape=label, bits=None,
                    ms=device_ms(torch, lambda: qops.minmax_blocks(x),
                                 flush),
                    plain_ms=device_ms(torch, lambda: qref.minmax_blocks_ref(
                        x), flush, reps=7),
                    bound_ms=bound_ms(esize * n + 8),
                    library_ms=device_ms(torch, lambda: torch.aminmax(x),
                                         flush)))
                r = rows[-1]
                print(f"  {label:5s}          minmax_blocks {r['ms']:.4f} ms "
                      f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}"
                      f", aminmax {r['library_ms']:.4f})")
            for bits in K6_BITS:
                codes = qops.quantize_blocks(x, mn, mx, bits)
                want = qref.quantize_blocks_ref(x, mn, mx, bits)
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
                        x, mn, mx, bits), flush),
                    plain_ms=device_ms(torch, lambda: qref.quantize_blocks_ref(
                        x, mn, mx, bits), flush, reps=7),
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

    def row(kernel, bits):
        return next(r for r in rows if r["kernel"] == kernel
                    and r["shape"] == "stem" and r["bits"] == bits)

    # K6c's byte-wise branch: the served boundary's 4-bit codes in a buffer
    # 1 to 15 bytes off a 16-byte boundary.
    codes = qops.quantize_blocks(served, *qops.minmax_blocks(served), 4)
    n = codes.numel()
    buf = torch.empty(n + 16, dtype=torch.uint8, device=dev)
    for off in range(1, 16):
        view = buf[off:off + n]
        view.copy_(codes)
        packed = qops.pack4_blocks(view)
        check(torch.equal(packed, qref.pack4_blocks_ref(codes)),
              f"K6c bytes {K6_POINT} codes {off} bytes off 16")
    # Warm device time and device operations a call at the stem boundary,
    # 8 bits (K6c at 4): one kernel each and no memset; the chain runs its
    # kernels and nothing else (at most one memset would be allowed).
    x = inputs["stem"][0]
    mn, mx = qops.minmax_blocks(x)
    codes4 = qops.quantize_blocks(x, mn, mx, 4)
    profile_rows(torch, [row("minmax_blocks", None),
                         row("quantize_blocks", 8), row("pack4_blocks", 4)],
                 {"minmax_blocks": lambda: qops.minmax_blocks(x),
                  "quantize_blocks": lambda: qops.quantize_blocks(
                      x, mn, mx, 8),
                  "pack4_blocks": lambda: qops.pack4_blocks(codes4)},
                 one_kernel=K6_KERNELS)
    for bits in (8, 4):
        r = row("threelaunch_chain", bits)
        r["profiled_ms"], ops = profiled_ms(
            torch, lambda: qops.quantize_pack_threelaunch(x, bits))
        r["device_kernels"] = ops
        kernels = [v for k, v in ops.items() if not k.startswith("Memset")]
        sets = sum(v for k, v in ops.items() if k.startswith("Memset"))
        want = 3 if bits <= 4 else 2
        print(f"  chain {bits} bits: {r['ms']:.4f} ms cold (K1 "
              f"{r['fused_encode_ms']:.4f}), warm {r['profiled_ms']} ms; "
              f"device operations a call: {ops}")
        check(kernels == [1] * want and sets <= 1,
              f"K6 chain at {bits} bits: {ops} device operations a call, "
              f"not {want} kernels and at most one memset")
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


def kv8_lengths(rows: int):
    """Valid slots of the stream cell's rows: ``bench/traffic/
    closed_chat.py``'s grid of 32 prompts (128-1,792 tokens) with each row
    halfway through one of its 32 outputs (32-256 tokens)."""
    import numpy as np

    from bench.traffic.closed_chat import log_uniform_grid

    prompts = log_uniform_grid(128, 1792, 32)
    outputs = log_uniform_grid(32, 256, 32)
    return np.resize(prompts + outputs[::-1] // 2, rows)


def check_kv8_kernels(torch, results):
    """Step 5c: K7a (append) and K7b (attend), ``kv8_decode``, at the
    stream cell's shapes (32 rows, 2,048 slots, 16 kv heads of 128, bf16;
    ``kv8_lengths``) against the plain composition on the card: codes and
    scales bit for bit, the output's error against float64 attention over
    the cache's exact values beside the plain version's. Times: one
    layer's call cold (L2 flushed), eight layers' calls back to back on
    eight caches (the tail's 8 layers of a step), each kernel warm, the
    plain composition cold; the bound is the valid slots' codes and
    scales, K and V, plus the rows in and out, at 3.35 TB/s."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.counters import count_launches

    b, s_c, h, kv, hd, layers = KV8_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def cache():
        return {"k": torch.randint(-127, 128, (b, s_c, kv, hd), generator=gen,
                                   device=dev, dtype=torch.int8),
                "v": torch.randint(-127, 128, (b, s_c, kv, hd), generator=gen,
                                   device=dev, dtype=torch.int8),
                "ks": torch.rand((b, s_c, kv), generator=gen, device=dev)
                * 0.05 + 1e-3,
                "vs": torch.rand((b, s_c, kv), generator=gen, device=dev)
                * 0.05 + 1e-3}

    caches = [cache() for _ in range(layers)]
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k_new = torch.randn((b, 1, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16) * 3
    v_new = torch.randn((b, 1, kv, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    lens = kv8_lengths(b)
    pos = torch.as_tensor(lens - 1, device=dev)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    args = (q, k_new, v_new)

    plain_cache = {k: t.clone() for k, t in caches[0].items()}
    kern_cache = {k: t.clone() for k, t in caches[0].items()}
    want = aops.kv8_decode_plain(*args, plain_cache, pos, live)
    with count_launches() as box:
        got = aops.kv8_decode(*args, kern_cache, pos, live)
    torch.cuda.synchronize()
    check({k: v for k, v in box.counts.items() if v}
          == {"kv8_append": 1, "kv8_attend": 1},
          f"kv8_decode launches {box.counts}")
    for key in ("k", "v"):
        check(torch.equal(kern_cache[key], plain_cache[key]),
              f"K7a {key} codes differ from the plain version's")
    for key in ("ks", "vs"):
        check(same_bits(kern_cache[key], plain_cache[key]),
              f"K7a {key} scales differ from the plain version's")
    kd = plain_cache["k"].double() * plain_cache["ks"].double()[..., None]
    vd = plain_cache["v"].double() * plain_cache["vs"].double()[..., None]
    sc = torch.einsum("bhk,bshk->bhs", q.double()[:, 0], kd) * hd ** -0.5
    valid = (torch.arange(s_c, device=dev)[None]
             < torch.clamp(pos + 1, max=s_c)[:, None])
    sc = torch.where(valid[:, None], sc, -math.inf)
    exact = torch.einsum("bhs,bshk->bhk", torch.softmax(sc, -1), vd)[:, None]
    scale = float(exact.abs().max())
    err = float((got.double() - exact).abs().max()) / scale
    plain_err = float((want.double() - exact).abs().max()) / scale
    check(err <= 2 ** -8 and err <= plain_err + 2 ** -9,
          f"K7b output error {err:.3e} (plain {plain_err:.3e})")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    one_ms = device_ms(torch, lambda: aops.kv8_decode(
        *args, caches[0], pos, live), flush)

    def eight():
        for c in caches:
            aops.kv8_decode(*args, c, pos, live)

    eight_ms = device_ms(torch, eight, flush)
    plain_ms = device_ms(torch, lambda: aops.kv8_decode_plain(
        *args, caches[1], pos, live), flush, reps=5)
    eight()
    torch.cuda.synchronize()
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(reps):
            aops.kv8_decode(*args, caches[0], pos, live)
        torch.cuda.synchronize()
        time.sleep(0.01)
    count, own_us = Counter(), Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count[e.name] += 1
            own_us[e.name] += e.self_device_time_total
    warm = {k: own_us[n] / 1e3 / count[n] * round(count[n] / reps)
            for n in count for k in ("kv8_append_kernel", "kv8_split_kernel",
                                     "kv8_combine_kernel") if k in n}

    slots = int(torch.clamp(pos + 1, max=s_c).sum())
    attend_bytes = (2 * slots * kv * (hd + 4)
                    + 2 * q.numel() * q.element_size())
    append_bytes = 2 * (k_new.numel() * 2 + b * kv * (hd + 4))
    out = dict(shape=dict(rows=b, slots=s_c, heads=h, kv_heads=kv,
                          head_dim=hd, dtype="bfloat16", layers=layers),
               mean_valid_slots=slots / b, err=err, plain_err=plain_err,
               ms=one_ms, eight_layers_ms=eight_ms, plain_ms=plain_ms,
               warm_ms=warm, device_kernels=dict(count),
               bound_ms=bound_ms(attend_bytes + append_bytes),
               append_bound_ms=bound_ms(append_bytes),
               attend_bound_ms=bound_ms(attend_bytes),
               eight_layers_bound_ms=layers * bound_ms(attend_bytes
                                                      + append_bytes))
    out["bound_share_eight"] = out["eight_layers_bound_ms"] / eight_ms
    results["kv8"] = out
    print(f"  K7a/K7b at {b} rows x {s_c} slots x {kv} x {hd} bf16, "
          f"{slots / b:.1f} valid slots a row: codes and scales == plain; "
          f"output error {err:.3e} of its scale (plain {plain_err:.3e}); "
          f"a layer {one_ms:.4f} ms cold (bound {out['bound_ms']:.4f}), 8 "
          f"layers {eight_ms:.4f} ms (bound "
          f"{out['eight_layers_bound_ms']:.4f}, "
          f"{out['bound_share_eight']:.1%}); plain {plain_ms:.3f} ms a "
          f"layer; warm {warm}")
    return out


def check_channel_removal(torch, results, base, params):
    """Step 5b: the paper's channel removal on a served boundary, trained
    on the card, and the masked boundary compressed through K3."""
    import numpy as np
    from repro_torch.codec import get_codec
    from repro_torch.config import JaladConfig
    from repro_torch.core import channel_removal as cr
    from repro_torch.core import compression as comp
    from repro_torch.core import entropy as ent
    from repro_torch.kernels.quantize import ops as qops

    served, point = served_boundary(torch, base, params)
    channels = served.shape[1]
    budget = JaladConfig().channel_removal_budget
    qops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        top1 = base.model.run_tail(params, served, point).argmax(-1)

        def evaluate(mask):
            masked = cr.apply_channel_mask(served, mask, axis=1)
            logits = base.model.run_tail(params, masked, point)
            return float((logits.argmax(-1) != top1).float().mean())

        policy = cr.train_channel_policy(
            cr.ChannelRemovalPolicy(channels, removal_budget=budget),
            evaluate, steps=CR_STEPS)
        train_s = time.perf_counter() - t0
        mask = policy.deterministic_mask()
        disagreement = evaluate(mask)
    masked = cr.apply_channel_mask(served, mask, axis=1)
    full = comp.compress(served, CR_BITS)
    packed = comp.compress(masked, CR_BITS)
    sizes = (comp.transfer_size_bytes(served, CR_BITS),
             comp.transfer_size_bytes(masked, CR_BITS))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = qops.launch_counts()
    kept = np.flatnonzero(mask).tolist()
    print(f"  policy: {CR_STEPS} steps in {train_s:.2f} s, budget {budget}, "
          f"kept {len(kept)} of {channels} channels, dropped "
          f"{np.flatnonzero(~mask).tolist()}; top-1 disagreement "
          f"{disagreement}")
    print(f"  {CR_BITS} bits: unmasked {full.nbytes} B (transfer "
          f"{sizes[0]}), masked {packed.nbytes} B (transfer {sizes[1]}); "
          f"phase {wall_s:.2f} s on {card_line()}")
    print(f"channel removal path launches: {counts}")
    check(counts["huffman_pack"] == 2 and counts["huffman_host_route"] == 0,
          f"compress did not launch K3 once a call: {counts}")
    check(len(kept) >= channels - int(budget * channels),
          f"the mask drops more than the budget: {len(kept)} kept")
    # Against the plain runs: the CPU's mask, the codec's blob, the CPU's
    # compress and sizes, the host decode.
    host = served.cpu()
    check(same_bits(masked.cpu(), cr.apply_channel_mask(host, mask, axis=1)),
          "apply_channel_mask on the card differs from its CPU run")
    blob = get_codec("huffman").encode(masked, CR_BITS)
    cpu = comp.compress(masked.cpu(), CR_BITS)
    check(packed.payload == blob.payload == cpu.payload,
          "compress's payload is not the Huffman codec's / the CPU run's")
    check(np.float32(packed.x_min).tobytes() == blob.x_min.tobytes()
          and np.float32(packed.x_max).tobytes() == blob.x_max.tobytes(),
          "compress's range is not the Huffman codec's")
    x = masked.cpu().numpy()
    back = comp.decompress(packed)
    step = (packed.x_max - packed.x_min) / ((1 << CR_BITS) - 1)
    tol = step / 2 + 8 * float(np.spacing(np.float32(
        max(abs(packed.x_min), abs(packed.x_max)))))
    err = float(np.abs(back - x).max())
    check(back.shape == x.shape and err <= tol,
          f"decompress error {err} above half a step ({tol})")
    exact = ent.huffman_size_bytes(comp.decompress_codes(packed),
                                   1 << CR_BITS) + 9
    check(sizes[1] == exact == comp.transfer_size_bytes(masked.cpu(),
                                                        CR_BITS)
          and abs(sizes[1] - packed.nbytes) <= 64,
          f"transfer_size_bytes {sizes[1]}: exact {exact}, nbytes "
          f"{packed.nbytes}")
    results["channel_removal"] = dict(
        point=K6_POINT, shape=list(served.shape), bits=CR_BITS,
        steps=CR_STEPS, budget=budget, kept=kept,
        disagreement=disagreement, unmasked_nbytes=full.nbytes,
        masked_nbytes=packed.nbytes, unmasked_transfer=sizes[0],
        masked_transfer=sizes[1], decompress_err=err, half_step=tol,
        train_s=train_s, wall_s=wall_s, launches=counts)
    return counts


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


def submit_all(sess, reqs, temperature: float = LM_TEMPERATURE):
    """Submit ``reqs``, ``(uid, (prompt, max_new_tokens, arrival))``, to
    an engine or a session; returns it."""
    from repro_torch.serving.scheduler import GenRequest

    for i, (prompt, n_new, arrival) in reqs:
        sess.submit(GenRequest(uid=i, tokens=prompt, max_new_tokens=n_new,
                               temperature=temperature, arrival=arrival))
    return sess


def lm_run(engine, reqs, solo: bool = False,
           temperature: float = 0.0) -> dict:
    """Serve ``reqs`` through ``engine`` (arrivals dropped when ``solo``);
    the tokens of each request by uid."""
    if solo:
        reqs = [(i, (prompt, new, 0)) for i, (prompt, new, _) in reqs]
    submit_all(engine, reqs, temperature)
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
    submit_all(sess, reqs, temperature)
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


def sync_clock(torch) -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def lm_split_equal(torch, model, params, tb, s, new, points) -> None:
    """Split (``prefill_head`` / ``prefill_tail``, ``decode_head`` /
    ``decode_tail``) against unsplit, bit for bit, at each point: the
    prompt's logits and one decode step's."""
    names = model.decoupling_points()
    with torch.no_grad():
        ref_logits, ref_caches = model.prefill(params, tb, s + new)
        nxt = ref_logits[:, -1].argmax(-1)[:, None]
        ref_step, _ = model.decode_step(params, nxt, s, ref_caches)
        for point in points:
            boundary, head = model.prefill_head(params, tb, s + new, point)
            logits, tail = model.prefill_tail(params, boundary, s + new,
                                              point)
            check(torch.equal(logits, ref_logits),
                  f"split prefill at {names[point]} != unsplit")
            bnd, _ = model.decode_head(params, nxt, s, head, point, s + new)
            step, _ = model.decode_tail(params, bnd, s, tail, point, s + new)
            check(torch.equal(step, ref_step),
                  f"split decode at {names[point]} != unsplit")


def lm_session_phase(torch, model, params, points, what: str):
    """(a) of steps 8-10: ``ServeSession`` at LM_SESSION (prefill,
    median of 3, and greedy tokens), split against unsplit bitwise at
    ``points``. Returns (session dict, the batch, the prefill's caches)."""
    from repro_torch.config import ServeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import batch_to
    from repro_torch.serving.engine import ServeSession

    cfg, names = model.cfg, model.decoupling_points()
    b, s, new = LM_SESSION
    batch = make_batch(cfg, b, s, seed=0)
    tb = batch_to(batch, torch.device("cuda"))
    with torch.no_grad():
        prefill_ms = []
        for _ in range(3):
            t1 = sync_clock(torch)
            logits, caches = model.prefill(params, tb, s + new)
            prefill_ms.append((sync_clock(torch) - t1) * 1e3)
    check(tuple(logits.shape) == (b, s, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{what} prefill logits")
    lm_split_equal(torch, model, params, tb, s, new, points)
    t1 = sync_clock(torch)
    toks = ServeSession(model, params, ServeConfig(
        max_batch=b, max_seq_len=s + new)).generate(batch, new)
    gen_ms = (sync_clock(torch) - t1) * 1e3
    check(toks.shape == (b, new), f"{what} ServeSession tokens {toks.shape}")
    pre = statistics.median(prefill_ms)
    session = dict(batch=b, prompt=s, tokens=new, prefill_ms=pre,
                   generate_ms=gen_ms, per_token_ms=(gen_ms - pre) / (new - 1),
                   split_points=[names[p] for p in points])
    print(f"  (a) ServeSession batch {b}, prompt {s}, {new} greedy tokens "
          f"in {gen_ms:.1f} ms (prefill {pre:.2f} ms, "
          f"{session['per_token_ms']:.2f} ms a decode step); split == "
          f"unsplit bitwise at {session['split_points']}")
    return session, batch, caches


def lm_engine_phase(torch, model, params, what: str):
    """(b) of steps 8-10: LM_REQUESTS staggered requests on
    LM_MAX_BATCH slots, each request's tokens, greedy and sampled, equal
    to a one-slot engine's, and one 8-row decode's logits bitwise equal to
    each request alone. Returns (engine dict, the requests)."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving.scheduler import ContinuousBatchingEngine

    reqs = list(enumerate(lm_requests(model.cfg.vocab_size, LM_REQUESTS,
                                      seed=1)))
    esc = ServeConfig(max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ)
    eng = ContinuousBatchingEngine(model, params, esc)
    t1 = sync_clock(torch)
    batched = lm_run(eng, reqs)
    eng_ms = (sync_clock(torch) - t1) * 1e3
    solo_engine = lambda: ContinuousBatchingEngine(  # noqa: E731
        model, params, ServeConfig(max_batch=1, max_seq_len=LM_SEQ))
    lm_solo_equal(solo_engine, reqs, batched, f"{what} engine")
    # Random weights can make greedy decoding repeat a token, so the same
    # requests also sample (each from its own generator): a row that
    # rounded differently batched would draw other tokens from then on.
    sampled = lm_run(ContinuousBatchingEngine(model, params, esc), reqs,
                     temperature=LM_TEMPERATURE)
    lm_solo_equal(solo_engine, reqs, sampled, f"{what} engine, sampled",
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
    return engine, reqs


def lm_plan_phase(torch, model, params, batch, point, calib_seq: int):
    """(c) of steps 8-10, before the streams: ``build_edge_cloud_server``
    over the three codecs (calibration timed), ``decide_streaming`` at
    LM_BANDWIDTHS, and the stream kernels held against their plain
    versions on real frames at ``point``. Returns (server, a dict of
    the numbers)."""
    from repro_torch.config import JaladConfig
    from repro_torch.models.api import batch_to
    from repro_torch.serving.edge_cloud import build_edge_cloud_server

    cfg, names = model.cfg, model.decoupling_points()
    jc = JaladConfig(codec_choices=CODECS)
    t1 = sync_clock(torch)
    server, _ = build_edge_cloud_server(
        cfg, jc, calib_batches=1, calib_batch_size=2, seq_len=calib_seq,
        params=params)
    calib_s = sync_clock(torch) - t1
    print(f"  (c) build_edge_cloud_server: calibration over "
          f"{len(server.engine.tables.points)} points x "
          f"{len(jc.bits_choices)} widths x {len(CODECS)} codecs, batch 2 "
          f"x {calib_seq} tokens, in {calib_s:.1f} s")
    decisions = {}
    for bw in LM_BANDWIDTHS:
        p = server.engine.decide_streaming(bw, expected_tokens=128.0)
        decisions[str(bw)] = _plan(p)
        where = names[p.point] if p.point >= 0 else "cloud"
        print(f"  (c) decide_streaming at {bw:.0e} B/s, 128 tokens: "
              f"{where} {p.bits} bits {p.codec or '-'} (predicted "
              f"{p.predicted_latency:.4f} s)")
    s = batch["tokens"].shape[1]
    with torch.no_grad():
        prompt_b, _ = model.prefill_head(
            params, batch_to({"tokens": batch["tokens"][:1]},
                             torch.device("cuda")), s, point)
    frames = (prompt_b[0, :LM_MAX_BATCH].reshape(LM_MAX_BATCH, 1, 1, -1),
              prompt_b)
    worst, kernel_ms = check_stream_kernels(torch, frames)
    print(f"  stream-shape kernels (rows of {cfg.d_model}) == plain "
          f"versions (max diff {worst}); 8-bit times on "
          f"{kernel_ms['shape']}: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in kernel_ms.items()
              if k != "shape"))
    return server, dict(calibration_s=calib_s, decisions=decisions,
                        kernel_max_diff=worst, kernel_ms=kernel_ms)


def kv8_layers(sess) -> int:
    """Tail attention layers of ``sess`` whose KV cache is int8: each takes
    one ``kv8_append`` and one ``kv8_attend`` launch a decode step."""
    return sum(c["k"].shape[0] for c in sess._tail_caches if "ks" in c)


def lm_stream_phase(torch, make, model, point, reqs, codec, counts,
                    solo: bool):
    """(c) and (e) of steps 8-10 for one codec: ``make(max_batch)``'s
    session pinned at ``point`` serves ``reqs`` (sampled), the counters
    set to 0 around every step: one encode and one decode launch for the
    step's group plus one of each a join (added into ``counts``); with
    ``solo``, each request's tokens equal a one-slot session's; then the
    per-phase times and ``torch.profiler`` over LM_PROFILE_STEPS steps.
    Returns the stream's dict."""
    from repro_torch.kernels.quantize import ops as qops

    names = model.decoupling_points()
    sess = submit_all(make(LM_MAX_BATCH), reqs)
    steps = grouped_steps = 0
    t1 = sync_clock(torch)
    while sess.queue or sess.num_active:
        joins, groups = len(sess.events), len(sess.encode_groups)
        qops.reset_launch_counts()
        sess.step()
        got = qops.launch_counts()
        n_join = sum(1 for e in sess.events[joins:] if e[0] == "join")
        grouped = len(sess.encode_groups) - groups
        want = dict.fromkeys(got, 0)
        want[ENCODE_KERNEL[codec]] += n_join + grouped
        want[DECODE_KERNEL[codec]] += n_join + grouped
        want["kv8_append"] = want["kv8_attend"] = grouped * kv8_layers(sess)
        check(grouped <= 1 and got == want,
              f"{model.cfg.arch_id} stream {codec} step {sess.step_count}: "
              f"launches { {k: v for k, v in got.items() if v} }, expected "
              f"{ {k: v for k, v in want.items() if v} } ({n_join} joins, "
              f"{grouped} grouped encode)")
        for k, v in got.items():
            counts[k] += v
        steps += 1
        grouped_steps += grouped
    wall_ms = (sync_clock(torch) - t1) * 1e3
    toks = {r.uid: r.result.tolist() for r in sess.completed}
    if solo:
        lm_solo_equal(lambda: make(1), reqs, toks,
                      f"{model.cfg.arch_id} stream {codec}", LM_TEMPERATURE)
    timed = timed_stream_run(torch, make(LM_MAX_BATCH), reqs, LM_TEMPERATURE)
    check(timed["tokens"] == toks,
          f"{model.cfg.arch_id} stream {codec}: the timed run's tokens "
          "differ")
    med = {k: statistics.median(timed[k])
           for k in ("join", "head", "encode", "decode", "tail")}
    prof = profile_stream_steps(torch, make(LM_MAX_BATCH),
                                model.cfg.vocab_size)
    out = dict(plan=dict(point=names[point], bits=LM_STREAM_BITS),
               steps=steps, grouped_steps=grouped_steps,
               tokens=sess.tokens_out, wall_ms=wall_ms,
               tokens_per_s=sess.tokens_out / wall_ms * 1e3,
               bytes_sent=sess.bytes_sent, header_bytes=sess.header.nbytes,
               frame_bytes=statistics.mean(timed["frame_bytes"]),
               kv_bytes_ratio=sess.kv_bytes_ratio, ms=med, profile=prof,
               distinct_tokens=[len(set(v)) for _, v in sorted(toks.items())])
    kv = ("" if sess.kv_bytes_ratio is None
          else f"int8 KV {sess.kv_bytes_ratio:.4f} of bf16; ")
    print(f"  (c) {codec:10s} at {names[point]}/{LM_STREAM_BITS} bits: "
          f"{steps} steps ({grouped_steps} grouped encodes), "
          f"{sess.tokens_out} tokens in {wall_ms:.1f} ms "
          f"({out['tokens_per_s']:.1f} tokens/s); a token: head "
          f"{med['head']:.3f} ms, encode {med['encode']:.3f}, decode "
          f"{med['decode']:.3f}, tail {med['tail']:.3f}; a join "
          f"{med['join']:.2f} ms; {out['frame_bytes']:.1f} B a frame; {kv}"
          f"sampled tokens (distinct a request {out['distinct_tokens']})"
          + (" == alone" if solo else ""))
    print(f"  (e)   profiled ({LM_MAX_BATCH} active slots, "
          f"{LM_PROFILE_STEPS} steps): {prof['step_ms']:.2f} ms a step, "
          f"{prof['kernels_per_step']:.0f} device kernels a step, "
          f"{prof['device_ms_per_step']:.3f} ms of device time (busy "
          f"{prof['busy_share']:.1%}, idle {1 - prof['busy_share']:.1%})")
    return out


def lm_small_check(torch, cfg, rtol: float, seq: int = 12) -> float:
    """``cfg`` reduced, in float32, card against CPU, on ``make_batch``'s
    two prompts of ``seq``: forward logits within ``rtol`` of their scale
    and equal greedy tokens. Returns the share."""
    from repro_torch.config import ServeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import batch_to, build_model
    from repro_torch.models.bridge import params_to
    from repro_torch.serving.engine import ServeSession

    small = cfg.reduced()
    sm = build_model(small)
    cpu_p = sm.init(0, "cpu")
    card_p = params_to(cpu_p, torch.device("cuda"))
    sb = make_batch(small, 2, seq, seed=3)
    with torch.no_grad():
        lc = sm.forward(card_p, batch_to(sb, torch.device("cuda"))).cpu()
        lh = sm.forward(cpu_p, batch_to(sb, "cpu"))
    rel = float((lc - lh).abs().max() / lh.abs().max())
    check(rel <= rtol, f"reduced {cfg.arch_id} card/cpu logits {rel:.2e}")
    ssc = ServeConfig(max_batch=2, max_seq_len=seq + 12)
    tc = ServeSession(sm, card_p, ssc).generate(sb, 8)
    th = ServeSession(sm, cpu_p, ssc).generate(sb, 8)
    check((tc == th).all(), f"reduced {cfg.arch_id} card/cpu tokens")
    print(f"  reduced {cfg.arch_id} f32: card vs CPU logits {rel:.2e} of "
          f"scale (rtol {rtol}), greedy tokens equal")
    return rel


def load_lm(torch, arch: str, draw: str = "cpu", **cut):
    """Full-width ``arch`` (its depth cut by ``cut``: ``num_layers`` and
    ``block_pattern``) with random weights from seed 0 on the card, drawn
    on the CPU or (``draw="device"``) on the card; the draw's time. The
    card's peak memory counter is reset first."""
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    model = build_model(get_config(arch).replace(**cut))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, torch.device("cuda"), draw=draw)
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0


def lm_codec_streams(torch, model, params, server, point, reqs, counts,
                     solo_codecs, cloud_kv_bits: int = 8) -> dict:
    """(c)-(e) of steps 8-10: for each codec, ``lm_stream_phase`` on the
    stream pinned at ``point``, LM_STREAM_BITS bits (batched equal to solo
    for ``solo_codecs``); then every codec's encode and decode kernel must
    have launched, and no Huffman frame taken the host. Returns the
    streams by codec."""
    from repro_torch.config import ServeConfig
    from repro_torch.core.decoupler import DecoupledPlan

    streams = {}
    for codec in CODECS:
        plan = DecoupledPlan(point, LM_STREAM_BITS, 0.0, 0.0, 0.0, codec)
        runner = server.engine.make_runner(params, plan)
        streams[codec] = lm_stream_phase(
            torch, lambda n: runner.stream_session(ServeConfig(
                max_batch=n, max_seq_len=LM_SEQ),
                cloud_kv_bits=cloud_kv_bits),
            model, point, reqs, codec, counts, solo=codec in solo_codecs)
    for codec in CODECS:
        for name in (ENCODE_KERNEL[codec], DECODE_KERNEL[codec]):
            check(counts[name] > 0, f"{name} never launched on the "
                  f"{model.cfg.arch_id} stream")
    check(counts["huffman_host_route"] == 0, "a Huffman frame took the host")
    return streams


def lm_fleet_streams(torch, model, params, server, point, reqs):
    """(f) of step 8: two sessions of the requests' halves on one plan
    (``point``, LM_STREAM_BITS bits, bitpack) attached to one
    ``FleetServer``; the counters set to 0 around every ``step_streams``:
    one K1 and one K2 launch for the step's cloud group plus one of each a
    join. Each session's tokens must equal the same session run alone.
    Returns (the phase's dict, its launch counts)."""
    from repro_torch.config import ServeConfig
    from repro_torch.config.types import EDGE_TX2
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.serving.fleet import FleetServer

    plan = DecoupledPlan(point, LM_STREAM_BITS, 0.0, 0.0, 0.0, "bitpack")
    runner = server.engine.make_runner(params, plan)
    parts = (reqs[: len(reqs) // 2], reqs[len(reqs) // 2:])

    def make(part):
        return submit_all(runner.stream_session(ServeConfig(
            max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ)), part)

    fleet = FleetServer(server.engine, params, [EDGE_TX2])
    sessions = [make(part) for part in parts]
    for sess in sessions:
        fleet.attach_stream(sess)
    counts = dict.fromkeys(qops.launch_counts(), 0)
    steps = shared = 0
    t1 = sync_clock(torch)
    while any(sess.queue or sess.num_active for sess in sessions):
        joins = [len(sess.events) for sess in sessions]
        encodes = [len(sess.encode_groups) for sess in sessions]
        groups = len(fleet.cloud_groups)
        qops.reset_launch_counts()
        fleet.step_streams()
        got = qops.launch_counts()
        n_join = sum(1 for sess, j in zip(sessions, joins)
                     for e in sess.events[j:] if e[0] == "join")
        grouped = len(fleet.cloud_groups) - groups
        want = dict.fromkeys(got, 0)
        want["fused_encode"] = want["fused_decode"] = n_join + grouped
        # Each session that decoded runs its own tail decode.
        want["kv8_append"] = want["kv8_attend"] = sum(
            kv8_layers(sess) for sess, n in zip(sessions, encodes)
            if len(sess.encode_groups) > n)
        check(grouped <= 1 and got == want,
              f"fleet streams step {steps}: launches "
              f"{ {k: v for k, v in got.items() if v} }, expected "
              f"{ {k: v for k, v in want.items() if v} } ({n_join} joins, "
              f"{grouped} groups)")
        if grouped:
            uids = fleet.cloud_groups[-1].uids
            shared += all(any(u in uids for u, _ in part) for part in parts)
        for k, v in got.items():
            counts[k] += v
        steps += 1
    wall_ms = (sync_clock(torch) - t1) * 1e3
    check(fleet.run_streams() == 0, "fleet streams left work")
    check(shared > 0, "no fleet step grouped both sessions' rows")
    for sess, part in zip(sessions, parts):
        toks = {r.uid: r.result.tolist() for r in sess.completed}
        alone = make(part)
        alone.run()
        check(toks == {r.uid: r.result.tolist() for r in alone.completed},
              "a fleet stream's tokens differ from its session alone")
    n_tok = sum(sess.tokens_out for sess in sessions)
    out = dict(sessions=len(sessions), steps=steps, shared_steps=shared,
               groups=len(fleet.cloud_groups), tokens=n_tok,
               wall_ms=wall_ms, tokens_per_s=n_tok / wall_ms * 1e3)
    print(f"  (f) fleet: 2 sessions on {model.decoupling_points()[point]}/"
          f"{LM_STREAM_BITS} bits bitpack, {steps} steps ({shared} with both "
          f"sessions' rows in one group), {n_tok} tokens in {wall_ms:.1f} ms "
          f"({out['tokens_per_s']:.1f} tokens/s); one K1 and one K2 a "
          "group plus one of each a join; each session == alone")
    return out, counts


def serve_lm(torch, results):
    """Step 8: full-width olmo-1b (bfloat16, random weights from seed 0)
    through ServeSession, the continuous-batching engine, token streaming
    across the JALAD cut with each codec, and two streams batched by one
    fleet."""
    from repro_torch.kernels.quantize import ops as qops

    model, params, init_s = load_lm(torch, LM_ARCH)
    cfg = model.cfg
    print(f"LM: {cfg.arch_id} ({model.param_count():,} parameters, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}); "
          f"weights from seed 0 in {init_s:.1f} s")
    out = dict(card=card_line(), arch=cfg.arch_id,
               params=model.param_count(), init_s=init_s)
    session, batch, _ = lm_session_phase(torch, model, params,
                                         LM_SPLIT_POINTS, cfg.arch_id)
    engine, reqs = lm_engine_phase(torch, model, params, cfg.arch_id)
    server, plan_out = lm_plan_phase(torch, model, params, batch,
                                     LM_STREAM_POINT, LM_SESSION[1])
    counts = dict.fromkeys(qops.launch_counts(), 0)
    streams = lm_codec_streams(torch, model, params, server,
                               LM_STREAM_POINT, reqs, counts, CODECS)
    fleet, fleet_counts = lm_fleet_streams(torch, model, params, server,
                                           LM_STREAM_POINT, reqs)
    rel = lm_small_check(torch, cfg, LM_SMALL_RTOL)
    print(f"  lm stream launches "
          f"{({k: v for k, v in counts.items() if v})}; fleet streams "
          f"{({k: v for k, v in fleet_counts.items() if v})}")
    out.update(session=session, engine=engine, streams=streams,
               fleet_streams=fleet, launches=counts,
               fleet_launches=fleet_counts, small_rel=rel, **plan_out)
    results["lm"] = out
    return {"lm_stream": counts, "fleet_stream": fleet_counts}


def rnn_chunked_vs_sequential(torch, model, params) -> float:
    """zamba2's 512-token prefill (chunked SSD) against the sequential scan
    of the same tokens (511-token prefill + one decode step): the next-token
    logits' largest difference as a share of their scale."""
    import numpy as np

    toks = torch.as_tensor(np.random.default_rng(4).integers(
        1, model.cfg.vocab_size, size=(1, RNN_CHUNK_PROMPT)),
        dtype=torch.int64, device=torch.device("cuda"))
    n = RNN_CHUNK_PROMPT
    with torch.no_grad():
        chunked, _ = model.prefill(params, {"tokens": toks}, n + 1)
        _, caches = model.prefill(params, {"tokens": toks[:, :-1]}, n + 1)
        seq, _ = model.decode_step(params, toks[:, -1:], n - 1, caches)
    a, b = chunked[:, -1].float(), seq[:, -1].float()
    check(bool(torch.isfinite(a).all()), "chunked prefill logits")
    return float((a - b).abs().max() / b.abs().max())


def compress_state_errors(torch, caches, bits: int) -> dict:
    """``compress_state`` on full-width caches: for each leaf name, the
    largest |x - q(x)| as a share of that leaf's range (max - min); every
    share must be within half a quantization step (plus bfloat16's
    rounding of a bf16 leaf's dequantized value)."""
    from repro_torch.core.decoupler import compress_state

    with torch.no_grad():
        cq = compress_state(caches, bits)
    worst = {}
    for c, q in zip(caches, cq):
        for k, v in c.items():
            if not v.is_floating_point():
                check(torch.equal(v, q[k]), f"compress_state moved int {k}")
                continue
            vf, qf = v.float(), q[k].float()
            rng = float(vf.max() - vf.min())
            err = float((vf - qf).abs().max()) / rng if rng > 0 else 0.0
            worst[k] = max(worst.get(k, 0.0), err)
            tol = 0.5 / ((1 << bits) - 1) + (
                2.0 ** -8 * float(vf.abs().max()) / rng
                if v.dtype == torch.bfloat16 and rng > 0 else 0.0)
            check(err <= tol * (1 + 1e-3),
                  f"compress_state {k}: {err:.3e} of the range > {tol:.3e}")
    return worst


def serve_recurrent_lm(torch, results):
    """Step 9: full-width zamba2-2.7b and xlstm-1.3b (bfloat16, 24 blocks
    each, random weights from seed 0) through the phases of step 8, with
    zamba2's chunked SSD against the sequential scan and compress_state on
    the prefill's caches."""
    from repro_torch.config import ServeConfig
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.kernels.quantize import ops as qops

    counts = dict.fromkeys(qops.launch_counts(), 0)
    out_all = {}
    for arch, spec in RNN_ARCHS.items():
        model, params, init_s = load_lm(torch, arch, **spec["cut"])
        cfg, names, point = model.cfg, model.decoupling_points(), spec["point"]
        print(f"RNN: {arch} ({model.param_count():,} parameters, "
              f"{len(names)} points, pattern {cfg.block_pattern[:8]}..., "
              f"shared attention every {cfg.shared_attention_every or '-'}, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}); "
              f"weights from seed 0 in {init_s:.1f} s")
        out = dict(card=card_line(), arch=arch, params=model.param_count(),
                   init_s=init_s, point=names[point])
        session, batch, caches = lm_session_phase(torch, model, params,
                                                  spec["split"], arch)
        worst_q = compress_state_errors(torch, caches, LM_STREAM_BITS)
        del caches
        print(f"  (d) compress_state at {LM_STREAM_BITS} bits on the "
              f"prefill's caches: largest error a leaf, share of its range "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst_q.items()))
              + f" (half a step: {0.5 / 255:.2e})")
        chunk_rel = None
        if cfg.shared_attention_every:
            chunk_rel = rnn_chunked_vs_sequential(torch, model, params)
            check(chunk_rel <= RNN_CHUNK_RTOL,
                  f"{arch} chunked vs sequential {chunk_rel:.3e}")
            print(f"  (a) {RNN_CHUNK_PROMPT}-token chunked prefill vs the "
                  f"sequential scan: {chunk_rel:.2e} of the logits' scale "
                  f"(tolerance {RNN_CHUNK_RTOL})")
        session.update(chunked_vs_sequential=chunk_rel,
                       compress_state_8bit=worst_q)
        engine, reqs = lm_engine_phase(torch, model, params, arch)
        server, plan_out = lm_plan_phase(torch, model, params, batch, point,
                                         RNN_CALIB_SEQ)
        kv_bits = RNN_CLOUD_KV_BITS[arch]
        if kv_bits == 0:
            plan = DecoupledPlan(point, LM_STREAM_BITS, 0.0, 0.0, 0.0,
                                 "bitpack")
            ssc = ServeConfig(max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ)
            try:
                server.engine.make_runner(params, plan).stream_session(ssc)
            except RuntimeError as e:
                print(f"  (c) int8 cloud KV refused as expected: {e}")
            else:
                check(False, f"{arch}: int8 tail KV passed the bytes check")
        streams = lm_codec_streams(torch, model, params, server, point,
                                   reqs, counts, (RNN_SOLO_CODEC,), kv_bits)
        rel = lm_small_check(torch, cfg, RNN_SMALL_RTOL)
        out.update(session=session, engine=engine, streams=streams,
                   small_rel=rel, **plan_out)
        out_all[arch] = out
        del model, params, server
        torch.cuda.empty_cache()
    print(f"  recurrent lm stream launches "
          f"{({k: v for k, v in counts.items() if v})}")
    results["lm_recurrent"] = out_all
    return counts


def moe_drop_check(torch, model, params) -> dict:
    """(a) of step 10: one prefill of two rows of MOE_DROP_PROMPT tokens
    (random tokens; one token repeated) with every MoE layer's routing
    recorded. The kept mask of each layer equals a plain recount of the
    same expert ids (each expert's first ``capacity`` choices of a group
    of 256 tokens, token-major, then choice rank; the capacity from the
    plain rule), the port's drop count equals the recount's, and the
    repeated-token row drops. Returns the drops a row and the prefill's
    time."""
    import numpy as np

    from repro_torch.models.layers import moe as moe_lib

    cfg, n = model.cfg, MOE_DROP_PROMPT
    e, k = cfg.num_experts, cfg.experts_per_token
    rng = np.random.default_rng(5)
    toks = np.stack([rng.integers(1, cfg.vocab_size, size=n),
                     np.full(n, 7)])
    tb = {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                    device=torch.device("cuda"))}
    with torch.no_grad(), moe_lib.record_routing() as seen:
        t1 = sync_clock(torch)
        logits = model.forward(params, tb)
        ms = (sync_clock(torch) - t1) * 1e3
    check(tuple(logits.shape) == (2, n, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "drop prefill logits")
    group = 256
    cap = max(int(group * k * 1.25 / e), min(4, group * k))
    cap = -(-cap // 8) * 8
    per_row, port = [0, 0], 0
    check(len(seen) == cfg.block_pattern.count("e"),
          f"{len(seen)} routings recorded")
    for layer, r in enumerate(seen):
        check(r.capacity == cap, f"layer {layer}: capacity {r.capacity} "
              f"!= {cap}")
        ids, kept = r.ids.cpu().numpy(), r.kept.cpu().numpy()
        want = np.zeros_like(kept)
        for b in range(2):
            for g0 in range(0, n, group):
                used = np.zeros(e, np.int64)
                for t in range(g0, g0 + group):
                    for j in range(k):
                        want[b, t, j] = used[ids[b, t, j]] < cap
                        used[ids[b, t, j]] += 1
            per_row[b] += int((~want[b]).sum())
        check(np.array_equal(kept, want),
              f"layer {layer}: kept mask != the plain recount")
        port += moe_lib.dropped_choices(r)
    check(port == sum(per_row), f"drops {port} != recount {per_row}")
    check(per_row[1] > 0, "the repeated-token row dropped no choice")
    return dict(prompt=n, capacity=cap, dropped=per_row,
                choices_a_row=n * k * len(seen), prefill_ms=ms)


def serve_moe_lm(torch, results):
    """Step 10: full-width grok-1-314b and llama4-maverick-400b-a17b at
    the depths of MOE_ARCHS (bfloat16, random weights from seed 0 drawn
    on the card) through the phases of step 8, with a 512-token prefill
    that drops choices and the int8 tail KV's bytes ratio."""
    import gc

    from repro_torch.kernels.quantize import ops as qops

    counts = dict.fromkeys(qops.launch_counts(), 0)
    out_all = {}
    for arch, spec in MOE_ARCHS.items():
        model, params, init_s = load_lm(torch, arch, "device", **spec["cut"])
        cfg, names, point = model.cfg, model.decoupling_points(), spec["point"]
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        print(f"MoE: {arch} at {cfg.block_pattern} ({model.param_count():,} "
              f"parameters, {nbytes / 1e9:.2f} GB; d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
              f"{cfg.num_experts} experts top-{cfg.experts_per_token}, "
              f"expert FFN {cfg.moe_d_ff_}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype}); weights from seed 0 drawn on the card in "
              f"{init_s:.2f} s (peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
        out = dict(card=card_line(), arch=arch, pattern=cfg.block_pattern,
                   params=model.param_count(), weight_bytes=nbytes,
                   init_s=init_s, point=names[point])
        session, batch, caches = lm_session_phase(torch, model, params,
                                                  spec["split"], arch)
        del caches
        drops = moe_drop_check(torch, model, params)
        print(f"  (a) {drops['prompt']}-token prefill, 2 rows "
              f"({drops['prefill_ms']:.1f} ms): capacity {drops['capacity']} "
              f"a group of 256; dropped (token, choice) pairs, random row "
              f"{drops['dropped'][0]}, repeated-token row "
              f"{drops['dropped'][1]} of {drops['choices_a_row']} a row "
              f"(== a plain recount of the same routing)")
        session["drops"] = drops
        engine, reqs = lm_engine_phase(torch, model, params, arch)
        server, plan_out = lm_plan_phase(torch, model, params, batch, point,
                                         LM_SESSION[1])
        streams = lm_codec_streams(torch, model, params, server, point,
                                   reqs, counts, (RNN_SOLO_CODEC,))
        for codec, st in streams.items():
            check(st["kv_bytes_ratio"] == MOE_KV_RATIO,
                  f"{arch} {codec}: int8 tail KV {st['kv_bytes_ratio']} of "
                  f"bf16, not {MOE_KV_RATIO}")
        rel = lm_small_check(torch, cfg, MOE_SMALL_RTOL)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {arch}: peak device memory {peak / 1e9:.2f} GB "
              f"(weights {nbytes / 1e9:.2f} GB)")
        out.update(session=session, engine=engine, streams=streams,
                   small_rel=rel, peak_bytes=peak, **plan_out)
        out_all[arch] = out
        del model, params, server
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  moe lm stream launches "
          f"{({k: v for k, v in counts.items() if v})}")
    results["lm_moe"] = out_all
    return counts


class PinnedController:
    """The adaptation controller's serving surface with one plan pinned:
    ``serve_batch`` reads ``current_plan`` and feeds ``observe_transfer``."""

    def __init__(self, plan):
        self.plan = plan

    def current_plan(self, bandwidth=None):
        return self.plan

    def observe_transfer(self, nbytes, seconds):
        return None


def mm_session_phase(torch, model, params, points, what: str):
    """(a) of step 11: ``ServeSession`` at LM_SESSION (prefill, median of
    3, and greedy tokens; the decode-step time), then the one-shot split
    with the extras beside the boundary against the full forward, bit for
    bit: ``run_head`` -> ``run_tail`` at each of ``points``, and
    ``run_segment`` chaining ``run_head(0)`` to each point. Returns
    (session dict, the batch on the card, the full forward's logits)."""
    from repro_torch.config import ServeConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import batch_to
    from repro_torch.serving.engine import ServeSession

    cfg, names = model.cfg, model.decoupling_points()
    b, s, new = LM_SESSION
    batch = make_batch(cfg, b, s, seed=0)
    tb = batch_to(batch, torch.device("cuda"))
    with torch.no_grad():
        prefill_ms = []
        for _ in range(3):
            t1 = sync_clock(torch)
            logits, caches = model.prefill(params, tb, s + new)
            prefill_ms.append((sync_clock(torch) - t1) * 1e3)
        del caches
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{what} prefill logits {tuple(logits.shape)}")
        full = model.forward(params, tb)
        check(torch.equal(full, logits), f"{what} forward != prefill")
        head0, ex0 = model.run_head(params, tb, 0)
        for point in points:
            x, extras = model.run_head(params, tb, point)
            check(sorted(extras) == ["enc_out", "pos3d", "positions"],
                  f"{what} extras {sorted(extras)}")
            check(torch.equal(model.run_tail(params, x, point, extras), full),
                  f"{what} split at {names[point]} != unsplit")
            mid, ex2 = model.run_segment(params, head0, 0, point, ex0)
            check(ex2 is ex0 and torch.equal(
                model.run_tail(params, mid, point, ex2), full),
                f"{what} run_segment chain to {names[point]} != unsplit")
    t1 = sync_clock(torch)
    toks = ServeSession(model, params, ServeConfig(
        max_batch=b, max_seq_len=s + new)).generate(batch, new)
    gen_ms = (sync_clock(torch) - t1) * 1e3
    check(toks.shape == (b, new), f"{what} ServeSession tokens {toks.shape}")
    pre = statistics.median(prefill_ms)
    session = dict(batch=b, prompt=s, tokens=new,
                   prefill_ms=pre, generate_ms=gen_ms,
                   per_token_ms=(gen_ms - pre) / (new - 1),
                   distinct_tokens=[len(set(r)) for r in toks.tolist()],
                   split_points=[names[p] for p in points])
    stub = (f"{batch['vision_embeds'].shape[1]} vision rows + "
            f"{batch['tokens'].shape[1]} tokens" if "vision_embeds" in batch
            else f"{s} tokens, {batch['src_frames'].shape[1]} source frames")
    print(f"  (a) ServeSession batch {b}, prompt {stub}, {new} greedy "
          f"tokens in {gen_ms:.1f} ms (prefill {pre:.2f} ms, "
          f"{session['per_token_ms']:.2f} ms a decode step); run_head -> "
          f"run_tail with extras == forward bitwise at "
          f"{session['split_points']}, and run_segment chained from the "
          f"first point")
    return session, batch, full


def mm_serve_phase(torch, model, params, batch, full, point, counts):
    """(b) of step 11: ``build_edge_cloud_server`` over the three codecs
    (calibration timed), ``decide`` at MM_BANDWIDTHS, then for each codec
    the plan pinned at ``point``, MM_BITS bits, serving MM_REQUESTS
    requests through ``serve_batch`` with the counters set to 0 just
    before each and read just after: one encode and one decode launch a
    request (added into ``counts``). The decoded boundary equals the
    codec's plain value transform (``simulate``) bit for bit; each
    request's logits equal the tail's on those plain values, laid out as
    the decode lays them out (the per-channel decode's layout is
    channel-major, and a matrix product over other strides may round
    otherwise), bit for bit, and lie within MM_LOGITS_SHARE of the full
    forward's scale; K1-K5 equal their plain versions byte for byte on
    the real boundary. Returns a dict of the numbers."""
    from repro_torch.codec import get_codec
    from repro_torch.config import JaladConfig
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.api import batch_to
    from repro_torch.serving.edge_cloud import (
        EdgeCloudServer,
        build_edge_cloud_server,
    )

    cfg, names = model.cfg, model.decoupling_points()
    jc = JaladConfig(codec_choices=CODECS)
    t1 = sync_clock(torch)
    server, _ = build_edge_cloud_server(
        cfg, jc, calib_batches=1, calib_batch_size=MM_CALIB[0],
        seq_len=MM_CALIB[1], params=params)
    calib_s = sync_clock(torch) - t1
    engine = server.engine
    print(f"  (b) build_edge_cloud_server: calibration over "
          f"{len(engine.tables.points)} points x {len(jc.bits_choices)} "
          f"widths x {len(CODECS)} codecs, batch {MM_CALIB[0]} x "
          f"{MM_CALIB[1]}, in {calib_s:.1f} s")
    decisions = {}
    for bw in MM_BANDWIDTHS:
        p = engine.decide(bw)
        decisions[str(bw)] = _plan(p)
        where = names[p.point] if p.point >= 0 else "cloud"
        print(f"  (b) decide at {bw:.0e} B/s: {where} {p.bits} bits "
              f"{p.codec or '-'} (predicted {p.predicted_latency:.4f} s)")
    tb = batch_to(batch, torch.device("cuda"))
    with torch.no_grad():
        boundary, extras = model.run_head(params, tb, point)
    scale = float(full.float().abs().max())
    served = {}
    for codec in CODECS:
        plan = DecoupledPlan(point, MM_BITS, 0.0, 0.0, 0.0, codec)
        srv = EdgeCloudServer(engine, params,
                              controller=PinnedController(plan))
        with torch.no_grad():
            blob, _ = srv.runners.get(plan).edge_step(batch)
            dec = get_codec(codec).decode(blob, out_dtype=boundary.dtype,
                                          device=boundary.device)
            q = get_codec(codec).simulate(boundary, MM_BITS)
            check(torch.equal(dec.float().view(torch.int32),
                              q.float().view(torch.int32)),
                  f"{cfg.arch_id} {codec}: decoded boundary != the plain "
                  "value transform")
            plain = model.run_tail(params, torch.empty_like(dec).copy_(q),
                                   point, extras)
        walls, shares, sent = [], [], []
        for i in range(MM_REQUESTS):
            qops.reset_launch_counts()
            t1 = sync_clock(torch)
            logits, bd = srv.serve_batch(batch, 10e6)
            walls.append((sync_clock(torch) - t1) * 1e3)
            got = qops.launch_counts()
            want = dict.fromkeys(got, 0)
            want[ENCODE_KERNEL[codec]] += 1
            want[DECODE_KERNEL[codec]] += 1
            check(got == want,
                  f"{cfg.arch_id} {codec} request {i}: launches "
                  f"{ {k: v for k, v in got.items() if v} }")
            for k, v in got.items():
                counts[k] += v
            check(bd.plan_point == point and bd.plan_codec == codec,
                  f"{cfg.arch_id} {codec}: served plan {bd.plan_point}")
            check(torch.equal(logits, plain),
                  f"{cfg.arch_id} {codec} request {i}: logits != the tail's "
                  "on the plain values")
            share = float((logits.float() - full.float()).abs().max()) / scale
            check(share <= MM_LOGITS_SHARE,
                  f"{cfg.arch_id} {codec}: logits {share:.3e} of the "
                  f"forward's scale > {MM_LOGITS_SHARE}")
            shares.append(share)
            sent.append(bd.bytes_sent)
        served[codec] = dict(plan=dict(point=names[point], bits=MM_BITS),
                             bytes_sent=sent[0], wall_ms=walls,
                             median_ms=statistics.median(walls),
                             share_of_forward=max(shares))
        print(f"  (b) {codec:10s} at {names[point]}/{MM_BITS} bits: "
              f"{MM_REQUESTS} requests through serve_batch, one "
              f"{ENCODE_KERNEL[codec]} and one {DECODE_KERNEL[codec]} "
              f"launch each, {sent[0]} B a request ({boundary.numel() * 2} B "
              f"of bf16 boundary), median {served[codec]['median_ms']:.1f} "
              f"ms a request; logits == the tail's on the plain values, "
              f"{max(shares):.3e} of the forward's scale")
    b = boundary.shape[0]
    frames = (boundary[:, -1:].reshape(b, 1, 1, -1), boundary[None])
    worst, kernel_ms = check_stream_kernels(torch, frames)
    print(f"  (b) K1-K5 on the served boundary {tuple(boundary.shape)} "
          f"(one sample, as the codecs take it) and on its last rows == "
          f"plain versions (max diff {worst}); 8-bit times on "
          f"{kernel_ms['shape']}: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in kernel_ms.items()
              if k != "shape"))
    return dict(calibration_s=calib_s, decisions=decisions, served=served,
                kernel_max_diff=worst, kernel_ms=kernel_ms,
                boundary_shape=list(boundary.shape),
                extras_shapes={k: None if v is None else list(v.shape)
                               for k, v in extras.items()})


def mm_engine_phase(torch, model, params, what: str):
    """(c) of step 11: the vlm's engine on text prompts through
    ``lm_engine_phase`` (greedy and sampled, batched equal to solo); an
    audio model's engine is refused at its first prefill, for want of
    ``src_frames``, as the reference fails there."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving.scheduler import (
        ContinuousBatchingEngine,
        GenRequest,
    )

    if not model.cfg.is_encdec:
        return lm_engine_phase(torch, model, params, what)[0]
    eng = ContinuousBatchingEngine(model, params, ServeConfig(
        max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ))
    prompt, new, _ = lm_requests(model.cfg.vocab_size, 1, seed=1)[0]
    eng.submit(GenRequest(uid=0, tokens=prompt, max_new_tokens=new))
    try:
        eng.run()
    except ValueError as e:
        check("src_frames" in str(e), f"{what} refusal: {e}")
        print(f"  (c) engine refused as expected: {e}")
        return dict(refused=str(e))
    check(False, f"{what}: the continuous engine served an audio model")


def serve_mm_lm(torch, results):
    """Step 11: full-width qwen2-vl-7b and seamless-m4t-large-v2 at full
    depth (bfloat16, random weights from seed 0 drawn on the card) served
    across the one-shot JALAD cut: ServeSession and the split with
    extras, calibration and pinned plans through serve_batch, the engine,
    and each model reduced, card against CPU."""
    import gc

    from repro_torch.kernels.quantize import ops as qops

    counts = dict.fromkeys(qops.launch_counts(), 0)
    out_all = {}
    for arch, spec in MM_ARCHS.items():
        model, params, init_s = load_lm(torch, arch, "device")
        cfg, names, point = model.cfg, model.decoupling_points(), spec["point"]
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        extra = (f"{cfg.num_encoder_layers} encoder + " if cfg.is_encdec
                 else "M-RoPE sections "
                 f"{cfg.mrope_sections}, vision_proj, ")
        print(f"MM: {arch} ({cfg.family}; {model.param_count():,} "
              f"parameters, {nbytes / 1e9:.2f} GB; {extra}{len(names)} "
              f"decoder blocks, d_model {cfg.d_model}, {cfg.num_heads} heads "
              f"/ {cfg.num_kv_heads} KV, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}); weights from seed 0 drawn on "
              f"the card in {init_s:.2f} s")
        out = dict(card=card_line(), arch=arch, params=model.param_count(),
                   weight_bytes=nbytes, init_s=init_s, point=names[point])
        session, batch, full = mm_session_phase(torch, model, params,
                                                spec["split"], arch)
        serving = mm_serve_phase(torch, model, params, batch, full, point,
                                 counts)
        del full
        engine = mm_engine_phase(torch, model, params, arch)
        rel = lm_small_check(torch, cfg, MM_SMALL_RTOL, MM_SMALL_SEQ[arch])
        peak = torch.cuda.max_memory_allocated()
        print(f"  {arch}: peak device memory {peak / 1e9:.2f} GB "
              f"(weights {nbytes / 1e9:.2f} GB)")
        out.update(session=session, engine=engine, small_rel=rel,
                   peak_bytes=peak, **serving)
        out_all[arch] = out
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    for codec in CODECS:
        for name in (ENCODE_KERNEL[codec], DECODE_KERNEL[codec]):
            check(counts[name] > 0, f"{name} never launched on step 11")
    print(f"  multimodal serve launches "
          f"{({k: v for k, v in counts.items() if v})}")
    results["lm_multimodal"] = out_all
    return counts


def train_small_check(torch, arch: str) -> dict:
    """(a) of step 12: ``arch`` reduced, float32, TRAIN_SMALL_STEPS steps
    of ``train`` on the card and on the CPU from the same weights and
    batches; losses and parameters within the step's tolerances."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data.synthetic import ShardedLoader
    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_to
    from repro_torch.optim.adamw import cosine_lr
    from repro_torch.training.loop import train

    small = get_config(arch).reduced()
    model = build_model(small)
    cpu_p = model.init(0, "cpu")
    card_p = params_to(cpu_p, torch.device("cuda"))
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                     total_steps=TRAIN_SMALL_STEPS, log_every=0)
    runs = [train(model, tc, ShardedLoader(small, 4, 32, seed=0),
                  params=p, num_steps=TRAIN_SMALL_STEPS)
            for p in (card_p, cpu_p)]
    card, cpu = runs
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(card.losses, cpu.losses))
    lr_sum = sum(float(cosine_lr(tc, torch.tensor(s, dtype=torch.int32)))
                 for s in range(1, TRAIN_SMALL_STEPS + 1))
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        _leaves(card.params), _leaves(cpu.params)))
    moment_rel = max(
        float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for a, b in zip(_leaves((card.opt_state.mu, card.opt_state.nu)),
                        _leaves((cpu.opt_state.mu, cpu.opt_state.nu))))
    check(loss_rel <= TRAIN_SMALL_LOSS_RTOL,
          f"reduced {arch} card/cpu training losses {loss_rel:.2e}")
    check(moment_rel <= TRAIN_SMALL_MOMENT_RTOL,
          f"reduced {arch} card/cpu AdamW moments {moment_rel:.2e}")
    check(diff <= TRAIN_SMALL_LRS * lr_sum,
          f"reduced {arch} card/cpu parameters after training {diff:.2e}")
    check(all(t.device.type == "cuda" for t in _leaves(card.params)),
          f"reduced {arch} trained off the card")
    print(f"  (a) reduced {arch} f32, {TRAIN_SMALL_STEPS} steps card vs "
          f"CPU: losses {[round(v, 5) for v in card.losses]}, within "
          f"{loss_rel:.2e} (rtol {TRAIN_SMALL_LOSS_RTOL}); moments within "
          f"{moment_rel:.2e} of each leaf's scale (rtol "
          f"{TRAIN_SMALL_MOMENT_RTOL}); parameters within {diff:.2e} (bound "
          f"{TRAIN_SMALL_LRS} x the summed lr {lr_sum:.2e})")
    return dict(losses=card.losses, cpu_losses=cpu.losses,
                loss_rel=loss_rel, moment_rel=moment_rel, param_diff=diff,
                lr_sum=lr_sum)


def bits_equal(torch, a, b) -> bool:
    """Equal tensors bit for bit, whatever their float type."""
    view = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32, torch.float64: torch.int64}
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    if a.dtype in view:
        return torch.equal(a.view(view[a.dtype]), b.view(view[a.dtype]))
    return torch.equal(a, b)


def profile_train_step(torch, model, params, opt_state, tc, batch) -> dict:
    """One more train step under ``torch.profiler``: its device kernels,
    their summed device time and the busy share of its host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.loop import make_train_step

    step = make_train_step(model, tc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = step(params, opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # The device time of the kernels each operator launched itself.
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:PROFILE_TOP]
    return dict(step_ms=wall_ms, kernels=len(kernels), device_ms=busy_ms,
                busy_share=busy_ms / wall_ms,
                top=[(e.key, e.count, e.self_device_time_total / 1e3)
                     for e in top])


def serve_train(torch, results):
    """Step 12: training and checkpoints on full-width olmo-1b, then its
    restored weights served across the JALAD cut. Returns the launch
    counts of the restored weights' stream (the ``train_serve`` path)."""
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.config import ServeConfig, ShapeConfig, TrainConfig
    from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
    from repro_torch.data.synthetic import ShardedLoader, make_batch
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.models.api import batch_to
    from repro_torch.serving.engine import ServeSession
    from repro_torch.training.loop import train

    out = dict(card=card_line(), small={})
    for arch in TRAIN_SMALL:
        out["small"][arch] = train_small_check(torch, arch)

    model, params, init_s = load_lm(torch, TRAIN_ARCH, draw="device")
    cfg = model.cfg
    n_params = model.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"train: {cfg.arch_id} ({n_params:,} parameters, {cfg.dtype}, "
          f"{p_bytes / 1e9:.2f} GB), weights from seed 0 drawn on the card "
          f"in {init_s:.1f} s; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"lr {TRAIN_LR}, warm-up {TRAIN_WARMUP}")
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.reset_peak_memory_stats()
    t1 = sync_clock(torch)
    res = train(model, tc, ShardedLoader(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                         seed=0),
                params=params, num_steps=TRAIN_STEPS)
    train_s = sync_clock(torch) - t1
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    check(all(math.isfinite(v) for v in losses), f"training losses {losses}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    check(last < first, f"the loss did not fall: first three {first:.4f}, "
          f"last three {last:.4f}")
    check(all(t.device.type == "cuda" for t in _leaves(res.params)),
          "trained parameters left the card")
    step_ms = statistics.median(res.step_s[1:]) * 1e3
    flops = model.analytic_step_flops(
        ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    bound_ms = flops / BF16_PEAK_FLOPS * 1e3
    m_bytes = sum(t.numel() * t.element_size()
                  for t in _leaves(res.opt_state.mu) + _leaves(
                      res.opt_state.nu))
    out.update(arch=cfg.arch_id, params=n_params, param_bytes=p_bytes,
               moment_bytes=m_bytes, init_s=init_s, steps=TRAIN_STEPS,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
               step_ms=[v * 1e3 for v in res.step_s],
               median_step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               first_step_ms=res.step_s[0] * 1e3, train_s=train_s,
               peak_bytes=peak, flops=flops, flops_bound_ms=bound_ms,
               mfu=bound_ms / step_ms)
    print(f"  (b) train(): {TRAIN_STEPS} steps in {train_s:.1f} s; median "
          f"step {step_ms:.1f} ms (first {res.step_s[0] * 1e3:.1f}), "
          f"{out['tokens_per_s']:.0f} tokens/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first three {first:.4f}, last three "
          f"{last:.4f}); peak memory {peak / 1e9:.2f} GB (moments "
          f"{m_bytes / 1e9:.2f} GB); {flops / 1e12:.2f} TFLOP a step, "
          f"{bound_ms:.2f} ms at the bf16 peak ({out['mfu']:.1%} of it)")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        free = shutil.disk_usage(d).free
        t1 = sync_clock(torch)
        path = save_checkpoint(d, TRAIN_STEPS, res.params, res.opt_state)
        save_s = time.perf_counter() - t1
        disk = sum(f.stat().st_size for f in Path(path).iterdir())
        t1 = sync_clock(torch)
        p2, s2, step = restore_checkpoint(d, res.params, res.opt_state)
        restore_s = sync_clock(torch) - t1
    check(step == TRAIN_STEPS and int(s2.step) == TRAIN_STEPS,
          f"restored step {step}, optimizer step {int(s2.step)}")
    pairs = list(zip(_leaves(res.params) + _leaves(res.opt_state),
                     _leaves(p2) + _leaves(s2)))
    check(all(bits_equal(torch, a, b) for a, b in pairs),
          "a restored leaf differs from the trained one")
    del s2
    out.update(checkpoint=dict(disk_bytes=disk, free_bytes=free,
                               save_s=save_s, restore_s=restore_s,
                               leaves=len(pairs)))
    print(f"  (c) checkpoint: {len(pairs)} leaves, {disk / 1e9:.2f} GB on "
          f"disk ({free / 1e9:.0f} GB were free), saved in {save_s:.1f} s, "
          f"restored in {restore_s:.1f} s; every leaf equal bit for bit")

    b, s, new = LM_SESSION
    batch = make_batch(cfg, b, s, seed=0)
    sc = ServeConfig(max_batch=b, max_seq_len=s + new)
    toks = ServeSession(model, res.params, sc).generate(batch, new)
    toks2 = ServeSession(model, p2, sc).generate(batch, new)
    check(toks.shape == (b, new) and (toks == toks2).all(),
          "restored weights' greedy tokens differ from the trained ones'")
    plan = DecoupledPlan(LM_STREAM_POINT, LM_STREAM_BITS, 0.0, 0.0, 0.0,
                         "bitpack")
    reqs = list(enumerate(lm_requests(cfg.vocab_size, LM_REQUESTS, seed=1)))

    def stream(weights):
        return submit_all(DecoupledRunner(model, weights, plan).stream_session(
            ServeConfig(max_batch=LM_MAX_BATCH, max_seq_len=LM_SEQ)), reqs)

    ref = stream(res.params)
    ref.run()
    sess = stream(p2)
    qops.reset_launch_counts()
    t1 = sync_clock(torch)
    sess.run()
    wall_ms = (sync_clock(torch) - t1) * 1e3
    counts = qops.launch_counts()
    check(counts["fused_encode"] > 0 and counts["fused_decode"] > 0,
          f"the restored stream launched {counts}")
    got = {r.uid: r.result.tolist() for r in sess.completed}
    check(got == {r.uid: r.result.tolist() for r in ref.completed},
          "restored weights' stream tokens differ from the trained ones'")
    out.update(serve=dict(greedy_tokens=toks.tolist(),
                          stream_tokens=sess.tokens_out,
                          stream_wall_ms=wall_ms, launches=counts))
    print(f"  (d) restored weights: ServeSession greedy tokens == the "
          f"trained weights' ({toks[0, :8].tolist()}...); stream at "
          f"{model.decoupling_points()[LM_STREAM_POINT]}/{LM_STREAM_BITS} "
          f"bits bitpack, {sess.tokens_out} tokens in {wall_ms:.1f} ms "
          f"== the trained weights', launches "
          f"{ {k: v for k, v in counts.items() if v} }")

    tb = batch_to(make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=5),
                  torch.device("cuda"))
    prof = profile_train_step(torch, model, res.params, res.opt_state, tc,
                              tb)
    out["profile"] = prof
    print(f"  (e) one profiled train step: {prof['step_ms']:.1f} ms, "
          f"{prof['kernels']} device kernels, {prof['device_ms']:.1f} ms of "
          f"device time (busy {prof['busy_share']:.1%}); operators by the "
          "device time of their kernels:")
    for name, calls, ms in prof["top"]:
        print(f"      {ms:8.2f} ms  {name} ({calls} calls)")
    results["train"] = out
    return counts


def saved_bytes(torch, fn, *inputs) -> int:
    """Bytes of the distinct storages ``saved_tensors_hooks`` packs for
    the backward of ``fn(*inputs)``, the inputs' own left out."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*inputs)
    del out
    own = {t.untyped_storage()._cdata for t in inputs}
    return sum(n for c, n in seen.items() if c not in own)


def long_attention_check(torch) -> dict:
    """Step 12 (f)'s one-layer check (see ``LONG_ATTN``)."""
    import functools

    from repro_torch.models.layers import attention as attn

    b, s, h, hd = LONG_ATTN
    gen = torch.Generator(device="cuda").manual_seed(12)
    chunked = functools.partial(attn.chunked_attention, causal=True,
                                q_chunk=LONG_ATTN_CHUNK,
                                kv_chunk=LONG_ATTN_CHUNK)
    dense = functools.partial(attn.full_attention, causal=True)
    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        q, k, v, dout = (torch.randn(LONG_ATTN, generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(4))

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fn(*leaves).backward(dout)
            return [t.grad for t in leaves]

        got, want = grads(chunked), grads(dense)
        t0 = sync_clock(torch)
        grads(chunked)
        chunked_ms = (sync_clock(torch) - t0) * 1e3
        t0 = sync_clock(torch)
        grads(dense)
        dense_ms = (sync_clock(torch) - t0) * 1e3
        shares = [float((g.float() - w.float()).abs().max()
                        / w.float().abs().max()) for g, w in zip(got, want)]
        check(all(math.isfinite(x) and x <= LONG_ATTN_SHARE[name]
                  for x in shares),
              f"chunked attention's {name} gradients (dq, dk, dv) differ "
              f"from full_attention's by {shares} of their scale, bound "
              f"{LONG_ATTN_SHARE[name]}")
        del got, want
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        kept = saved_bytes(torch, chunked, *leaves)
        loop = saved_bytes(torch, lambda *a: attn._flash_forward(
            *a, True, 0, LONG_ATTN_CHUNK, LONG_ATTN_CHUNK)[0], *leaves)
        out[name] = dict(shares=shares, saved_bytes=kept,
                         loop_saved_bytes=loop, chunked_ms=chunked_ms,
                         dense_ms=dense_ms)
        print(f"  (f) chunked attention at {LONG_ATTN} {name}, causal, "
              f"chunks of {LONG_ATTN_CHUNK}: dq, dk, dv within "
              f"{', '.join(f'{x:.2e}' for x in shares)} of full_attention's "
              f"scale (bound {LONG_ATTN_SHARE[name]}); forward and backward "
              f"{chunked_ms:.1f} ms (dense {dense_ms:.1f} ms, second calls); "
              f"saved for the backward {kept / 1e6:.1f} MB (autograd through "
              f"the loop: {loop / 1e6:.1f} MB)")
        del q, k, v, dout, leaves
        torch.cuda.empty_cache()
    return out


def train_long(torch, results):
    """Step 12 (f): full-width olmo-1b trained at LONG_BATCH x LONG_SEQ
    tokens with remat "none", after the one-layer attention check."""
    from repro_torch.config import H100_HBM_BYTES, ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import ShardedLoader, make_batch
    from repro_torch.models.api import batch_to
    from repro_torch.training.loop import train

    out = dict(attention=long_attention_check(torch))
    model, params, init_s = load_lm(torch, TRAIN_ARCH, draw="device")
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=LONG_STEPS, log_every=0, remat="none")
    torch.cuda.reset_peak_memory_stats()
    res = train(model, tc, ShardedLoader(model.cfg, LONG_BATCH, LONG_SEQ,
                                         seed=0),
                params=params, num_steps=LONG_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in res.losses),
          f"4k-token training losses {res.losses}")
    check(peak < H100_HBM_BYTES, f"4k-token training peaked at {peak} B")
    step_ms = statistics.median(res.step_s[1:]) * 1e3
    flops = model.analytic_step_flops(
        ShapeConfig("chip_train_4k", LONG_SEQ, LONG_BATCH, "train"))
    mfu = flops / (step_ms / 1e3 * BF16_PEAK_FLOPS)
    card = card_line()
    out.update(arch=model.cfg.arch_id, batch=LONG_BATCH, seq=LONG_SEQ,
               remat="none", init_s=init_s, losses=res.losses,
               step_ms=[v * 1e3 for v in res.step_s], median_step_ms=step_ms,
               tokens_per_s=LONG_BATCH * LONG_SEQ / step_ms * 1e3,
               peak_bytes=peak, flops=flops, mfu=mfu, card=card)
    print(f"  (f) train() at {LONG_BATCH} x {LONG_SEQ} tokens, remat none: "
          f"median of {LONG_STEPS - 1} steps after a warm-up {step_ms:.1f} "
          f"ms (first {res.step_s[0] * 1e3:.1f}), "
          f"{out['tokens_per_s']:.0f} tokens/s, mfu {mfu:.4f} on "
          f"{flops / 1e12:.2f} TFLOP a step; peak memory "
          f"{peak / 1e9:.2f} GB; loss {res.losses[0]:.4f} -> "
          f"{res.losses[-1]:.4f} ({card})")
    tb = batch_to(make_batch(model.cfg, LONG_BATCH, LONG_SEQ, seed=5),
                  torch.device("cuda"))
    prof = profile_train_step(torch, model, res.params, res.opt_state, tc,
                              tb)
    out["profile"] = prof
    print(f"  (f) one profiled {LONG_BATCH} x {LONG_SEQ} step: "
          f"{prof['step_ms']:.1f} ms, {prof['kernels']} device kernels, "
          f"{prof['device_ms']:.1f} ms of device time (busy "
          f"{prof['busy_share']:.1%}); operators by the device time of "
          f"their kernels:")
    for name, calls, ms in prof["top"]:
        print(f"      {ms:8.2f} ms  {name} ({calls} calls)")
    del res, params, tb
    torch.cuda.empty_cache()
    results["train_long"] = out


def _mesh_edges():
    from repro_torch.config.types import DeviceProfile

    return [DeviceProfile("edge-gpu-a", 400e12, 1.0),
            DeviceProfile("edge-gpu-b", 200e12, 1.1),
            DeviceProfile("edge-gpu-c", 400e12, 1.2),
            DeviceProfile("edge-gpu-d", 100e12, 1.0)]


def mesh_worker_growth(torch, make, params) -> tuple:
    """``make()`` (a meshed FleetServer) and the bytes the card allocated
    while it ran, against the parameters' bytes; fails unless the growth
    is below MESH_GROWTH_SHARE of them."""
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = make()
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    check(grew < MESH_GROWTH_SHARE * nbytes,
          f"building the mesh worker allocated {grew} B for "
          f"{nbytes} B of parameters")
    return fleet, grew, nbytes


def compare_meshed(torch, done, fused, what: str) -> float:
    """The meshed fleet's requests against the fused single-device run:
    plans, timelines and breakdowns equal, logits finite and within
    FUSED_TAIL_RTOL of their scale. Returns the worst max |diff|."""
    worst = 0.0
    check([r.uid for r in done] == [r.uid for r in fused], f"{what}: order")
    for r, rf in zip(done, fused):
        check(_plan(r.plan) == _plan(rf.plan) and r.timeline == rf.timeline
              and r.breakdown == rf.breakdown,
              f"{what} request {r.uid}: plan or accounting differs")
        check(type(r.logits) is torch.Tensor and r.logits.shape ==
              rf.logits.shape and bool(torch.isfinite(r.logits).all()),
              f"{what} request {r.uid}: logits")
        diff = float((r.logits.float() - rf.logits.float()).abs().max())
        scale = float(rf.logits.float().abs().max())
        check(diff <= FUSED_TAIL_RTOL * scale,
              f"{what} request {r.uid}: off by {diff:.3e} (scale "
              f"{scale:.3e})")
        worst = max(worst, diff)
    return worst


def meshed_groups_launches(fleet, got, rows: int, what: str) -> dict:
    """One K2 launch a decoupled bitpack or Huffman group and one K5 a
    per-channel group, each group one fused meshed forward over its
    requests' ``rows`` rows each."""
    groups = [g for g in fleet.cloud_groups if g.key is not None]
    n_pc = sum(1 for g in groups if g.key[2] == "perchannel")
    worker = fleet.mesh_worker
    check(worker.fused_calls == len(groups) >= 1
          and worker.group_sizes == [rows * len(g.uids) for g in groups],
          f"{what}: {worker.fused_calls} fused meshed calls for "
          f"{len(groups)} groups")
    check(got["fused_decode"] == len(groups) - n_pc
          and got["pc_decode"] == n_pc,
          f"{what}: {got['fused_decode']} K2 and {got['pc_decode']} K5 "
          f"launches for {len(groups)} groups")
    return dict(groups=len(groups), perchannel_groups=n_pc,
                group_sizes=list(worker.group_sizes),
                k2_per_group=(got["fused_decode"] / (len(groups) - n_pc)
                              if len(groups) > n_pc else None))


def meshed_decodes(torch, base, params, mesh) -> dict:
    """(a) of step 13: the sharded decodes of the served boundary."""
    import numpy as np

    from repro_torch.codec import get_codec
    from repro_torch.core import entropy as ent
    from repro_torch.kernels.quantize import ops as qops

    served, _ = served_boundary(torch, base, params)
    xs = [served[i:i + 1] for i in range(served.shape[0])]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for codec in ("bitpack", "huffman"):
        tc = get_codec(codec)
        for bits in MESH_DECODE_BITS:
            blobs = tc.encode_batch(xs, bits)
            # Ranges already on the card: a copy from host memory would
            # wait for the timing's spin and put host time in the events.
            mn = torch.from_numpy(np.stack(
                [np.float32(b.x_min) for b in blobs])).cuda()
            mx = torch.from_numpy(np.stack(
                [np.float32(b.x_max) for b in blobs])).cuda()
            if codec == "bitpack":
                codes = torch.from_numpy(np.stack(
                    [tc._wire_codes(b) for b in blobs])).cuda()
                sharded, plain = (qops.dequantize_wire_batch_sharded,
                                  qops.dequantize_wire_batch)
            else:
                wide = np.uint8 if bits <= 8 else np.uint16
                codes = torch.from_numpy(np.stack(
                    [ent.huffman_decode(b.payload).astype(wide)
                     for b in blobs])).cuda()
                sharded, plain = (qops.dequantize_codes_batch_sharded,
                                  qops.dequantize_codes_batch)
            shape = blobs[0].shape
            qops.reset_launch_counts()
            got = sharded(codes, mn, mx, bits, shape, mesh)
            torch.cuda.synchronize()
            launches = {k: v for k, v in qops.launch_counts().items() if v}
            check(launches == {"fused_decode": 1},
                  f"sharded {codec} decode at {bits} bits: {launches}")
            local = got.to_local()
            check(tuple(got.shape) == (len(blobs),) + tuple(shape)
                  and tuple(local.shape) == tuple(got.shape),
                  f"sharded {codec} decode shape {tuple(got.shape)}")
            for i, b in enumerate(blobs):
                check(same_bits(local[i], tc.decode(b, device="cuda")),
                      f"sharded {codec} decode at {bits} bits: blob {i} "
                      "differs from its own decode")
            ms = device_ms(torch, lambda: sharded(codes, mn, mx, bits,
                                                  shape, mesh), flush)
            plain_ms = device_ms(torch, lambda: plain(codes, mn, mx, bits,
                                                      shape), flush)
            out[f"{codec}/{bits}"] = dict(ms=ms, plain_batch_ms=plain_ms,
                                          launches=launches)
            print(f"  (a) sharded {codec:7s} decode {len(blobs)} x "
                  f"{tuple(shape)} at {bits:2d} bits: byte-equal per blob, "
                  f"one K2 launch; {ms:.4f} ms (the batched decode alone "
                  f"{plain_ms:.4f} ms)")
    return out


def serve_meshed(torch, results, base, params):
    """Step 13: the meshed cloud on the card, a mesh of one."""
    import gc

    from repro_torch.config import JaladConfig
    from repro_torch.config.types import EDGE_TK1, EDGE_TX2, DeviceProfile
    from repro_torch.data.synthetic import ImageStream, make_batch
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.serving.edge_cloud import build_edge_cloud_server
    from repro_torch.serving.fleet import FleetRequest, FleetServer
    from repro_torch.serving.workloads import make_trace

    t0 = time.perf_counter()
    rank_world = init_process_group("cuda")
    mesh = make_host_mesh(device="cuda")
    check(rank_world == (0, 1) and tuple(mesh.shape) == (1, 1),
          f"mesh {tuple(mesh.shape)} over {rank_world}")
    print(f"meshed cloud: {mesh.mesh_dim_names} = {tuple(mesh.shape)} over "
          f"an nccl group of one in {time.perf_counter() - t0:.2f} s")
    report = dict(decodes=meshed_decodes(torch, base, params, mesh))
    counts = dict.fromkeys(qops.launch_counts(), 0)

    # (b) ResNet-50 on step 6's trace.
    profiles = [EDGE_TX2, EDGE_TK1, DeviceProfile("edge-mid", 1e12, 1.30),
                DeviceProfile("edge-fast", 4e12, 0.90)]
    cfg = base.model.cfg
    trace = make_trace(**FLEET_TRACE)
    batches = ImageStream(cfg.num_classes, 4, cfg.image_size,
                          seed=500).batches(trace.n_requests)

    def stream():
        return trace.requests(lambda uid, d: batches[uid])

    # The three codecs' tables (Huffman wins every group), then bitpack
    # and per-channel pinned, so K5 runs on the meshed path too.
    report["resnet50"] = {}
    for label, engine in (("all", base),
                          ("bitpack", pinned_engine(base, "bitpack")),
                          ("perchannel", pinned_engine(base, "perchannel"))):
        fleet, grew, nbytes = mesh_worker_growth(torch, lambda: FleetServer(
            engine, params, profiles, cloud_mesh=mesh), params)
        qops.reset_launch_counts()
        t1 = time.perf_counter()
        done = fleet.serve(stream())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = qops.launch_counts()
        for k, v in got.items():
            counts[k] += v
        t1 = time.perf_counter()
        fused = FleetServer(engine, params, profiles,
                            fuse_cloud_tail=True).serve(stream())
        torch.cuda.synchronize()
        fused_wall = time.perf_counter() - t1
        worst = compare_meshed(torch, done, fused, f"meshed {label}")
        groups = meshed_groups_launches(fleet, got, 4, f"meshed {label}")
        print(f"  (b) ResNet-50 fleet, {label}: {len(done)} requests, "
              f"{groups['groups']} meshed groups {groups['group_sizes']} "
              f"({groups['perchannel_groups']} per-channel), K2 launches a "
              f"bitpack/Huffman group {groups['k2_per_group']}, plans equal "
              f"to the fused tail's, logits max |diff| {worst:.3e}; worker "
              f"built with {grew} B allocated for {nbytes} B of parameters; "
              f"wall {wall * 1e3:.1f} ms (fused tail {fused_wall * 1e3:.1f} "
              f"ms); launches { {k: v for k, v in got.items() if v} }")
        report["resnet50"][label] = dict(
            requests=len(done), max_abs_diff=worst, growth_bytes=grew,
            param_bytes=nbytes, wall_s=wall, fused_wall_s=fused_wall,
            launches=got, **groups)
        del fleet, done, fused
        gc.collect()

    # (c) granite-34b at full width, cut depth, pinned cut.
    model, lm_params, init_s = load_lm(torch, MESH_LM_ARCH, "device",
                                       num_layers=MESH_LM_LAYERS)
    lcfg, names = model.cfg, model.decoupling_points()
    jc = JaladConfig(bits_choices=(8,), codec_choices=("bitpack",),
                     accuracy_drop_budget=1.0)
    t1 = sync_clock(torch)
    server, _ = build_edge_cloud_server(
        lcfg, jc, calib_batches=1, calib_batch_size=2, seq_len=MESH_LM_SEQ,
        params=lm_params, points=[MESH_LM_POINT])
    calib_s = sync_clock(torch) - t1
    edges = _mesh_edges()
    fleet, grew, nbytes = mesh_worker_growth(torch, lambda: FleetServer(
        server.engine, lm_params, edges, cloud_mesh=mesh), lm_params)
    print(f"  (c) {MESH_LM_ARCH} at {MESH_LM_LAYERS} of 88 layers "
          f"({model.param_count():,} parameters, {nbytes / 1e9:.2f} GB "
          f"{lcfg.dtype}, d_model {lcfg.d_model}) drawn on the card in "
          f"{init_s:.2f} s; calibration at {names[MESH_LM_POINT]} in "
          f"{calib_s:.2f} s; worker built with {grew} B allocated")

    def lm_stream():
        return [FleetRequest(uid=u, device_id=u % len(edges),
                             batch=make_batch(lcfg, 1, MESH_LM_SEQ, seed=u),
                             bandwidth=1e9)
                for u in range(MESH_LM_WAVES * len(edges))]

    qops.reset_launch_counts()
    t1 = time.perf_counter()
    done = fleet.serve(lm_stream())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = qops.launch_counts()
    for k, v in got.items():
        counts[k] += v
    fused_fleet = FleetServer(server.engine, lm_params, edges,
                              fuse_cloud_tail=True)
    t1 = time.perf_counter()
    fused = fused_fleet.serve(lm_stream())
    torch.cuda.synchronize()
    fused_wall = time.perf_counter() - t1
    check(all(r.plan.point == MESH_LM_POINT for r in done),
          f"{MESH_LM_ARCH}: plans {[_plan(r.plan) for r in done]}")
    worst = compare_meshed(torch, done, fused, f"meshed {MESH_LM_ARCH}")
    groups = meshed_groups_launches(fleet, got, 1, f"meshed {MESH_LM_ARCH}")
    # Both fleets again, warm: a first serve pays first calls (DTensor's
    # sharding propagation of each op signature, library handles).
    warm = {}
    for label, f in (("meshed", fleet), ("fused", fused_fleet)):
        t1 = time.perf_counter()
        f.serve(lm_stream())
        torch.cuda.synchronize()
        warm[label] = time.perf_counter() - t1
    print(f"  (c) {MESH_LM_ARCH} fleet: {len(done)} requests cut at "
          f"{names[MESH_LM_POINT]} ({done[0].plan.bits} bits "
          f"{done[0].plan.codec}), {groups['groups']} meshed groups "
          f"{groups['group_sizes']}, K2 launches a group "
          f"{groups['k2_per_group']}; logits {tuple(done[0].logits.shape)} "
          f"max |diff| against the fused tail {worst:.3e}; wall "
          f"{wall * 1e3:.1f} ms (fused tail {fused_wall * 1e3:.1f} ms), "
          f"again warm {warm['meshed'] * 1e3:.1f} ms (fused tail "
          f"{warm['fused'] * 1e3:.1f} ms)")
    tail_count = count_meshed_tail(torch, model, fleet.mesh_worker)
    print(f"  (c) one meshed tail of {ACCT_TAIL_BATCH} boundaries under "
          f"the step counter (for step 14): {tail_count['flops']:.6e} "
          f"FLOPs, {tail_count['argument_bytes']:,} argument bytes")
    report[MESH_LM_ARCH] = dict(
        tail_count=tail_count,
        layers=MESH_LM_LAYERS, point=names[MESH_LM_POINT],
        params=model.param_count(), param_bytes=nbytes, draw_s=init_s,
        calibration_s=calib_s, growth_bytes=grew, requests=len(done),
        max_abs_diff=worst, wall_s=wall, fused_wall_s=fused_wall,
        warm_wall_s=warm["meshed"], warm_fused_wall_s=warm["fused"],
        launches=got, **groups)
    del fleet, fused_fleet, done, fused, server, lm_params
    gc.collect()
    torch.cuda.empty_cache()
    # The group of one stays up: step 14 counts on the same mesh.
    print(f"meshed launches: {counts}")
    for name in ("fused_decode", "pc_decode"):
        check(counts[name] > 0, f"{name} never launched on the meshed path")
    results["meshed"] = dict(launches=counts, **report)
    return counts


def count_meshed_tail(torch, model, worker) -> dict:
    """The step counter over one tail of the meshed worker on real
    weights: ``ACCT_TAIL_BATCH`` bfloat16 boundaries batch-sharded as the
    worker places them, the worker's own tail at ``MESH_LM_POINT``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dryrun import run_counted
    from repro_torch.sharding.activation import constrain

    x = torch.randn((ACCT_TAIL_BATCH, MESH_LM_SEQ, model.cfg.d_model),
                    dtype=torch.bfloat16, device="cuda")
    x = DTensor.from_local(x, worker.mesh, worker._batch_placements(),
                           run_check=False)

    def tail(p, b, e):
        b = constrain(b, model.boundary_logical_axes(b.ndim))
        return model.run_tail(p, b, MESH_LM_POINT, e)

    with torch.no_grad():
        _, count = run_counted(tail, (worker.params, x, None))
    torch.cuda.synchronize()
    return dict(flops=count.flops, argument_bytes=count.argument_bytes,
                output_bytes=count.output_bytes, temp_bytes=count.temp_bytes,
                bytes=count.bytes_accessed, ops=count.ops,
                batch=ACCT_TAIL_BATCH, seq=MESH_LM_SEQ)


def account_steps(torch, results):
    """Step 14: the step accounting on the card's host (see the module
    docstring); no kernel launches."""
    import os

    import torch.distributed as dist

    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.dryrun import (
        build_step,
        count_fake_step,
        place_args,
        run_counted,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serving.meshed import aot_tail_report

    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    records = {"dryrun": tmp / "dryrun.jsonl"}
    records.update({v: tmp / f"hillclimb_{v}.jsonl" for v in ACCT_HILLCLIMB})
    clis, climbs = [], []

    def start(cmd, argv):
        return (argv, time.perf_counter(), subprocess.Popen(
            [sys.executable, *cmd, *argv], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    for i, argv in enumerate(ACCT_CLI):
        out_arg = ("--out", str(records["dryrun"])) if i == 0 else ()
        clis.append(start(("-m", "repro_torch.launch.dryrun"),
                          (*argv, *out_arg)))
    for argv in ACCT_CLI_RNN:
        clis.append(start(("-m", "repro_torch.launch.dryrun"), argv))
    for tag, extra in (("unroll", ()), ("no_unroll", ("--no-unroll",))):
        records[tag] = tmp / f"{tag}.jsonl"
        clis.append(start(("-m", "repro_torch.launch.dryrun"),
                          (*ACCT_UNROLL, *extra, "--out",
                           str(records[tag]))))
    for v in ACCT_HILLCLIMB:
        climbs.append(start((str(ROOT / "scripts" / "hillclimb_torch.py"),),
                            (ACCT_CLI[0][1], ACCT_CLI[0][3], v, "--out",
                             str(records[v]))))
    try:
        out = dict(card=card_line())
        mesh = make_host_mesh(device="cuda")

        # (a) granite-34b's tail report, no weights.
        model = build_model(get_config(ACCT_ARCH))
        point = len(model.decoupling_points()) // 2
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        single = aot_tail_report(model, point, batch=ACCT_BATCH,
                                 seq_len=ACCT_SEQ)
        single_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        meshed = aot_tail_report(model, point, batch=ACCT_BATCH,
                                 seq_len=ACCT_SEQ, mesh=mesh)
        meshed_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        grew = torch.cuda.memory_allocated() - before
        check(grew < ACCT_GROWTH_BYTES,
              f"{ACCT_ARCH}'s tail report allocated {grew} B on the card")
        check(single == meshed, f"tail reports differ: without a mesh "
              f"{single}, on the mesh of one {meshed}")
        cut = build_model(get_config(MESH_LM_ARCH).replace(
            num_layers=MESH_LM_LAYERS))
        real = results["meshed"][MESH_LM_ARCH]["tail_count"]
        cut_rep = aot_tail_report(cut, MESH_LM_POINT, batch=ACCT_TAIL_BATCH,
                                  seq_len=MESH_LM_SEQ, mesh=mesh)
        check(cut_rep["flops_per_device"] == real["flops"],
              f"the fake tail counts {cut_rep['flops_per_device']} FLOPs, "
              f"step 13's real tail {real['flops']}")
        out["tail"] = dict(arch=ACCT_ARCH, point=point, batch=ACCT_BATCH,
                           seq=ACCT_SEQ, report=single, single_s=single_s,
                           meshed_s=meshed_s, growth_bytes=grew,
                           cut_report=cut_rep, cut_real=real)
        print(f"  (a) {ACCT_ARCH} ({model.param_count():,} parameters) "
              f"tail report at {model.decoupling_points()[point]}, "
              f"{ACCT_BATCH} x {ACCT_SEQ}: {single}; in {single_s:.2f} s "
              f"without a mesh, {meshed_s:.2f} s on the mesh of one, every "
              f"key equal; {grew} B allocated on the card. At "
              f"{MESH_LM_LAYERS} layers, {ACCT_TAIL_BATCH} x {MESH_LM_SEQ}: "
              f"{cut_rep['flops_per_device']:.6e} FLOPs, == step 13's real "
              f"meshed tail")

        # (b) full-width olmo-1b: build_step's train step on the mesh.
        lm = build_model(get_config(TRAIN_ARCH))
        shape = ShapeConfig("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
        tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=100, remat="none")
        t1 = time.perf_counter()
        fake = count_fake_step(lm, shape, tc, mesh)
        fake_s = time.perf_counter() - t1
        step_fn, abstract, in_sh = build_step(lm, shape, tc, mesh)
        args = place_args(abstract, in_sh, mesh, "cuda")
        weights = lm.init(0, torch.device("cuda"), draw="device")
        tokens = torch.randint(0, lm.cfg.vocab_size,
                               tuple(args[2]["tokens"].shape), device="cuda",
                               dtype=torch.int32)
        with torch.no_grad():
            for dst, src in zip(_leaves(args[0]), _leaves(weights)):
                dst.to_local().copy_(src)
            for t in _leaves(args[1]):
                t.to_local().zero_()
            args[2]["tokens"].to_local().copy_(tokens)
            plain_loss = float(lm.loss_fn(weights, {"tokens": tokens}))
        del weights
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (_, _, metrics), count = run_counted(step_fn, args)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t1
        loss = metrics["loss"]
        loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                     else loss)
        check(abs(loss - plain_loss) <= TRAIN_SMALL_LOSS_RTOL * abs(
            plain_loss), f"the DTensor step's loss {loss!r}, Model.loss_fn's "
              f"on the same weights and batch {plain_loss!r}")
        check(count.flops == fake.flops,
              f"the real train step counts {count.flops} FLOPs, the fake "
              f"dry run {fake.flops}")
        analytic = lm.analytic_step_flops(shape, block_remat=False)
        ratio = count.flops / analytic
        check(ACCT_BAND[0] <= ratio <= ACCT_BAND[1],
              f"counted / analytic FLOPs {ratio:.4f} outside {ACCT_BAND}")
        from torch.distributed.tensor.experimental import implicit_replication

        out["rnn"] = count_rnn_steps(torch)
        # (c) ends before the timed steps: they run with no other work on
        # the host (the step is bound by its host dispatch).
        cli = [_finish(*c) for c in clis]
        climbed = [_finish(*c) for c in climbs]
        times = []
        for _ in range(ACCT_TIMED_STEPS):
            t1 = sync_clock(torch)
            with implicit_replication():
                step_fn(*args)
            times.append(sync_clock(torch) - t1)
        step_s = statistics.median(times)
        mfu = analytic / (step_s * H100.flops)
        card = card_line()
        out["train"] = dict(
            arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            loss=loss, plain_loss=plain_loss,
            counted_flops=count.flops, fake_flops=fake.flops,
            analytic_flops=analytic, ratio=ratio,
            counted_bytes=count.bytes_accessed, fake_bytes=fake.bytes_accessed,
            argument_bytes=count.argument_bytes, ops=count.ops,
            fake_count_s=fake_s, counted_step_s=counted_s,
            step_s=times, median_step_s=step_s, mfu=mfu, card=card)
        print(f"  (b) {TRAIN_ARCH} train step (build_step, mesh of one, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, bf16): counted "
              f"{count.flops:.6e} FLOPs == the fake dry run's (counted in "
              f"{fake_s:.1f} s), {ratio:.4f} of analytic_step_flops "
              f"{analytic:.6e}; loss {loss!r} == Model.loss_fn's "
              f"{plain_loss!r} within {TRAIN_SMALL_LOSS_RTOL}"
              f"; the counted step took {counted_s:.1f} s; "
              f"median of {ACCT_TIMED_STEPS} warm steps "
              f"{step_s * 1e3:.1f} ms, mfu {mfu:.4f} ({card})")
        del args
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        for _, _, proc in clis + climbs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for argv, rc, secs, log in cli:
        lines = [ln for ln in log.splitlines()
                 if ln.startswith(("==", "   ")) or "combinations" in ln]
        print(f"  (c) python -m repro_torch.launch.dryrun {' '.join(argv)}: "
              f"rc {rc} in {secs:.1f} s")
        for ln in lines:
            print(f"      {ln.strip()}")
        check(rc == 0, f"dryrun {' '.join(argv)} exited {rc}:\n{log[-3000:]}")
        out.setdefault("cli", []).append(dict(argv=list(argv), rc=rc,
                                              seconds=secs, record=lines))
    for argv, rc, secs, log in climbed:
        check(rc == 0, f"hillclimb_torch.py {' '.join(argv)} exited {rc}:\n"
              f"{log[-3000:]}")
    recs = {k: json.loads(p.read_text().splitlines()[-1])
            for k, p in records.items()}
    shutil.rmtree(tmp, ignore_errors=True)
    base, ref = dict(recs["baseline"]), recs["dryrun"]
    extras = tuple(base.pop(k) for k in ("variant", "remat", "microbatches"))
    check(extras == ("baseline", "blocks", 1) and list(base) == list(ref)
          and all(base[k] == ref[k] for k in ref if k != "count_s"),
          f"hillclimb's baseline record {recs['baseline']} differs from the "
          f"dry run's {ref}")
    out["hillclimb"] = dict(records=recs,
                            seconds={a[2]: secs for a, _, secs, _ in climbed})
    rolled, unrolled = recs["no_unroll"], recs["unroll"]
    check(list(rolled) == list(unrolled) and all(
        rolled[k] == unrolled[k] for k in unrolled if k != "count_s"),
        f"{' '.join(ACCT_UNROLL)} --no-unroll counts {rolled}, the default "
        f"{unrolled}")
    out["no_unroll"] = dict(record=rolled, count_s=rolled["count_s"],
                            default_count_s=unrolled["count_s"])
    print(f"  (e) {' '.join(ACCT_UNROLL)}: --no-unroll's record == the "
          f"default's, counted in {rolled['count_s']:.1f} s against "
          f"{unrolled['count_s']:.1f} s")
    for (argv, _, secs, _), v in zip(climbed, ACCT_HILLCLIMB):
        r = recs[v]
        print(f"  (d) scripts/hillclimb_torch.py {' '.join(argv[:3])}: "
              f"{secs:.1f} s; compute {r['compute_s'] * 1e3:.3f} / memory "
              f"{r['memory_s'] * 1e3:.3f} / collective "
              f"{r['collective_s'] * 1e3:.3f} ms, {r['dominant']}, "
              f"{r['argument_bytes'] / 2**30:.2f} GiB of arguments a device"
              + ("; == the dry run's record" if v == "baseline" else ""))
    results["accounting"] = out


def count_rnn_steps(torch) -> dict:
    """Step 14 (e): full-width xlstm-1.3b at its first period of blocks on
    the card, a real train step and a real prefill under the step counter
    (the loops over time run step by step) against the fake steps of the
    same geometry (their loops over time roll): FLOPs equal exactly."""
    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.dryrun import (
        build_step,
        count_fake_step,
        place_args,
        run_counted,
    )
    from repro_torch.models.api import build_model

    base = get_config(ACCT_RNN_ARCH)
    model = build_model(base.replace(
        num_layers=ACCT_RNN_LAYERS,
        block_pattern=base.block_pattern[:ACCT_RNN_LAYERS]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    weights = model.init(0, torch.device("cuda"), draw="device")
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=100, remat="blocks")
    out = dict(arch=ACCT_RNN_ARCH, pattern=model.cfg.block_pattern,
               params=model.param_count())
    for mode, (b, s) in (("train", ACCT_RNN_TRAIN),
                         ("prefill", ACCT_RNN_PREFILL)):
        shape = ShapeConfig(f"chip_{mode}", s, b, mode)
        t1 = time.perf_counter()
        fake = count_fake_step(model, shape, tc, None)
        fake_s = time.perf_counter() - t1
        step_fn, abstract, in_sh = build_step(model, shape, tc, None)
        args = place_args(abstract, in_sh, None, "cuda")
        with torch.no_grad():
            for dst, src in zip(_leaves(args[0]), _leaves(weights)):
                dst.copy_(src)
            if mode == "train":
                for t in _leaves(args[1]):
                    t.zero_()
            batch = args[-1]
            batch["tokens"].copy_(torch.randint(
                0, model.cfg.vocab_size, tuple(batch["tokens"].shape),
                device="cuda"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, count = run_counted(step_fn, args)
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t1
        value = got[2]["loss"] if mode == "train" else got[0]
        check(bool(torch.isfinite(value.float()).all()),
              f"{ACCT_RNN_ARCH} real {mode} step gave non-finite values")
        check(count.flops == fake.flops,
              f"{ACCT_RNN_ARCH} {mode} at {b} x {s}: the real step counts "
              f"{count.flops} FLOPs, the fake rolled step {fake.flops}")
        out[mode] = dict(
            batch=b, seq=s, flops=count.flops, fake_flops=fake.flops,
            bytes=count.bytes_accessed, fake_bytes=fake.bytes_accessed,
            ops=count.ops, fake_ops=fake.ops, temp_bytes=count.temp_bytes,
            fake_temp_bytes=fake.temp_bytes, real_s=real_s, fake_s=fake_s,
            value=float(value.float().mean()))
        print(f"  (e) {ACCT_RNN_ARCH} ({ACCT_RNN_LAYERS} blocks "
              f"{model.cfg.block_pattern}, {model.param_count():,} "
              f"parameters) {mode} at {b} x {s}: the real step counts "
              f"{count.flops:.6e} FLOPs == the fake rolled step's (bytes "
              f"{count.bytes_accessed:.6e} / {fake.bytes_accessed:.6e}, ops "
              f"{count.ops} / {fake.ops}, temp {count.temp_bytes} / "
              f"{fake.temp_bytes}); counted in {real_s:.1f} s real, "
              f"{fake_s:.1f} s fake")
        del args, got, step_fn
    del weights
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    print(f"  (e) peak {out['peak_gb']:.2f} GB above what was allocated "
          f"before it")
    torch.cuda.empty_cache()
    return out


def run_examples(torch, results):
    """Step 15: the four examples as subprocesses on the card, side by
    side; each must exit 0 and print its last check's line."""
    import ast
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py")],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for name in EXAMPLES}
    out = {}
    try:
        for name, (t0, proc) in procs.items():
            try:
                log, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            coded, last = EXAMPLES[name]
            check(proc.returncode == 0 and last in log,
                  f"examples/{name}_torch.py exited {proc.returncode}:\n"
                  f"{log[-3000:]}")
            launches = {}
            for ln in log.splitlines():
                if ln.startswith("kernel launches: "):
                    launches = ast.literal_eval(ln[len("kernel launches: "):])
            check(not coded or (
                any(launches.get(k) for k in ENCODE_KERNELS)
                and any(launches.get(k) for k in DECODE_KERNELS)),
                f"examples/{name}_torch.py launched {launches}, wants an "
                f"encode and a decode kernel")
            out[name] = dict(seconds=secs, launches=launches,
                             tail=log.splitlines()[-12:])
            print(f"  examples/{name}_torch.py: rc 0 in {secs:.1f} s"
                  + (f", launches {launches}" if launches else ""))
            for ln in log.splitlines()[-6:]:
                print(f"      {ln}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results["examples"] = out


def _finish(argv, start, proc):
    """(argv, exit code, seconds, output) of a dry-run CLI subprocess."""
    try:
        log, _ = proc.communicate(timeout=ACCT_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
    return argv, proc.returncode, time.perf_counter() - start, log


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
    kv8 = step("kv8 kernels", check_kv8_kernels)
    removal = step("channel removal", check_channel_removal, base, params)
    fleet = step("fleet", serve_fleet, params)
    three = step("three-tier", serve_three_tier, params)
    lm = step("lm serving", serve_lm)
    rnn = step("recurrent lm serving", serve_recurrent_lm)
    moe = step("moe lm serving", serve_moe_lm)
    mm = step("multimodal lm serving", serve_mm_lm)
    trained = step("training", serve_train)
    step("training at 4k tokens", train_long)
    meshed = step("meshed cloud", serve_meshed, base, params)
    step("step accounting", account_steps)
    step("examples", run_examples)
    paths = {"served": served, "pipeline": piped, "fleet": fleet,
             "threelaunch": k6_path, "channel_removal": removal,
             "three_tier": three, **lm,
             "rnn_stream": rnn, "moe_stream": moe, "mm_serve": mm,
             "train_serve": trained, "meshed": meshed}

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
    for name, kernel, bound in (
            ("kv8_append", "kv8_append_kernel", "append_bound_ms"),
            ("kv8_attend", "kv8_split_kernel", "attend_bound_ms")):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/kv8_attention.cu",
            "replaces": None, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": kv8["err"],
            "ms": kv8["ms"], "plain_ms": kv8["plain_ms"],
            "bound_ms": kv8[bound],
            "bound_by": "bytes", "library_ms": None,
            "warm_ms": kv8["warm_ms"].get(kernel),
            "device_kernels": kv8["device_kernels"]})
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
