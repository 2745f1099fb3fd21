"""Serving launcher of the port: batched and continuous-batching
generation for the decoders (dense, moe, ssm, hybrid, vlm and audio
families: olmo-1b, qwen3-8b, yi-6b, granite-34b, grok-1-314b,
llama4-maverick-400b-a17b, xlstm-1.3b, zamba2-2.7b, qwen2-vl-7b,
seamless-m4t-large-v2), and JALAD edge-cloud serving of the CNN testbed
(synchronous or pipelined), on the CUDA card unless ``--device cpu`` is
given. A vlm batch carries stub vision embeddings, an audio batch stub
source frames (``make_batch``); continuous batching serves a vlm's text
prompts and refuses an audio model (its requests carry no frames).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --tokens 16                       # one-shot batched generation
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --continuous --requests 6         # continuous-batching scheduler
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --reduced --continuous --device cpu   # small CPU run
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --continuous --requests 6         # Mamba2 hybrid (or xlstm-1.3b)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
      --reduced --device cpu [--continuous]   # MoE (full depth fits no
                                              # one card)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
      [--continuous]                    # vision prefix + M-RoPE
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2      # encoder + cross-attention
  PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet50 \
      --jalad --codec huffman --bandwidth 300e3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet50 \
      --jalad --pipeline --codec auto --requests 16   # overlapped stages
  PYTHONPATH=src python -m repro_torch.launch.serve --arch resnet50 \
      --reduced --jalad --device cpu       # small CPU run
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

from repro_torch.config import JaladConfig, ServeConfig, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.launch.serve")


def serve_lm(args) -> int:
    """KV-cache (and recurrent-state) generation with a decoder: one
    batched session, or the continuous-batching engine
    (``--continuous``)."""
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServeSession

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(args.seed, device)
    log.info("%s: %d parameters on %s in %.2fs", cfg.arch_id,
             model.param_count(), device, time.perf_counter() - t0)
    sc = ServeConfig(max_batch=args.batch,
                     max_seq_len=args.prompt + args.tokens, seed=args.seed)
    if args.continuous:
        return _serve_lm_continuous(args, cfg, model, params, sc)
    session = ServeSession(model, params, sc)
    batch = make_batch(cfg, args.batch, args.prompt, seed=args.seed)
    t0 = time.perf_counter()
    out = session.generate(batch, args.tokens, temperature=args.temperature,
                           seed=args.seed)
    log.info("generated %s tokens for %d requests in %.2fs", out.shape,
             args.batch, time.perf_counter() - t0)
    print(out[:, :16])
    return 0


def _serve_lm_continuous(args, cfg, model, params, sc) -> int:
    """Continuous batching: staggered arrivals, per-request lengths."""
    from repro_torch.serving.scheduler import (
        ContinuousBatchingEngine,
        GenRequest,
    )

    engine = ContinuousBatchingEngine(model, params, sc)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(min(4, args.prompt), args.prompt + 1))
        prompt = rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32)
        engine.submit(GenRequest(
            uid=i, tokens=prompt,
            max_new_tokens=int(
                rng.integers(min(2, args.tokens), args.tokens + 1)
            ),
            temperature=args.temperature, arrival=i // 2,
        ))
    t0 = time.perf_counter()
    for req in engine.run():
        log.info("req %d: joined@%d done@%d slot=%d tokens=%s", req.uid,
                 req.joined_step, req.done_step, req.slot,
                 req.result[:8].tolist())
    log.info("%d requests in %d engine steps (%d joins/evictions logged) "
             "in %.2fs", len(engine.completed), engine.step_count,
             len(engine.events), time.perf_counter() - t0)
    return 0


def serve_jalad(args) -> int:
    """Edge-cloud decoupled serving of the CNN testbed (the paper's mode)."""
    from repro_torch.codec import get_codec, list_codecs
    from repro_torch.serving.edge_cloud import build_edge_cloud_server

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    codecs = tuple(list_codecs()) if args.codec == "auto" else (args.codec,)
    for name in codecs:
        get_codec(name)     # fail fast on a typo, before model/calibration
    jc = JaladConfig(bandwidth_bytes_per_s=args.bandwidth,
                     accuracy_drop_budget=args.acc_drop,
                     codec_choices=codecs)
    t0 = time.perf_counter()
    server, params = build_edge_cloud_server(
        cfg, jc, seed=args.seed, calib_batches=args.calib,
        calib_batch_size=args.batch,
        tables_cache_dir=args.tables_cache or None, device=device)
    log.info("server ready on %s in %.2fs (tables cache: %s)", device,
             time.perf_counter() - t0, args.tables_cache or "disabled")
    if args.pipeline:
        return _serve_jalad_pipelined(args, server, params)
    batch = make_batch(cfg, args.batch, 64, seed=args.seed + 1)
    for i in range(args.requests):
        _, lat = server.serve_batch(batch, bandwidth=args.bandwidth)
        log.info(
            "req %d: point=%d bits=%d codec=%s edge=%.1fms xfer=%.1fms "
            "cloud=%.1fms sent=%dB", i, lat.plan_point, lat.plan_bits,
            lat.plan_codec, lat.edge_s * 1e3,
            lat.transfer_s * 1e3, lat.cloud_s * 1e3, lat.bytes_sent,
        )
    return 0


def _serve_jalad_pipelined(args, server, params) -> int:
    """Overlapped edge/link/cloud serving of a request stream."""
    from repro_torch.serving.pipeline import (
        PipelinedEdgeCloudServer,
        PipelineRequest,
    )

    pipe = PipelinedEdgeCloudServer(server.engine, params,
                                    controller=server.controller)
    cfg = server.engine.model.cfg
    reqs = [PipelineRequest(uid=i,
                            batch=make_batch(cfg, args.batch, 64,
                                             seed=args.seed + 1 + i),
                            bandwidth=args.bandwidth)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = pipe.serve(reqs)
    wall = time.perf_counter() - t0
    for req in done:
        tl = req.timeline
        log.info(
            "req %d: point=%d bits=%d codec=%s edge=[%.1f,%.1f]ms "
            "xfer=[%.1f,%.1f]ms cloud=[%.1f,%.1f]ms lat=%.1fms", req.uid,
            tl.plan_point, tl.plan_bits, tl.plan_codec,
            tl.edge_start * 1e3, tl.edge_end * 1e3,
            tl.xfer_start * 1e3, tl.xfer_end * 1e3, tl.cloud_start * 1e3,
            tl.cloud_end * 1e3, tl.latency_s * 1e3,
        )
    log.info("pipelined makespan %.1fms vs synchronous %.1fms (%.2fx); "
             "wall %.1fms", pipe.makespan_s * 1e3,
             pipe.synchronous_time_s() * 1e3,
             pipe.synchronous_time_s() / max(pipe.makespan_s, 1e-12),
             wall * 1e3)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--jalad", action="store_true",
                    help="JALAD edge-cloud decoupled mode (CNN testbed)")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap edge/link/cloud stages (with --jalad)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler (LM mode)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--bandwidth", type=float, default=1e6)
    ap.add_argument("--codec", default="auto",
                    help="boundary codec for --jalad: a registry id "
                         "(huffman|bitpack|perchannel) or 'auto' to let the "
                         "planner choose among all registered codecs")
    ap.add_argument("--tables-cache", default="",
                    help="directory for config-hashed predictor tables "
                         "(empty = always recalibrate)")
    ap.add_argument("--acc-drop", type=float, default=0.10)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--calib", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if args.jalad:
        return serve_jalad(args)
    return serve_lm(args)


if __name__ == "__main__":
    sys.exit(main())
