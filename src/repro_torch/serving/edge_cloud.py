"""Edge-cloud JALAD serving runtime (the paper's deployment, Fig. 1), on
the device the parameters live on.

A simulated-clock execution of decoupled inference:

  edge compute (T = w*Q_edge/F_edge)  ->  encode (real wire bytes from the
  plan's boundary codec)
  ->  channel transfer (bytes / BW, with a bandwidth trace)
  ->  cloud compute (T = w*Q_cloud/F_cloud)

The numbers are produced by actually running the decoupled model (head ->
codec encode -> codec decode -> tail); the latency is accounted with the
paper's FMAC model, so the clock is device-independent. The
AdaptationController re-solves the decision as the bandwidth trace drifts.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import (
    Any, Dict, Iterable, List, Optional, Protocol, Tuple, runtime_checkable,
)

import torch

from repro_torch.config.types import JaladConfig
from repro_torch.core.adaptation import AdaptationController
from repro_torch.core.decoupler import (
    DecoupledPlan,
    DecoupledRunner,
    JaladEngine,
)
from repro_torch.core.latency import LatencyModel, PNG_RATIO
from repro_torch.device import DeviceLike, resolve_device, tensor_device
from repro_torch.models.api import batch_to


@dataclass
class LatencyBreakdown:
    edge_s: float
    transfer_s: float
    cloud_s: float
    bytes_sent: int
    plan_point: int
    plan_bits: int
    plan_codec: str = ""
    # --- three-tier extension (zeros for two-tier breakdowns, so their
    # ``total_s`` is untouched): middle-tier compute + second link ---
    edge_server_s: float = 0.0
    transfer2_s: float = 0.0
    bytes_sent2: int = 0
    plan_point2: int = -1
    plan_bits2: int = 0
    plan_codec2: str = ""

    @property
    def total_s(self) -> float:
        # The reference's order: with the two middle terms 0.0, a two-tier
        # total keeps the bits of edge + transfer + cloud.
        return (self.edge_s + self.transfer_s + self.edge_server_s
                + self.transfer2_s + self.cloud_s)


@runtime_checkable
class Servable(Protocol):
    """Anything ``serve_trace`` can advance under one trace step: the item
    prices and executes itself against the server. Token-streaming
    sessions (:class:`~repro_torch.serving.streaming.TokenStreamSession`)
    implement it; plain batches don't and go through ``serve_batch``."""

    def serve(self, server: "EdgeCloudServer",
              bandwidth: float) -> "LatencyBreakdown":
        ...


@dataclass
class RunnerCache:
    """(point, bits, codec) -> DecoupledRunner; thread-safe.
    ``mesh_worker`` (a :class:`~repro_torch.serving.meshed.
    MeshedCloudWorker`) goes into every runner built here, so all cached
    plans share ONE mesh and sharded parameter tree for their batched
    cloud steps."""

    engine: JaladEngine
    params: Any
    mesh_worker: Optional[Any] = None
    _cache: Dict[Tuple[int, int, str], DecoupledRunner] = field(
        default_factory=dict)
    _lock: Any = field(default_factory=threading.Lock)

    @torch.no_grad()
    def full_forward(self, batch) -> torch.Tensor:
        """The whole model on the cloud (the cloud-only plan)."""
        model = self.engine.model
        return model.forward(self.params,
                             batch_to(batch, tensor_device(self.params)))

    def get(self, plan: DecoupledPlan) -> DecoupledRunner:
        key = (plan.point, plan.bits, plan.codec)
        with self._lock:
            runner = self._cache.get(key)
        if runner is None:
            runner = self.engine.make_runner(self.params, plan,
                                             mesh_worker=self.mesh_worker)
            with self._lock:
                runner = self._cache.setdefault(key, runner)
        return runner


@dataclass
class EdgeCloudServer:
    """Serves batches through the current JALAD decoupling, one request at
    a time (edge, transfer and cloud strictly in sequence)."""

    engine: JaladEngine
    params: Any
    controller: Optional[AdaptationController] = None
    clock: float = 0.0
    log: List[LatencyBreakdown] = field(default_factory=list)
    runners: Optional[RunnerCache] = None

    def __post_init__(self):
        if self.controller is None:
            self.controller = AdaptationController(self.engine)
        if self.runners is None:
            self.runners = RunnerCache(self.engine, self.params)

    def record(self, bd: LatencyBreakdown) -> LatencyBreakdown:
        """Account one served unit: feed the bandwidth estimator, advance
        the simulated clock, append to the log."""
        self.controller.observe_transfer(max(bd.bytes_sent, 1),
                                         max(bd.transfer_s, 1e-9))
        self.clock += bd.total_s
        self.log.append(bd)
        return bd

    def serve_batch(self, batch, bandwidth: float
                    ) -> Tuple[torch.Tensor, LatencyBreakdown]:
        """Run one batch at the given true bandwidth; returns (logits,
        latency breakdown). Advances the simulated clock."""
        plan = self.controller.current_plan(bandwidth)
        space = self.engine.plan_space
        edge_t, cloud_t = space.stage_times(plan)
        if plan.is_cloud_only:
            logits = self.runners.full_forward(batch)
            nbytes = int(space.input_bytes * PNG_RATIO)
            # The fallback ships a PNG-compressed input image.
            bd = LatencyBreakdown(edge_t, nbytes / bandwidth, cloud_t,
                                  nbytes, -1, 0, "png")
        else:
            runner = self.runners.get(plan)
            blob, extras = runner.edge_step(batch)
            logits = runner.cloud_step(blob, extras)
            bd = LatencyBreakdown(edge_t, blob.nbytes / bandwidth, cloud_t,
                                  blob.nbytes, plan.point, plan.bits,
                                  plan.codec)
        self.record(bd)
        return logits, bd

    def serve_microbatch(self, batches: List[Any], bandwidth: float
                         ) -> List[Tuple[torch.Tensor, LatencyBreakdown]]:
        """Several requests under one plan decision with a single batched
        edge encode; latency accounting stays sequential per request."""
        plan = self.controller.current_plan(bandwidth)
        if plan.is_cloud_only:
            return [self.serve_batch(b, bandwidth) for b in batches]
        runner = self.runners.get(plan)
        edge_t, cloud_t = self.engine.plan_space.stage_times(plan)
        out = []
        for blob, extras in runner.edge_step_batch(batches):
            logits = runner.cloud_step(blob, extras)
            bd = LatencyBreakdown(edge_t, blob.nbytes / bandwidth, cloud_t,
                                  blob.nbytes, plan.point, plan.bits,
                                  plan.codec)
            self.record(bd)
            out.append((logits, bd))
        return out

    def serve_trace(self, items: Iterable[Any],
                    bandwidth_trace: Iterable[float]
                    ) -> List[LatencyBreakdown]:
        """Serve a stream of trace items under a bandwidth trace (Fig. 8).
        An item that implements the :class:`Servable` protocol (e.g. a
        token-streaming session) advances itself for one trace step;
        anything else is a one-shot batch. Both paths record through
        :meth:`record`, so the clock, the log and the bandwidth estimator
        see one sequence."""
        out: List[LatencyBreakdown] = []
        for item, bw in zip(items, bandwidth_trace):
            serve = getattr(item, "serve", None)
            if callable(serve):
                out.append(serve(self, bw))
            else:
                out.append(self.serve_batch(item, bw)[1])
        return out


def build_edge_cloud_server(
    cfg,
    jalad_cfg: JaladConfig,
    *,
    seed: int = 0,
    calib_batches: int = 2,
    calib_batch_size: int = 8,
    seq_len: int = 64,
    params: Any = None,
    points: Optional[List[int]] = None,
    tables_cache_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> Tuple[EdgeCloudServer, Any]:
    """End-to-end factory: model -> calibration -> predictors -> latency
    model -> engine -> server, on ``device`` (default: the CUDA card;
    caller-supplied ``params`` bring their own device). Every latency term
    is per calibration batch. Without labels (a decoder's token batches)
    the accuracy drop is measured against the un-quantized model's own
    predictions; a decoder's ``seq_len``-token batches set the per-batch
    input bytes, ``batch * seq_len * 4`` (int32 token ids).
    ``tables_cache_dir`` loads a table file of the same key (the
    reference's key and file format) instead of recalibrating; it is
    ignored when the caller supplies ``params``."""
    from repro_torch.core.predictor import (
        PredictorTables,
        build_tables,
        load_or_build_tables,
    )
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    caller_params = params is not None
    if params is None:
        params = model.init(seed, resolve_device(device))
    n_points = len(model.decoupling_points())
    if points is None and n_points > 24:
        # Subsample decoupling points for deep models.
        step = max(n_points // 16, 1)
        points = list(range(0, n_points, step))

    def calibrate() -> PredictorTables:
        batches = [
            make_batch(cfg, calib_batch_size, seq_len, seed=seed + 10 + i)
            for i in range(calib_batches)
        ]
        return build_tables(model, params, batches,
                            list(jalad_cfg.bits_choices),
                            codecs=list(jalad_cfg.codec_choices),
                            points=points)

    cache_dir = None if caller_params else tables_cache_dir
    key = PredictorTables.cache_key(
        cfg.arch_id, jalad_cfg.bits_choices, jalad_cfg.codec_choices,
        points=points, seed=seed, calib_batches=calib_batches,
        calib_batch_size=calib_batch_size, seq_len=seq_len,
        config=repr(cfg),
    )
    tables, _ = load_or_build_tables(cache_dir, key, calibrate)
    if cfg.family == "cnn":
        input_bytes = calib_batch_size * 3 * cfg.image_size * cfg.image_size
    else:
        input_bytes = calib_batch_size * seq_len * 4
    fmacs = model.per_point_fmacs(calib_batch_size, seq_len)
    lat = LatencyModel(fmacs, jalad_cfg.edge, jalad_cfg.cloud,
                       float(input_bytes))
    engine = JaladEngine(model, tables, lat, jalad_cfg,
                         point_indices=points)
    return EdgeCloudServer(engine, params), params
