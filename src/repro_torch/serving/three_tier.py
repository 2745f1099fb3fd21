"""Three-tier JALAD serving: device → edge server → cloud on one clock, on
the device the parameters live on.

The three-hop form of :mod:`repro_torch.serving.fleet`: every request
crosses five simulated stages

  device compute [0, i1]  ->  encode₁  ->  uplink transfer (S1/BW1)
  ->  edge-server compute (i1, i2] (+ decode₁ / encode₂)
  ->  backhaul transfer (S2/BW2)  ->  cloud compute (i2, N)

with per-device FIFO device + uplink stages and SHARED edge-server,
backhaul and cloud stages (one edge site serves the whole fleet, as one
cloud does in ``FleetServer``). Decisions come from ONE vectorized
:class:`~repro_torch.core.adaptation.TriFleetAdaptationController` re-plan
per serving wave over the flattened two-cut index; numerics from real
:class:`~repro_torch.core.decoupler.TriDecoupledRunner` steps (head ->
codec -> segment -> codec -> tail), whose codecs launch the CUDA kernels
on a card.

The accounting contract, as the reference's: each breakdown component
equals the planner's prediction exactly. ``edge_s`` / ``edge_server_s`` /
``cloud_s`` are ``TriPlanSpace.stage_times`` and, for the fixed-rate
``bitpack`` codec, whose wire bytes match the calibration tables,
``transfer_s`` / ``transfer2_s`` are exactly ``plan_sizes / bandwidth``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.types import DeviceProfile, JaladConfig
from repro_torch.core.adaptation import TriFleetAdaptationController
from repro_torch.core.decoupler import (
    DecoupledPlan,
    JaladEngine,
    TriDecoupledRunner,
)
from repro_torch.core.latency import PNG_RATIO
from repro_torch.core.tri_planner import TriFleetPlanSpace
from repro_torch.device import DeviceLike, tensor_device
from repro_torch.models.api import batch_to
from repro_torch.serving.edge_cloud import LatencyBreakdown
from repro_torch.serving.fleet import FleetRequest, request_waves

TriPlanKey = Tuple[int, int, str, int, int, str]


@dataclass
class TriStageTimeline:
    """Simulated-clock occupancy of one request across the five stages."""

    arrival_s: float = 0.0
    device_start: float = 0.0
    device_end: float = 0.0
    xfer1_start: float = 0.0
    xfer1_end: float = 0.0
    es_start: float = 0.0
    es_end: float = 0.0
    xfer2_start: float = 0.0
    xfer2_end: float = 0.0
    cloud_start: float = 0.0
    cloud_end: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.cloud_end - self.arrival_s

    @property
    def service_s(self) -> float:
        """Pure service time: the synchronous (no-queueing) latency."""
        return ((self.device_end - self.device_start)
                + (self.xfer1_end - self.xfer1_start)
                + (self.es_end - self.es_start)
                + (self.xfer2_end - self.xfer2_start)
                + (self.cloud_end - self.cloud_start))


@dataclass
class ThreeTierServer:
    """Serve D devices through one shared edge server and one cloud.

    ``engine`` supplies the tables and the three-tier space
    (``engine.tri_space``); ``edge_profiles`` stack into one
    :class:`TriFleetPlanSpace` for the fused fleet re-plan. Runners are
    shared across devices, one a six-tuple plan key.
    """

    engine: JaladEngine
    params: Any
    edge_profiles: Sequence[DeviceProfile]
    controller: Optional[TriFleetAdaptationController] = None
    fleet_space: Optional[TriFleetPlanSpace] = None
    max_history: Optional[int] = None
    completed: List[FleetRequest] = field(default_factory=list)
    _runners: Dict[TriPlanKey, TriDecoupledRunner] = field(
        default_factory=dict, repr=False)
    # Simulated FIFO clocks: per-device device + uplink, shared middle/cloud.
    _device_free: np.ndarray = field(default=None, repr=False)
    _link1_free: np.ndarray = field(default=None, repr=False)
    _es_free: float = 0.0
    _link2_free: float = 0.0
    _cloud_free: float = 0.0
    _timelines: Dict[int, TriStageTimeline] = field(default_factory=dict,
                                                    repr=False)

    def __post_init__(self):
        if not self.edge_profiles:
            raise ValueError("ThreeTierServer needs at least one profile")
        if self.fleet_space is None:
            self.fleet_space = TriFleetPlanSpace.build(
                self.engine.tri_space, list(self.edge_profiles))
        if self.controller is None:
            self.controller = TriFleetAdaptationController(
                self.fleet_space,
                default_bw1=self.engine.cfg.bandwidth_bytes_per_s,
                default_bw2=self.engine.cfg.bandwidth2_bytes_per_s,
                max_history=self.max_history)
        d = len(self.edge_profiles)
        self._device_free = np.zeros(d)
        self._link1_free = np.zeros(d)

    @property
    def n_devices(self) -> int:
        return len(self.edge_profiles)

    # ------------------------------------------------------------ runners
    def _runner(self, plan: DecoupledPlan) -> TriDecoupledRunner:
        key = (plan.point, plan.bits, plan.codec,
               plan.point2, plan.bits2, plan.codec2)
        runner = self._runners.get(key)
        if runner is None:
            runner = self.engine.make_tri_runner(self.params, plan)
            self._runners[key] = runner
        return runner

    @torch.no_grad()
    def _full_forward(self, batch) -> torch.Tensor:
        """The whole model on the cloud (the cloud-only plan)."""
        return self.engine.model.forward(
            self.params, batch_to(batch, tensor_device(self.params)))

    def timeline_for(self, uid: int) -> TriStageTimeline:
        return self._timelines[uid]

    # -------------------------------------------------------------- serve
    def serve(self, requests: Iterable[FleetRequest]) -> List[FleetRequest]:
        """Run a three-tier request stream to completion; returns the
        requests in cloud-completion order. ``FleetRequest.bandwidth`` is
        the device uplink, ``bandwidth2`` the edge-server backhaul
        (``<= 0`` falls back to the config's second-link bandwidth)."""
        reqs = list(requests)
        for r in reqs:
            if not 0 <= r.device_id < self.n_devices:
                raise ValueError(
                    f"request {r.uid} names unknown device {r.device_id}")
        tri = self.fleet_space.tri
        default_bw2 = self.engine.cfg.bandwidth2_bytes_per_s
        bw2_of: Dict[int, float] = {}
        for wave in request_waves(reqs):
            m = len(wave)
            dv = np.fromiter((r.device_id for r in wave), np.int64, m)
            bw1 = np.fromiter((r.bandwidth for r in wave), np.float64, m)
            bw2 = np.fromiter(
                (r.bandwidth2 if r.bandwidth2 > 0 else default_bw2
                 for r in wave), np.float64, m)
            # ONE fused fleet re-decision for the whole wave.
            cells, _ = self.controller.current_plans(bw1, bw2, dv)
            dev_t, es_t, cl_t = self.fleet_space.stage_times_all(cells, dv)
            # Device + uplink: real numerics and exact wire bytes.
            n1 = np.empty(m)
            for i, r in enumerate(wave):
                plan = self.controller.plan_for(r.device_id)
                r.plan = plan
                if plan.is_cloud_only:
                    n1[i] = int(tri.input_bytes * PNG_RATIO)
                elif r.batch is not None:
                    r._blob, r._extras = self._runner(plan).device_step(
                        r.batch)
                    n1[i] = r._blob.nbytes
                else:
                    # Decision-plane run: charge the planner's sizes.
                    n1[i] = tri.plan_sizes(plan)[0]
            t1 = n1 / bw1
            arrival = np.fromiter((r.arrival_s for r in wave),
                                  np.float64, m)
            dev_start = np.maximum(arrival, self._device_free[dv])
            dev_end = dev_start + dev_t
            self._device_free[dv] = dev_end
            x1_start = np.maximum(dev_end, self._link1_free[dv])
            x1_end = x1_start + t1
            self._link1_free[dv] = x1_end
            self.controller.observe_transfers(
                np.maximum(n1, 1), np.maximum(t1, 1e-9), dv, link=1)
            for i, r in enumerate(wave):
                self._timelines[r.uid] = TriStageTimeline(
                    arrival_s=r.arrival_s,
                    device_start=float(dev_start[i]),
                    device_end=float(dev_end[i]),
                    xfer1_start=float(x1_start[i]),
                    xfer1_end=float(x1_end[i]),
                )
                co = r.plan.is_cloud_only
                r.breakdown = LatencyBreakdown(
                    float(dev_t[i]), float(t1[i]), float(cl_t[i]),
                    int(n1[i]),
                    -1 if co else r.plan.point,
                    0 if co else r.plan.bits,
                    "png" if co else r.plan.codec,
                    edge_server_s=float(es_t[i]),
                    plan_point2=-1 if co else r.plan.point2,
                    plan_bits2=0 if co else r.plan.bits2,
                    plan_codec2="" if co else r.plan.codec2,
                )
                bw2_of[r.uid] = float(bw2[i])
        # Shared middle + tail stages: FIFO in uplink-completion order.
        queue = sorted(
            reqs, key=lambda r: (self._timelines[r.uid].xfer1_end,
                                 r.device_id, r.uid))
        obs_n2, obs_t2, obs_dv = [], [], []
        for r in queue:
            tl = self._timelines[r.uid]
            bd = r.breakdown
            plan = r.plan
            # Edge-server stage (decode₁ + segment + encode₂; zero-time
            # relay when the plan is diagonal or cloud-only).
            tl.es_start = max(tl.xfer1_end, self._es_free)
            tl.es_end = tl.es_start + bd.edge_server_s
            self._es_free = tl.es_end
            if plan.is_cloud_only:
                nb2 = bd.bytes_sent
                if r.batch is not None:
                    r.logits = self._full_forward(r.batch)
            elif r.batch is not None:
                r._blob, r._extras = self._runner(plan).edge_server_step(
                    r._blob, r._extras)
                nb2 = r._blob.nbytes
            else:
                nb2 = tri.plan_sizes(plan)[1]
            bd.bytes_sent2 = int(nb2)
            bd.transfer2_s = nb2 / bw2_of[r.uid]
            tl.xfer2_start = max(tl.es_end, self._link2_free)
            tl.xfer2_end = tl.xfer2_start + bd.transfer2_s
            self._link2_free = tl.xfer2_end
            obs_n2.append(max(nb2, 1))
            obs_t2.append(max(bd.transfer2_s, 1e-9))
            obs_dv.append(r.device_id)
            # Cloud tail.
            tl.cloud_start = max(tl.xfer2_end, self._cloud_free)
            tl.cloud_end = tl.cloud_start + bd.cloud_s
            self._cloud_free = tl.cloud_end
            if not plan.is_cloud_only and r.batch is not None:
                r.logits = self._runner(plan).cloud_step(r._blob, r._extras)
            r._blob = r._extras = None
        if obs_dv:
            self.controller.observe_transfers(
                np.asarray(obs_n2), np.asarray(obs_t2),
                np.asarray(obs_dv, dtype=np.int64), link=2)
        self.completed.extend(queue)
        return queue

    # ----------------------------------------------------------- reporting
    @property
    def makespan_s(self) -> float:
        """Simulated wall-clock from first arrival to last cloud finish."""
        if not self.completed:
            return 0.0
        start = min(self._timelines[r.uid].arrival_s
                    for r in self.completed)
        return max(self._timelines[r.uid].cloud_end
                   for r in self.completed) - start

    def synchronous_time_s(self) -> float:
        """The sum of every request's sequential service time."""
        return sum(r.breakdown.total_s for r in self.completed)


def build_three_tier_server(
    cfg,
    jalad_cfg: JaladConfig,
    edge_profiles: Sequence[DeviceProfile],
    *,
    device: DeviceLike = None,
    seed: int = 0,
    calib_batches: int = 2,
    calib_batch_size: int = 8,
    seq_len: int = 64,
    params: Any = None,
    points: Optional[List[int]] = None,
    tables_cache_dir: Optional[str] = None,
    max_history: Optional[int] = None,
) -> Tuple[ThreeTierServer, Any]:
    """End-to-end factory on ``device`` (default: the CUDA card), reusing
    the two-tier calibration: one table build (or a reload from
    ``tables_cache_dir``), one TriPlanSpace, one stacked
    TriFleetPlanSpace."""
    from repro_torch.serving.edge_cloud import build_edge_cloud_server

    srv, params = build_edge_cloud_server(
        cfg, jalad_cfg, seed=seed, calib_batches=calib_batches,
        calib_batch_size=calib_batch_size, seq_len=seq_len, params=params,
        points=points, tables_cache_dir=tables_cache_dir, device=device,
    )
    server = ThreeTierServer(srv.engine, params, list(edge_profiles),
                             max_history=max_history)
    return server, params


__all__ = [
    "ThreeTierServer",
    "TriStageTimeline",
    "build_three_tier_server",
]
