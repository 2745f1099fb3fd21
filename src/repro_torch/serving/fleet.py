"""Fleet-scale edge-cloud serving: D heterogeneous edges, one shared cloud.

The paper's end state (Sec. III-E, Fig. 8) is a cloud that serves *many*
edge devices, each adapting its decoupling to its own link and its own
compute. :class:`FleetServer` models exactly that, with the whole fleet's
decision plane held in stacked arrays:

* **Vectorized decision plane.** Per-device state (bandwidth estimates,
  current plan cells, hysteresis step counters, FIFO edge / link clocks)
  lives in ``(D,)`` arrays. One :class:`~repro_torch.core.planner.
  FleetPlanSpace` stacks every device's ``with_edge`` view over ONE shared
  :class:`~repro_torch.core.planner.PlanSpace`, and a fleet-wide re-plan
  is a single fused ``decide_all`` argmin driven by the vectorized
  :class:`~repro_torch.core.adaptation.FleetAdaptationController`.
  Requests are served in *waves* (the k-th request of each device), so
  the per-device decision / observation sequence is exactly the
  synchronous ``EdgeCloudServer.serve_batch`` sequence and results equal
  serving each device alone.

* **Object view kept.** ``fleet.devices[d]`` is a thin view over the
  arrays (profile, lazy ``for_edge`` engine, clock, log).
  ``vectorized=False`` runs the per-device controller loop, kept as the
  reference implementation the array path is held against.

* **Shared cloud worker with tail batching.** In-flight requests from
  *different* devices that agreed on the same (point, bits, codec) plan
  are grouped, and each group runs ONE batched wire decode on the card
  (:meth:`DecoupledRunner.cloud_step_batch`: one K2 or K5 launch). By
  default the tails then run per request (equal to the synchronous
  server); ``fuse_cloud_tail=True`` runs ONE concatenated tail forward
  per group (fastest, equal within float tolerance only). With
  ``cloud_mesh`` the shared worker is sharded over a ``DeviceMesh``
  (:class:`~repro_torch.serving.meshed.MeshedCloudWorker`): every rank
  runs the same ``serve`` over the same requests, and only the cloud
  decode and tail are split.

* **Reproducible accounting.** Per-device FIFO edge and link stages feed
  a single shared cloud stage that serves requests in arrival order (ties
  broken by (device, uid)), each occupying the cloud for its own modeled
  T_C. Real batching never changes the reported numbers.

Trace-shaped request streams (diurnal load, bandwidth walks, flash
crowds) for driving this server live in :mod:`repro_torch.serving.
workloads`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.types import DeviceProfile, JaladConfig
from repro_torch.core.adaptation import (
    AdaptationController,
    FleetAdaptationController,
)
from repro_torch.core.decoupler import DecoupledPlan, JaladEngine
from repro_torch.core.latency import PNG_RATIO
from repro_torch.core.planner import FleetPlanSpace
from repro_torch.device import DeviceLike
from repro_torch.serving.edge_cloud import LatencyBreakdown, RunnerCache
from repro_torch.serving.pipeline import StageTimeline
from repro_torch.utils.trace import span

PlanKey = Tuple[int, int, str]            # (point, bits, codec)


class FleetDevice:
    """Thin per-device view over the fleet's array-backed state: the
    object API (profile, engine view, clock, log) without per-device
    storage. ``engine`` materializes the ``for_edge`` PlanSpace view
    lazily; ``controller`` is the per-device scalar controller in
    ``vectorized=False`` mode and ``None`` in vectorized mode (the fleet
    then has ONE :class:`FleetAdaptationController`)."""

    __slots__ = ("_fleet", "device_id", "profile", "_engine", "_controller")

    def __init__(self, fleet: "FleetServer", device_id: int,
                 profile: DeviceProfile):
        self._fleet = fleet
        self.device_id = device_id
        self.profile = profile
        self._engine: Optional[JaladEngine] = None
        self._controller: Optional[AdaptationController] = None

    @property
    def engine(self) -> JaladEngine:
        if self._engine is None:
            self._engine = self._fleet.engine.for_edge(self.profile)
        return self._engine

    @property
    def controller(self) -> Optional[AdaptationController]:
        if self._fleet.vectorized:
            return None
        if self._controller is None:
            self._controller = AdaptationController(self.engine)
        return self._controller

    @property
    def clock(self) -> float:
        return float(self._fleet._clock[self.device_id])

    @property
    def log(self) -> List[LatencyBreakdown]:
        return self._fleet._logs[self.device_id]

    @property
    def plan(self) -> Optional[DecoupledPlan]:
        """The device's active plan (post-hysteresis), either mode."""
        if self._fleet.vectorized:
            return self._fleet.controller.plan_for(self.device_id)
        return self.controller.plan

    def __repr__(self) -> str:      # pragma: no cover - debug aid
        return (f"FleetDevice({self.device_id}, {self.profile.name}, "
                f"clock={self.clock:.4g})")


@dataclass
class FleetRequest:
    uid: int
    device_id: int
    batch: Any
    bandwidth: float                      # true link bandwidth (per request)
    arrival_s: float = 0.0
    # Second (edge-server -> cloud) link bandwidth for three-tier serving;
    # 0.0 on two-tier traces (ignored by FleetServer).
    bandwidth2: float = 0.0
    # Filled by the fleet:
    logits: Any = None
    plan: Optional[DecoupledPlan] = None
    breakdown: Optional[LatencyBreakdown] = None
    timeline: StageTimeline = field(default_factory=StageTimeline)
    _blob: Any = None
    _extras: Any = None


def request_waves(reqs: List[FleetRequest]) -> List[List[FleetRequest]]:
    """Wave k holds the k-th request of every device, in stream order.
    Decisions and clocks only couple *within* a device, so advancing one
    wave at a time with a fleet-wide fused decide is equivalent to the
    per-request loop — and each wave touches any device at most once,
    making the array scatter updates safe."""
    seq: Dict[int, int] = {}
    waves: List[List[FleetRequest]] = []
    for r in reqs:
        k = seq.get(r.device_id, 0)
        seq[r.device_id] = k + 1
        if k == len(waves):
            waves.append([])
        waves[k].append(r)
    return waves


@dataclass
class CloudGroup:
    """One real batched cloud launch: which requests shared it."""

    key: Optional[PlanKey]                # None => cloud-only full forwards
    uids: List[int]


@dataclass
class FleetServer:
    """Serve D heterogeneous edge devices against one shared cloud.

    ``engine`` is the template (tables + cloud profile + config); the
    ``edge_profiles`` stack into one :class:`FleetPlanSpace` sharing the
    template's PlanSpace. Runners are shared across devices: one runner
    per (point, bits, codec) plan for the whole fleet.
    """

    engine: JaladEngine
    params: Any
    edge_profiles: Sequence[DeviceProfile]
    cloud_batch: int = 8                  # max requests per batched launch
    # False (default): exact tails — one batched decode launch per group,
    # tails through the same per-request run_tail as the synchronous
    # server (equal results). True: additionally fuse each group into ONE
    # concatenated tail forward (fastest; equal within float tolerance
    # only — see cloud_step_batch).
    fuse_cloud_tail: bool = False
    # True (default): array-backed decision plane — one fused decide_all
    # per serving wave. False: the per-device AdaptationController loop,
    # kept as the reference path the vectorized one is pinned against.
    vectorized: bool = True
    # Optional DeviceMesh: shard the shared cloud worker across it.
    # Grouped requests then decode and run their tail through ONE sharded
    # forward (serving.meshed.MeshedCloudWorker: float-equivalent to the
    # single-device tails, the fuse_cloud_tail=True contract), and the
    # planner prices the cloud side under the matching CloudMeshModel, so
    # plans shift as the mesh widens. Every rank of the mesh runs serve()
    # over the same requests.
    cloud_mesh: Optional[Any] = None
    # Planner-side per-remaining-layer collective seconds for the mesh
    # model (0.0 = ideal scaling; CloudMeshModel.from_interconnect prices
    # a real interconnect).
    cloud_collective_s: float = 0.0
    mesh_worker: Optional[Any] = None
    runners: Optional[RunnerCache] = None
    devices: List[FleetDevice] = field(default_factory=list)
    completed: List[FleetRequest] = field(default_factory=list)
    cloud_groups: List[CloudGroup] = field(default_factory=list)
    # Attached token-streaming sessions (repro_torch.serving.streaming):
    # their per-step boundary rows merge into the (point, bits, codec)
    # cloud groups alongside the one-shot batches (see step_streams).
    stream_sessions: List[Any] = field(default_factory=list)
    fleet_space: Optional[FleetPlanSpace] = None
    controller: Optional[FleetAdaptationController] = None
    _cloud_free: float = 0.0
    # (D,) simulated FIFO clocks + per-device accounting
    _edge_free: np.ndarray = field(default=None, repr=False)
    _link_free: np.ndarray = field(default=None, repr=False)
    _clock: np.ndarray = field(default=None, repr=False)
    _logs: List[List[LatencyBreakdown]] = field(default_factory=list,
                                                repr=False)

    def __post_init__(self):
        if not self.edge_profiles:
            raise ValueError("FleetServer needs at least one edge profile")
        if self.cloud_mesh is not None:
            from repro_torch.core.latency import CloudMeshModel
            from repro_torch.serving.meshed import MeshedCloudWorker, mesh_size

            # Planner and worker see the SAME mesh: the decision space is
            # re-derived with the mesh-parallel cloud model (identity at
            # size 1) before the fleet plane is stacked over it.
            self.engine = self.engine.with_cloud_mesh(CloudMeshModel(
                mesh_size(self.cloud_mesh), float(self.cloud_collective_s)))
            if self.mesh_worker is None:
                self.mesh_worker = MeshedCloudWorker(
                    self.engine.model, self.params, self.cloud_mesh)
        if self.runners is None:
            self.runners = RunnerCache(self.engine, self.params,
                                       mesh_worker=self.mesh_worker)
        d = len(self.edge_profiles)
        if self.fleet_space is None:
            self.fleet_space = FleetPlanSpace.build(
                self.engine.plan_space, self.edge_profiles)
        if self.controller is None:
            self.controller = FleetAdaptationController(
                self.fleet_space,
                default_bw=self.engine.cfg.bandwidth_bytes_per_s)
        self._edge_free = np.zeros(d)
        self._link_free = np.zeros(d)
        self._clock = np.zeros(d)
        self._logs = [[] for _ in range(d)]
        if not self.devices:
            self.devices = [FleetDevice(self, i, prof)
                            for i, prof in enumerate(self.edge_profiles)]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    # -------------------------------------------------------------- stages
    def _edge_and_link_phase(self, reqs: List[FleetRequest]) -> int:
        """Per-device FIFO edge compute + encode + link transfer, decided
        wave-by-wave through the vectorized controller. The per-device
        decision/observation sequence is exactly the synchronous
        ``EdgeCloudServer.serve_batch`` sequence, so per-device plans
        (and therefore results) match serving each device alone. Returns
        the number of waves."""
        waves = request_waves(reqs)
        for wave in waves:
            m = len(wave)
            dv = np.fromiter((r.device_id for r in wave), np.int64, m)
            bws = np.fromiter((r.bandwidth for r in wave), np.float64, m)
            # ONE fused fleet re-decision for the whole wave.
            with span("fleet.decide", wave=m):
                plan_j, _ = self.controller.current_plans(bws, dv)
            # Real numerics: per-request edge halves (heterogeneous plans
            # cannot batch across devices; PR 3's micro-batching still
            # applies inside each request's own batch).
            nbytes = np.empty(m)
            for i, r in enumerate(wave):
                plan = self.controller.plan_for(r.device_id)
                r.plan = plan
                with span("fleet.edge", uid=r.uid, device=r.device_id,
                          point=plan.point, bits=plan.bits,
                          codec=plan.codec):
                    if plan.is_cloud_only:
                        nb = int(self.fleet_space.space.input_bytes
                                 * PNG_RATIO)
                    else:
                        runner = self.runners.get(plan)
                        r._blob, r._extras = runner.edge_step(r.batch)
                        nb = r._blob.nbytes
                nbytes[i] = nb
            # Array-backed simulated clocks: vectorized FIFO bookkeeping
            # over the wave (each device appears at most once per wave).
            edge_t, cloud_t = self.fleet_space.stage_times_all(plan_j, dv)
            transfer_t = nbytes / bws
            arrival = np.fromiter((r.arrival_s for r in wave),
                                  np.float64, m)
            edge_start = np.maximum(arrival, self._edge_free[dv])
            edge_end = edge_start + edge_t
            self._edge_free[dv] = edge_end
            xfer_start = np.maximum(edge_end, self._link_free[dv])
            xfer_end = xfer_start + transfer_t
            self._link_free[dv] = xfer_end
            self.controller.observe_transfers(
                np.maximum(nbytes, 1), np.maximum(transfer_t, 1e-9), dv)
            for i, r in enumerate(wave):
                plan = r.plan
                tl = r.timeline
                tl.arrival_s = r.arrival_s
                tl.edge_start = float(edge_start[i])
                tl.edge_end = float(edge_end[i])
                tl.xfer_start = float(xfer_start[i])
                tl.xfer_end = float(xfer_end[i])
                tl.bytes_sent = int(nbytes[i])
                tl.plan_point = plan.point
                tl.plan_bits = plan.bits
                tl.plan_codec = (plan.codec if not plan.is_cloud_only
                                 else "png")
                r.breakdown = LatencyBreakdown(
                    float(edge_t[i]), float(transfer_t[i]),
                    float(cloud_t[i]), int(nbytes[i]),
                    plan.point if not plan.is_cloud_only else -1,
                    plan.bits if not plan.is_cloud_only else 0,
                    plan.codec if not plan.is_cloud_only else "png",
                )
        return len(waves)

    def _edge_and_link_phase_scalar(self, reqs: List[FleetRequest]) -> None:
        """Reference path (``vectorized=False``): the original per-device
        AdaptationController loop, which the vectorized phase must equal
        request for request."""
        for r in reqs:
            d = r.device_id
            dev = self.devices[d]
            plan = dev.controller.current_plan(r.bandwidth)
            r.plan = plan
            space = dev.engine.plan_space
            edge_t, cloud_t = space.stage_times(plan)
            if plan.is_cloud_only:
                nbytes = int(space.input_bytes * PNG_RATIO)
            else:
                runner = self.runners.get(plan)
                r._blob, r._extras = runner.edge_step(r.batch)
                nbytes = r._blob.nbytes
            transfer_t = nbytes / r.bandwidth
            tl = r.timeline
            tl.arrival_s = r.arrival_s
            tl.edge_start = max(r.arrival_s, float(self._edge_free[d]))
            tl.edge_end = tl.edge_start + edge_t
            self._edge_free[d] = tl.edge_end
            tl.xfer_start = max(tl.edge_end, float(self._link_free[d]))
            tl.xfer_end = tl.xfer_start + transfer_t
            self._link_free[d] = tl.xfer_end
            tl.bytes_sent = nbytes
            tl.plan_point = plan.point
            tl.plan_bits = plan.bits
            tl.plan_codec = plan.codec if not plan.is_cloud_only else "png"
            dev.controller.observe_transfer(max(nbytes, 1),
                                            max(transfer_t, 1e-9))
            r.breakdown = LatencyBreakdown(
                edge_t, transfer_t, cloud_t, nbytes,
                plan.point if not plan.is_cloud_only else -1,
                plan.bits if not plan.is_cloud_only else 0,
                plan.codec if not plan.is_cloud_only else "png",
            )

    def _cloud_phase(self, reqs: List[FleetRequest]) -> List[FleetRequest]:
        """Shared cloud: FIFO simulated-clock accounting over the merged
        arrival stream, real execution batched by (point, bits, codec)."""
        queue = sorted(
            reqs, key=lambda r: (r.timeline.xfer_end, r.device_id, r.uid))
        # Accounting: each request occupies the shared cloud stage for its
        # own modeled T_C, in arrival order — batching never changes the
        # reported numbers.
        for r in queue:
            tl = r.timeline
            tl.cloud_start = max(tl.xfer_end, self._cloud_free)
            tl.cloud_end = tl.cloud_start + r.breakdown.cloud_s
            self._cloud_free = tl.cloud_end
        # Real numerics: group the in-flight queue by plan key and run one
        # batched wire decode + one batched tail forward per group.
        groups: Dict[Optional[PlanKey], List[FleetRequest]] = {}
        order: List[Optional[PlanKey]] = []
        for r in queue:
            key = (None if r.plan.is_cloud_only else
                   (r.plan.point, r.plan.bits, r.plan.codec))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        for key in order:
            members = groups[key]
            if key is None:
                for r in members:
                    with span("fleet.full_forward", uid=r.uid):
                        r.logits = self.runners.full_forward(r.batch)
                self.cloud_groups.append(
                    CloudGroup(None, [r.uid for r in members]))
                continue
            runner = self.runners.get(members[0].plan)
            step = max(self.cloud_batch, 1)
            for i in range(0, len(members), step):
                chunk = members[i:i + step]
                uids = [r.uid for r in chunk]
                with span("fleet.cloud", key=key, uids=uids):
                    outs = runner.cloud_step_batch(
                        [r._blob for r in chunk],
                        [r._extras for r in chunk],
                        fuse_tail=self.fuse_cloud_tail,
                    )
                for r, logits in zip(chunk, outs):
                    r.logits = logits
                self.cloud_groups.append(CloudGroup(key, uids))
        return queue

    # -------------------------------------------------------------- public
    def serve(self, requests: Iterable[FleetRequest]) -> List[FleetRequest]:
        """Run a fleet request stream to completion. Returns the requests
        in cloud-completion order (per-device submission order is preserved
        inside each device's edge/link stages)."""
        reqs = list(requests)
        for r in reqs:
            if not 0 <= r.device_id < self.n_devices:
                raise ValueError(
                    f"request {r.uid} names unknown device {r.device_id}")
        with span("fleet.serve", requests=len(reqs)) as sp:
            if self.vectorized:
                sp.set(waves=self._edge_and_link_phase(reqs))
            else:
                self._edge_and_link_phase_scalar(reqs)
            done = self._cloud_phase(reqs)
            # Per-device bookkeeping in submission order — mirrors the
            # synchronous server's clock/log exactly.
            for r in reqs:
                self._clock[r.device_id] += r.breakdown.total_s
                self._logs[r.device_id].append(r.breakdown)
                r._blob = r._extras = None
        self.completed.extend(done)
        return done

    # ------------------------------------------------------ token streaming
    def attach_stream(self, session: Any) -> None:
        """Register a :class:`~repro_torch.serving.streaming.
        TokenStreamSession` whose per-step wire work should batch with
        other attached sessions that agreed on the same (point, bits,
        codec) plan."""
        if getattr(session, "plan", None) is None:
            raise ValueError("attach_stream needs a TokenStreamSession "
                             "carrying a DecoupledPlan")
        self.stream_sessions.append(session)

    def step_streams(self) -> int:
        """Advance every attached streaming session one engine step.
        Sessions are bucketed by plan key and each bucket runs ONE
        cross-session batched boundary encode/decode
        (:func:`~repro_torch.serving.streaming.step_stream_group`) —
        streaming slots join the fleet's cloud groups exactly like
        one-shot requests, and each group is logged in ``cloud_groups``.
        Returns the number of tokens generated this step."""
        from repro_torch.serving.streaming import step_stream_group

        live = [s for s in self.stream_sessions if s.queue or s.num_active]
        buckets: Dict[PlanKey, List[Any]] = {}
        order: List[PlanKey] = []
        for s in live:
            key = s.plan_key
            if key not in buckets:
                buckets[key] = []
                order.append(key)
            buckets[key].append(s)
        tokens = 0
        for key in order:
            before = sum(s.tokens_out for s in buckets[key])
            pairs = step_stream_group(buckets[key])
            uids = [u for _, us in pairs for u in us]
            if uids:
                self.cloud_groups.append(CloudGroup(key, uids))
            tokens += sum(s.tokens_out for s in buckets[key]) - before
        return tokens

    def run_streams(self) -> int:
        """Drain every attached streaming session; returns total tokens
        generated. (Arrival-deferred requests admit as the sessions'
        step counters advance, so the loop always terminates.)"""
        total = 0
        while any(s.queue or s.num_active for s in self.stream_sessions):
            total += self.step_streams()
        return total

    # ----------------------------------------------------------- reporting
    @property
    def makespan_s(self) -> float:
        """Simulated wall-clock from first arrival to last cloud finish."""
        if not self.completed:
            return 0.0
        start = min(r.timeline.arrival_s for r in self.completed)
        return max(r.timeline.cloud_end for r in self.completed) - start

    def synchronous_time_s(self) -> float:
        """Total cost without any overlap or sharing: the sum of every
        request's sequential service time across the fleet."""
        return sum(r.breakdown.total_s for r in self.completed)

    def batched_launches(self) -> int:
        """Real batched cloud launches that covered more than one request."""
        return sum(1 for g in self.cloud_groups
                   if g.key is not None and len(g.uids) > 1)


def build_fleet_server(
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
    cloud_batch: int = 8,
    vectorized: bool = True,
    cloud_mesh: Any = None,
    cloud_collective_s: float = 0.0,
    fuse_cloud_tail: bool = False,
) -> Tuple[FleetServer, Any]:
    """End-to-end factory on ``device`` (default: the CUDA card): one
    calibration (the tables are device-independent), one PlanSpace, one
    stacked FleetPlanSpace over the device profiles."""
    from repro_torch.serving.edge_cloud import build_edge_cloud_server
    from repro_torch.sharding.rules import mesh_axes

    if cloud_mesh is not None:
        mesh_axes(cloud_mesh)          # refuse a bad mesh before calibrating
    srv, params = build_edge_cloud_server(
        cfg, jalad_cfg, seed=seed, calib_batches=calib_batches,
        calib_batch_size=calib_batch_size, seq_len=seq_len, params=params,
        points=points, tables_cache_dir=tables_cache_dir, device=device,
    )
    fleet = FleetServer(srv.engine, params, list(edge_profiles),
                        cloud_batch=cloud_batch, vectorized=vectorized,
                        cloud_mesh=cloud_mesh,
                        cloud_collective_s=cloud_collective_s,
                        fuse_cloud_tail=fuse_cloud_tail)
    return fleet, params
