"""Pipelined edge-cloud serving (the paper's Fig. 1 deployment, overlapped).

The synchronous :class:`repro_torch.serving.edge_cloud.EdgeCloudServer`
runs ``edge -> transfer -> cloud`` strictly in sequence. This module
overlaps the three stages: while the cloud half computes request *k*, the
link carries request *k+1*'s boundary and the edge half computes request
*k+2*.

Execution model
---------------
Three worker threads (edge, link, cloud) joined by FIFO queues run the real
numerics (head forward, codec encode, codec decode, tail forward) on the
parameters' device. Accounting uses the paper's FMAC latency model on a
simulated clock: each stage keeps a ``busy_until`` timestamp and a request
occupies a stage for its modeled duration,

    edge_end[i]  = max(arrival[i],  edge_end[i-1])  + T_E(plan_i)
    xfer_end[i]  = max(edge_end[i], xfer_end[i-1])  + bytes_i / BW_i
    cloud_end[i] = max(xfer_end[i], cloud_end[i-1]) + T_C(plan_i)

so the timelines are device-independent and equal the reference's.

Adaptation is live: the edge stage asks the shared
:class:`AdaptationController` for the current plan from the controller's
own bandwidth estimate (fed by the link stage's observed transfers), and a
re-decoupling listener builds the new runner off the critical path.

The edge stage is micro-batched: it drains up to ``micro_batch`` queued
requests, decides a plan for each, and encodes every run of consecutive
same-plan requests through one batched codec launch
(``DecoupledRunner.edge_step_batch``). The blobs are byte-identical to the
per-request path, and each request is still charged its own modeled edge
time. A ``serve`` call queues all its requests before the stages start,
so a call of at most ``micro_batch`` requests is one drained group.

PyTorch's grad mode is per thread; every stage's tensor work runs inside
the runners' ``torch.no_grad()`` methods.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional, Tuple

from repro_torch.core.adaptation import AdaptationController, AdaptationEvent
from repro_torch.core.decoupler import DecoupledPlan, JaladEngine
from repro_torch.core.latency import PNG_RATIO
from repro_torch.serving.edge_cloud import RunnerCache

_SHUTDOWN = object()


@dataclass
class StageTimeline:
    """Simulated-clock occupancy of one request across the three stages."""

    arrival_s: float = 0.0
    edge_start: float = 0.0
    edge_end: float = 0.0
    xfer_start: float = 0.0
    xfer_end: float = 0.0
    cloud_start: float = 0.0
    cloud_end: float = 0.0
    bytes_sent: int = 0
    plan_point: int = -1
    plan_bits: int = 0
    plan_codec: str = ""

    @property
    def latency_s(self) -> float:
        """Request latency including pipeline queueing."""
        return self.cloud_end - self.arrival_s

    @property
    def service_s(self) -> float:
        """Pure service time (what the synchronous server would charge)."""
        return ((self.edge_end - self.edge_start)
                + (self.xfer_end - self.xfer_start)
                + (self.cloud_end - self.cloud_start))


@dataclass
class PipelineRequest:
    uid: int
    batch: Any
    bandwidth: float                 # true link bandwidth for this transfer
    arrival_s: float = 0.0
    # Filled by the pipeline:
    logits: Any = None
    plan: Optional[DecoupledPlan] = None
    timeline: StageTimeline = field(default_factory=StageTimeline)
    encode_group: int = 0            # requests in its batched encode
    blob: Any = None                 # its WireBlob (None when cloud-only)
    # In-flight payload between stages:
    _extras: Any = None


@dataclass
class PipelinedEdgeCloudServer:
    """3-stage asynchronous edge-cloud pipeline over one JaladEngine."""

    engine: JaladEngine
    params: Any
    controller: Optional[AdaptationController] = None
    runners: Optional[RunnerCache] = None
    # Max queued requests the edge stage drains into one batched encode.
    micro_batch: int = 4
    adaptation_log: List[Tuple[float, AdaptationEvent]] = field(
        default_factory=list)
    completed: List[PipelineRequest] = field(default_factory=list)

    def __post_init__(self):
        if self.controller is None:
            self.controller = AdaptationController(self.engine)
        if self.runners is None:
            self.runners = RunnerCache(self.engine, self.params)
        self._edge_q: "queue.Queue" = queue.Queue()
        self._link_q: "queue.Queue" = queue.Queue()
        self._cloud_q: "queue.Queue" = queue.Queue()
        self._edge_free = 0.0          # simulated busy_until per stage
        self._link_free = 0.0
        self._cloud_free = 0.0
        self._stage_error: Optional[BaseException] = None
        self._window: List[PipelineRequest] = []   # latest serve() stream
        # Re-decoupling hook: build the incoming plan's runner and
        # timestamp the switch on the simulated clock.
        self.controller.add_listener(self._on_replan)

    # -------------------------------------------------------------- hooks
    def _on_replan(self, event: AdaptationEvent) -> None:
        self.adaptation_log.append((self._edge_free, event))
        if not event.new_plan.is_cloud_only:
            self.runners.get(event.new_plan)

    def _run_stage(self, worker, out_q: Optional["queue.Queue"]) -> None:
        """Run one stage loop; on an exception, record it and push
        _SHUTDOWN downstream so the pipeline drains (serve() re-raises)."""
        try:
            worker()
        except BaseException as e:   # noqa: BLE001 — re-raised in serve()
            if self._stage_error is None:
                self._stage_error = e
            if out_q is not None:
                out_q.put(_SHUTDOWN)

    # ------------------------------------------------------------- stages
    def _drain_group(self, first: PipelineRequest):
        """Drain up to ``micro_batch`` queued requests without blocking.
        Returns (group, saw_shutdown)."""
        group = [first]
        while len(group) < max(self.micro_batch, 1):
            try:
                nxt = self._edge_q.get_nowait()
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                return group, True
            group.append(nxt)
        return group, False

    def _edge_worker(self) -> None:
        space = self.engine.plan_space
        shutdown = False
        while not shutdown:
            req = self._edge_q.get()
            if req is _SHUTDOWN:
                break
            group, shutdown = self._drain_group(req)
            # Per-request decisions: the unbatched decision sequence.
            for r in group:
                r.plan = self.controller.current_plan()
                r.timeline.arrival_s = r.arrival_s
            # One batched encode per run of consecutive same-plan requests
            # (current_plan returns the same plan object until a switch).
            i = 0
            while i < len(group):
                r = group[i]
                if r.plan.is_cloud_only:
                    r.blob = None      # the input image ships to the link
                    i += 1
                    continue
                j = i + 1
                while j < len(group) and group[j].plan is r.plan:
                    j += 1
                run = group[i:j]
                runner = self.runners.get(r.plan)
                if len(run) == 1:
                    results = [runner.edge_step(r.batch)]
                else:
                    results = runner.edge_step_batch([g.batch for g in run])
                for g, (blob, extras) in zip(run, results):
                    g.blob, g._extras = blob, extras
                    g.encode_group = len(run)
                i = j
            # Simulated-clock accounting + handoff, in arrival order.
            for r in group:
                tl = r.timeline
                edge_t, _ = space.stage_times(r.plan)
                tl.edge_start = max(r.arrival_s, self._edge_free)
                tl.edge_end = tl.edge_start + edge_t
                self._edge_free = tl.edge_end
                self._link_q.put(r)
        self._link_q.put(_SHUTDOWN)

    def _link_worker(self) -> None:
        space = self.engine.plan_space
        while True:
            req = self._link_q.get()
            if req is _SHUTDOWN:
                self._cloud_q.put(_SHUTDOWN)
                return
            tl = req.timeline
            if req.plan.is_cloud_only:
                nbytes = int(space.input_bytes * PNG_RATIO)
            else:
                nbytes = req.blob.nbytes
            transfer_t = nbytes / req.bandwidth
            tl.xfer_start = max(tl.edge_end, self._link_free)
            tl.xfer_end = tl.xfer_start + transfer_t
            self._link_free = tl.xfer_end
            tl.bytes_sent = nbytes
            # Live bandwidth estimate for the adaptation controller.
            self.controller.observe_transfer(max(nbytes, 1),
                                             max(transfer_t, 1e-9))
            self._cloud_q.put(req)

    def _cloud_worker(self) -> None:
        space = self.engine.plan_space
        while True:
            req = self._cloud_q.get()
            if req is _SHUTDOWN:
                return
            plan = req.plan
            tl = req.timeline
            _, cloud_t = space.stage_times(plan)
            if plan.is_cloud_only:
                req.logits = self.runners.full_forward(req.batch)
            else:
                runner = self.runners.get(plan)
                req.logits = runner.cloud_step(req.blob, req._extras)
            tl.cloud_start = max(tl.xfer_end, self._cloud_free)
            tl.cloud_end = tl.cloud_start + cloud_t
            self._cloud_free = tl.cloud_end
            tl.plan_point = plan.point
            tl.plan_bits = plan.bits
            tl.plan_codec = plan.codec if not plan.is_cloud_only else "png"
            req._extras = None
            self.completed.append(req)

    # -------------------------------------------------------------- public
    def serve(self, requests: Iterable[PipelineRequest],
              timeout_s: float = 600.0) -> List[PipelineRequest]:
        """Run a request stream through the pipeline; blocks until every
        request has drained and returns them in completion order."""
        reqs = list(requests)
        for req in reqs:
            self._edge_q.put(req)
        self._edge_q.put(_SHUTDOWN)
        threads = [
            threading.Thread(target=self._run_stage, args=(w, out_q),
                             daemon=True, name=n)
            for w, n, out_q in [
                (self._edge_worker, "jalad-edge", self._link_q),
                (self._link_worker, "jalad-link", self._cloud_q),
                (self._cloud_worker, "jalad-cloud", None),
            ]
        ]
        n0 = len(self.completed)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise TimeoutError(f"pipeline stage {t.name} did not drain")
        if self._stage_error is not None:
            err, self._stage_error = self._stage_error, None
            raise err
        self._window = self.completed[n0:]
        return self._window

    # ----------------------------------------------------------- reporting
    # Both metrics cover the latest serve() stream.
    @property
    def makespan_s(self) -> float:
        """Simulated time from first arrival to last cloud finish of the
        latest serve() stream."""
        window = self._window
        if not window:
            return 0.0
        start = min(r.timeline.arrival_s for r in window)
        return max(r.timeline.cloud_end for r in window) - start

    def synchronous_time_s(self) -> float:
        """What the latest serve() stream costs without overlap: the sum of
        per-request service times (the EdgeCloudServer accounting)."""
        return sum(r.timeline.service_s for r in self._window)
