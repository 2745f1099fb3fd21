"""Serving runtimes of the port: sessions and continuous batching for the
decoders (KV caches and recurrent states), token streaming across a
JALAD cut, the synchronous edge-cloud server, the pipelined server, the
fleet server (many edges, one shared cloud) with its trace-shaped
workloads, the three-tier server (devices, one shared edge server, one
cloud), and the meshed cloud worker with its fake-tensor tail report."""
from repro_torch.serving.engine import Request, RequestScheduler, ServeSession
from repro_torch.serving.scheduler import ContinuousBatchingEngine, GenRequest
from repro_torch.serving.edge_cloud import (
    EdgeCloudServer,
    LatencyBreakdown,
    RunnerCache,
    Servable,
    build_edge_cloud_server,
)
from repro_torch.serving.streaming import TokenStreamSession, step_stream_group
from repro_torch.serving.pipeline import (
    PipelinedEdgeCloudServer,
    PipelineRequest,
    StageTimeline,
)
from repro_torch.serving.fleet import (
    FleetDevice,
    FleetRequest,
    FleetServer,
    build_fleet_server,
)
from repro_torch.serving.meshed import MeshedCloudWorker, aot_tail_report
from repro_torch.serving.three_tier import (
    ThreeTierServer,
    TriStageTimeline,
    build_three_tier_server,
)
from repro_torch.serving.workloads import (
    FleetTrace,
    bandwidth_walks,
    diurnal_rates,
    make_trace,
)

# The reference's public names; the port's own (the three-tier server and
# the two server factories) stay importable by name.
__all__ = [
    "ContinuousBatchingEngine",
    "EdgeCloudServer",
    "FleetDevice",
    "FleetRequest",
    "FleetServer",
    "FleetTrace",
    "GenRequest",
    "LatencyBreakdown",
    "MeshedCloudWorker",
    "PipelineRequest",
    "PipelinedEdgeCloudServer",
    "Request",
    "RequestScheduler",
    "RunnerCache",
    "Servable",
    "ServeSession",
    "StageTimeline",
    "TokenStreamSession",
    "aot_tail_report",
    "bandwidth_walks",
    "build_fleet_server",
    "diurnal_rates",
    "make_trace",
    "step_stream_group",
]
