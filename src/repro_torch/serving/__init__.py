"""Serving runtimes of the port: the synchronous edge-cloud server, the
pipelined server, the fleet server (many edges, one shared cloud) with
its trace-shaped workloads, and the three-tier server (devices, one shared
edge server, one cloud)."""
from repro_torch.serving.edge_cloud import (
    EdgeCloudServer,
    LatencyBreakdown,
    RunnerCache,
    build_edge_cloud_server,
)
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

__all__ = [
    "EdgeCloudServer",
    "FleetDevice",
    "FleetRequest",
    "FleetServer",
    "FleetTrace",
    "LatencyBreakdown",
    "PipelineRequest",
    "PipelinedEdgeCloudServer",
    "RunnerCache",
    "StageTimeline",
    "ThreeTierServer",
    "TriStageTimeline",
    "bandwidth_walks",
    "build_edge_cloud_server",
    "build_fleet_server",
    "build_three_tier_server",
    "diurnal_rates",
    "make_trace",
]
