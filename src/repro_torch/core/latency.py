"""Execution-latency model (paper Sec. III-D / IV-A).

Edge and cloud execution times follow the paper's FMAC model
``T = w * Q / F`` (Sec. IV-A: this linear approximation is credible since
FMACs take >90% of execution time). Transmission is ``S_i(c) / BW``.

``LatencyModel`` produces the {T_E_i}, {T_C_i} vectors the ILP consumes,
plus the paper's baselines (Origin2Cloud / PNG2Cloud / JPEG2Cloud).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.config.types import DeviceProfile

# Reference compressed-image ratios vs 24-bit raw RGB (paper Sec. I uses a
# ~2.4 MB raw -> ~1 MB PNG example; JPEG is far smaller).
PNG_RATIO = 0.42
JPEG_RATIO = 0.10


def _freeze(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@dataclass(frozen=True)
class CloudMeshModel:
    """Mesh-parallel scaling of the cloud side of the objective.

    The paper assumes a single "conventional cloud" device; a meshed cloud
    tail runs the post-cut layers SPMD across M
    devices. The planner models that as

        T_C^mesh(i) = T_C(i) / M  +  collective_s_per_point * (N - 1 - i)

    — ideal compute scaling plus one per-remaining-layer collective term
    (tensor-parallel layers all-reduce their activations once per layer;
    ``from_interconnect`` prices that as a ring all-reduce of the boundary
    activation over the mesh interconnect). The M = 1, coll = 0 default is
    bitwise-identical to the unmeshed model (``x / 1.0`` and ``x + 0.0``
    preserve every float64 bit for non-negative times), which is what lets
    ``PlanSpace.with_cloud_mesh`` stay oracle-pinned at mesh size 1.
    """

    n_devices: int = 1
    collective_s_per_point: float = 0.0

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("cloud mesh needs at least one device")
        if self.collective_s_per_point < 0:
            raise ValueError("collective term must be non-negative")

    @classmethod
    def from_interconnect(cls, n_devices: int, activation_bytes: float,
                          ici_bytes_per_s: float) -> "CloudMeshModel":
        """Price the per-layer collective as a ring all-reduce of one
        activation-sized tensor: 2 (M-1)/M * bytes / link_BW."""
        m = int(n_devices)
        if m <= 1:
            return cls(max(m, 1), 0.0)
        coll = 2.0 * (m - 1) / m * float(activation_bytes) / float(
            ici_bytes_per_s)
        return cls(m, coll)


@dataclass
class LatencyModel:
    """Latency bookkeeping for one model on one (edge, cloud, BW) setup.

    The cumulative-FMAC profile and the {T_E_i}, {T_C_i} vectors are
    computed once and cached (read-only): ``edge_times``/``cloud_times``
    sit on the adaptation hot path, where recomputing ``np.cumsum`` plus a
    per-point ``exec_time`` python loop on every call dominated re-solve
    cost. The cached arrays are immutable so callers can share them."""

    fmacs_per_point: Sequence[float]     # layer i's own FMACs (batch included)
    edge: DeviceProfile
    cloud: DeviceProfile
    input_bytes: float                   # raw input size (batch included)
    _cum_fmacs: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False)
    _edge_times: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False)
    _cloud_times: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False)

    # ------------------------------------------------------------------
    @property
    def n_points(self) -> int:
        return len(self.fmacs_per_point)

    @property
    def cum_fmacs(self) -> np.ndarray:
        """Cumulative FMACs through each decoupling point (cached)."""
        if self._cum_fmacs is None:
            self._cum_fmacs = _freeze(
                np.cumsum(np.asarray(self.fmacs_per_point, np.float64))
            )
        return self._cum_fmacs

    @property
    def total_fmacs(self) -> float:
        cum = self.cum_fmacs
        return float(cum[-1]) if cum.size else 0.0

    def edge_times(self) -> np.ndarray:
        """T_E_i: run layers 1..i on the edge (cumulative, cached)."""
        if self._edge_times is None:
            self._edge_times = _freeze(
                np.array([self.edge.exec_time(q) for q in self.cum_fmacs])
            )
        return self._edge_times

    def cloud_times(self) -> np.ndarray:
        """T_C_i: run layers i+1..N on the cloud (cached)."""
        if self._cloud_times is None:
            total = self.total_fmacs
            self._cloud_times = _freeze(np.array(
                [self.cloud.exec_time(total - q) for q in self.cum_fmacs]
            ))
        return self._cloud_times

    def trans_times(self, size_table: np.ndarray, bandwidth: float
                    ) -> np.ndarray:
        """T_trans[i, c] = S_i(c) / BW."""
        return np.asarray(size_table, np.float64) / float(bandwidth)

    # ----------------------------------------------------------- baselines
    def cloud_only_time(self, bandwidth: float, image_ratio: float = 1.0
                        ) -> float:
        """Upload (possibly image-compressed) input, run everything on the
        cloud. image_ratio=1 -> Origin2Cloud; PNG_RATIO -> PNG2Cloud."""
        upload = self.input_bytes * image_ratio / bandwidth
        compute = self.cloud.exec_time(self.total_fmacs)
        return upload + compute

    def edge_only_time(self) -> float:
        return self.edge.exec_time(self.total_fmacs)
