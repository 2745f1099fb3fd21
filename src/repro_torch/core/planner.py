"""The vectorized decoupling planner: one implementation of

    Z(i, c, k, BW) = T_E(i) + S_i(c, k) / BW + T_C(i)

:class:`PlanSpace` precomputes every bandwidth-independent part of the
objective once (the T_E / T_C vectors at the table rows, the S and A
tables over the flattened (bits, codec) choice axis, the accuracy-budget
mask folded into ``base`` as +inf), so re-deciding under a new bandwidth
is the single fused numpy op ``argmin(base + size_flat / BW)``.

**Units.** Every term is per *calibration batch*: ``size_flat`` holds
``PredictorTables.size_bytes`` (mean wire bytes of a full batch
boundary), ``input_bytes`` the raw bytes of the same batch input, and the
FMAC time vectors include the batch factor.

The port's own copy of the reference's ``PlanSpace``, kept float64
bit-identical so both packages decide the same plans from the same
tables; the enumeration and branch-and-bound solvers of
:mod:`repro_torch.core.ilp` stay as cross-checked oracles. The streaming,
fleet and three-tier extensions are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.types import DeviceProfile
from repro_torch.core.ilp import ILPProblem, ILPSolution
from repro_torch.core.latency import CloudMeshModel, LatencyModel, _freeze

if TYPE_CHECKING:  # runtime import would cycle (decoupler imports planner)
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.core.predictor import PredictorTables


_PLAN_CLS = None


def _plan_cls():
    # Cached lazy import: decoupler imports planner at module scope.
    global _PLAN_CLS
    if _PLAN_CLS is None:
        from repro_torch.core.decoupler import DecoupledPlan

        _PLAN_CLS = DecoupledPlan
    return _PLAN_CLS


_INF = float("inf")


def _readonly(a: np.ndarray) -> np.ndarray:
    # Contiguous float64 + frozen: every view reads identical float64 bits.
    return _freeze(np.ascontiguousarray(a, dtype=np.float64))


@dataclass(frozen=True, eq=False)
class PlanSpace:
    """Precomputed decision space over the flattened (point, bits, codec)
    grid for one (edge, cloud) device pair.

    All arrays are read-only and shared freely between views; ``with_edge``
    replaces only the edge-dependent ones. ``eq=False``: identity
    semantics — a generated ``__eq__``/``__hash__`` over ndarray fields
    would raise on comparison/hashing, and views are meant to be compared
    by ``is`` anyway.
    """

    point_rows: Tuple[int, ...]        # table row -> model point index
    bits_choices: Tuple[int, ...]
    codecs: Tuple[str, ...]
    budget: float
    edge: DeviceProfile
    cloud: DeviceProfile
    cum_fmacs: np.ndarray              # (N,) cumulative FMACs at each row
    total_fmacs: float
    input_bytes: float                 # raw input bytes PER BATCH
    edge_vec: np.ndarray               # (N,) T_E_i at each row
    cloud_vec: np.ndarray              # (N,) T_C_i at each row
    size_flat: np.ndarray              # (N, C*K) wire bytes PER BATCH
    acc_flat: np.ndarray               # (N, C*K) accuracy drop
    feasible: np.ndarray               # (N, C*K) bool, acc <= budget
    # Mesh-parallel cloud model (see with_cloud_mesh). cloud_vec above is
    # ALWAYS the meshed vector (identity at the default M=1, coll=0);
    # cloud_vec_single keeps the single-device vector so meshed views can
    # be re-derived without compounding.
    cloud_mesh: CloudMeshModel = CloudMeshModel()
    n_model_points: int = 0            # total decoupling points of the model
    cloud_vec_single: np.ndarray = field(repr=False, default=None)
    # Fused-argmin operands: base = edge + cloud, +inf where infeasible
    # (size_flat/BW is finite, so an infeasible cell can never win).
    base: np.ndarray = field(repr=False, default=None)
    # Unmasked edge+cloud — used to rebuild the oracle ILPProblem with
    # bitwise-identical costs to the pre-planner engine.
    base_raw: np.ndarray = field(repr=False, default=None)
    _row_of_point: Dict[int, int] = field(repr=False, default=None)

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, tables: "PredictorTables", latency: LatencyModel,
              budget: float,
              point_indices: Optional[Sequence[int]] = None) -> "PlanSpace":
        rows = (list(point_indices) if point_indices is not None
                else list(range(len(tables.points))))
        n = len(rows)
        edge_vec = _readonly(latency.edge_times()[rows])
        cloud_vec = _readonly(latency.cloud_times()[rows])
        cum = _readonly(latency.cum_fmacs[rows])
        size_flat = _readonly(tables.size_bytes.reshape(n, -1))
        acc_flat = _readonly(tables.acc_drop.reshape(n, -1))
        return cls(
            point_rows=tuple(rows),
            bits_choices=tuple(tables.bits_choices),
            codecs=tuple(tables.codecs),
            budget=float(budget),
            edge=latency.edge,
            cloud=latency.cloud,
            cum_fmacs=cum,
            total_fmacs=latency.total_fmacs,
            input_bytes=float(latency.input_bytes),
            edge_vec=edge_vec,
            cloud_vec=cloud_vec,
            size_flat=size_flat,
            acc_flat=acc_flat,
            feasible=acc_flat <= float(budget),
            n_model_points=latency.n_points,
        ).finalize()

    def finalize(self) -> "PlanSpace":
        """Derive the cached argmin operands; returns self for chaining."""
        if self.cloud_vec_single is None:
            object.__setattr__(self, "cloud_vec_single", self.cloud_vec)
        base_raw = self.edge_vec[:, None] + self.cloud_vec[:, None]
        base_raw = np.broadcast_to(base_raw, self.size_flat.shape)
        base = np.where(self.feasible, base_raw, np.inf)
        base.flags.writeable = False
        object.__setattr__(self, "base_raw", _readonly(base_raw))
        object.__setattr__(self, "base", base)
        object.__setattr__(
            self, "_row_of_point",
            {p: r for r, p in enumerate(self.point_rows)},
        )
        return self

    def with_edge(self, edge: DeviceProfile) -> "PlanSpace":
        """A per-device view: same size/accuracy tables, same cloud vector,
        new edge-time vector derived from the shared cumulative FMACs. This
        is how a heterogeneous fleet shares one PlanSpace."""
        edge_vec = _readonly(
            np.array([edge.exec_time(q) for q in self.cum_fmacs])
        )
        return replace(self, edge=edge, edge_vec=edge_vec,
                       base=None, base_raw=None,
                       _row_of_point=None).finalize()

    def with_cloud_mesh(self, mesh: CloudMeshModel) -> "PlanSpace":
        """A mesh-aware view: same tables, same edge vector, cloud-time
        vector rescaled by the mesh model

            T_C^mesh(i) = T_C(i) / M + coll * (layers after i)

        (ideal M-way compute scaling + one collective per remaining
        layer). Derived from ``cloud_vec_single`` so meshed views never
        compound, and bitwise-identical to the unmeshed space at
        ``CloudMeshModel(1, 0.0)`` — ``x / 1.0`` and ``x + 0.0 * n``
        preserve the float64 bits of non-negative times."""
        n_total = self.n_model_points or (
            max(self.point_rows) + 1 if self.point_rows else 0)
        remaining = (float(n_total) - 1.0
                     - np.asarray(self.point_rows, dtype=np.float64))
        vec = (self.cloud_vec_single / float(mesh.n_devices)
               + float(mesh.collective_s_per_point) * remaining)
        return replace(self, cloud_mesh=mesh, cloud_vec=_readonly(vec),
                       base=None, base_raw=None,
                       _row_of_point=None).finalize()

    def cloud_exec_full(self) -> float:
        """Full-network cloud execution time under the mesh model — the
        T_C term of the cloud-only fallback. Identity at mesh size 1."""
        m = self.cloud_mesh
        return (self.cloud.exec_time(self.total_fmacs) / float(m.n_devices)
                + float(m.collective_s_per_point) * float(
                    self.n_model_points or len(self.point_rows)))

    # ------------------------------------------------------------ queries
    @property
    def n_choices(self) -> int:
        return self.size_flat.shape[1]

    def _unflatten(self, j: int) -> Tuple[int, int]:
        return divmod(j, len(self.codecs))

    def row_of_point(self, point: int) -> int:
        return self._row_of_point[point]

    def cloud_only_time(self, bandwidth: float,
                        image_ratio: float = 1.0) -> float:
        """Z of the no-decoupling fallback (upload input, run everything on
        the cloud) — the paper's x_{NC} = 1 worst case. ``input_bytes`` is
        per-batch, the same unit as the ``size_flat`` wire bytes, so this
        is directly comparable against every decoupled cell."""
        return (self.input_bytes * image_ratio / float(bandwidth)
                + self.cloud_exec_full())

    def stage_times(self, plan: "DecoupledPlan") -> Tuple[float, float]:
        """(T_E, T_C) of a concrete plan — the single lookup the serving
        runtimes use for simulated-clock accounting. Cloud-only plans run
        the whole network on the cloud."""
        if plan.is_cloud_only:
            return 0.0, self.cloud_exec_full()
        row = self._row_of_point.get(plan.point)
        if row is None:
            raise KeyError(
                f"plan point {plan.point} is not one of this PlanSpace's "
                f"decoupling rows {list(self.point_rows)} — plans must come "
                "from the same decision space that serves them"
            )
        return float(self.edge_vec[row]), float(self.cloud_vec[row])

    def plan_cost(self, plan: "DecoupledPlan", bandwidth: float) -> float:
        """Z(i, c, k, BW) of a concrete plan at a concrete bandwidth — THE
        cost implementation (the adaptation controller's hysteresis check
        and everything else routes through here)."""
        if plan.is_cloud_only:
            return self.cloud_only_time(bandwidth)
        row = self._row_of_point[plan.point]
        j = (self.bits_choices.index(plan.bits) * len(self.codecs)
             + self.codecs.index(plan.codec))
        return float(
            self.edge_vec[row] + self.cloud_vec[row]
            + self.size_flat[row, j] / float(bandwidth)
        )

    # ----------------------------------------------------------- deciding
    def cloud_only_plan(self, bandwidth: float,
                        solve_ms: float = 0.0) -> "DecoupledPlan":
        return _plan_cls()(-1, 0, self.cloud_only_time(bandwidth),
                           0.0, solve_ms)

    def decide(self, bandwidth: float) -> "DecoupledPlan":
        """Re-solve the decision under a new bandwidth: one fused
        ``argmin(base + size/BW)`` over the precomputed grid. This is the
        re-plan hot path — flat indexing and python divmod keep it free of
        numpy bookkeeping beyond the two array ops and the argmin."""
        t0 = time.perf_counter()
        # NB: true division, not multiply-by-reciprocal — the oracle
        # ILPProblem divides, and the cross-checks assert bitwise equality
        # (the in-place add is safe: float a+b is commutative bitwise).
        cost = self.size_flat / float(bandwidth)
        cost += self.base
        j = int(cost.argmin())
        best = float(cost.flat[j])
        ms = (time.perf_counter() - t0) * 1e3
        if best == _INF:
            return self.cloud_only_plan(bandwidth, ms)
        n_codecs = len(self.codecs)
        i, jj = divmod(j, cost.shape[1])
        ci, ki = divmod(jj, n_codecs)
        return _plan_cls()(
            point=self.point_rows[i],
            bits=self.bits_choices[ci],
            predicted_latency=best,
            predicted_acc_drop=float(self.acc_flat.flat[j]),
            solve_ms=ms,
            codec=self.codecs[ki],
        )

    # ------------------------------------------------------------ oracles
    def ilp_problem(self, bandwidth: float) -> ILPProblem:
        """Materialize the exact selection problem the ILP solvers consume
        (costs bitwise-identical to the pre-planner engine's tables) — the
        cross-check path for ``solve_enumeration``/``solve_branch_and_bound``."""
        return ILPProblem(
            self.base_raw + self.size_flat / float(bandwidth),
            np.asarray(self.acc_flat), self.budget,
        )

    def plan_from_solution(self, sol: ILPSolution) -> "DecoupledPlan":
        """Convert an oracle solver's solution into a DecoupledPlan."""
        ci, ki = self._unflatten(sol.bits_index)
        return _plan_cls()(
            point=self.point_rows[sol.point],
            bits=self.bits_choices[ci],
            predicted_latency=sol.objective,
            predicted_acc_drop=float(self.acc_flat[sol.point, sol.bits_index]),
            solve_ms=sol.solve_ms,
            codec=self.codecs[ki],
        )


__all__: List[str] = ["PlanSpace"]
