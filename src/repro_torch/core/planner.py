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
:mod:`repro_torch.core.ilp` stay as cross-checked oracles.

Fleet serving builds on ``with_edge``: the size/accuracy tables and the
cloud vector are device-independent, so :class:`FleetPlanSpace` stacks D
heterogeneous edge devices over one shared ``PlanSpace``, and its
``decide_all(bandwidths)`` re-plans the whole fleet in one fused op,
bitwise-equal to D independent ``with_edge(p).decide(bw)`` calls. The
three-tier extension is :mod:`repro_torch.core.tri_planner`; the streaming
one is not ported yet.
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

    def with_streaming(self, d_model: int,
                       tokens_per_batch: float) -> "StreamPlanTerms":
        """Extend this space with the per-token steady-state term for
        autoregressive token streaming (see :class:`StreamPlanTerms`)."""
        return StreamPlanTerms.build(self, d_model, tokens_per_batch)


# ---------------------------------------------------------------------------
# Token-streaming decision: prefill + E[tokens] * steady-state term
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class StreamPlanTerms:
    """Per-token steady-state extension of one :class:`PlanSpace`.

    Token streaming pays the wire *every decode step*, so the objective
    becomes (Edgent, arXiv:1806.07840, re-priced per step)

        Z_stream = Z_prefill(i,c,k,BW)
                 + E[tokens] * (t_E(i) + bytes_tok(c,k)/BW + t_C(i))

    where ``t_E``/``t_C`` are per-*token* stage times (the batch-unit
    FMAC vectors divided by ``tokens_per_batch``) and ``bytes_tok`` is the
    stream-frame wire size of one ``(1, 1, d_model)`` boundary row: the
    codec's shape-only size minus the 1-byte bits tag that the session's
    ``StreamHeader`` amortizes away (an upper bound for entropy codecs).

    ``decide`` stays one fused argmin; ``ilp_problem`` materializes the
    same costs for the enumeration / branch-and-bound oracles. The float64
    expressions are the reference's, op for op.
    """

    space: PlanSpace
    d_model: int
    tokens_per_batch: float
    token_bytes: np.ndarray            # (C*K,) stream-frame bytes per token

    @classmethod
    def build(cls, space: PlanSpace, d_model: int,
              tokens_per_batch: float) -> "StreamPlanTerms":
        if tokens_per_batch <= 0:
            raise ValueError("tokens_per_batch must be positive")
        from repro_torch.codec import get_codec  # lazy: codec imports core

        shape = (1, 1, int(d_model))
        k = len(space.codecs)
        tb = np.empty(space.n_choices, dtype=np.float64)
        for j in range(space.n_choices):
            ci, ki = divmod(j, k)
            tb[j] = float(
                get_codec(space.codecs[ki]).wire_size_bytes(
                    shape, space.bits_choices[ci])) - 1.0
        return cls(space=space, d_model=int(d_model),
                   tokens_per_batch=float(tokens_per_batch),
                   token_bytes=_readonly(tb))

    # ------------------------------------------------------------- costs
    def _steady_extra(self, bandwidth: float,
                      expected_tokens: float) -> np.ndarray:
        """(N, C*K) matrix of E[tokens] * per-token steady-state cost."""
        sp = self.space
        extra = (sp.edge_vec + sp.cloud_vec)[:, None] / self.tokens_per_batch
        extra = extra + self.token_bytes[None, :] / float(bandwidth)
        extra = extra * float(expected_tokens)
        return extra

    def token_time(self, plan: "DecoupledPlan", bandwidth: float) -> float:
        """Steady-state seconds per generated token under a concrete plan:
        what the serving session's simulated clock charges a step."""
        sp = self.space
        if plan.is_cloud_only:
            return (4.0 / float(bandwidth)
                    + sp.cloud_exec_full() / self.tokens_per_batch)
        row = sp.row_of_point(plan.point)
        j = (sp.bits_choices.index(plan.bits) * len(sp.codecs)
             + sp.codecs.index(plan.codec))
        return float(
            (sp.edge_vec[row] + sp.cloud_vec[row]) / self.tokens_per_batch
            + self.token_bytes[j] / float(bandwidth)
        )

    def cloud_only_stream_time(self, bandwidth: float,
                               expected_tokens: float) -> float:
        """Z_stream of the no-decoupling fallback: upload the input, run
        everything on the cloud, then stream one 4-byte token id back per
        step (the boundary never crosses the link)."""
        sp = self.space
        per_tok = (4.0 / float(bandwidth)
                   + sp.cloud_exec_full() / self.tokens_per_batch)
        return sp.cloud_only_time(bandwidth) + float(expected_tokens) * per_tok

    def cloud_only_plan(self, bandwidth: float, expected_tokens: float,
                        solve_ms: float = 0.0) -> "DecoupledPlan":
        return _plan_cls()(
            -1, 0, self.cloud_only_stream_time(bandwidth, expected_tokens),
            0.0, solve_ms)

    # ----------------------------------------------------------- deciding
    def decide(self, bandwidth: float,
               expected_tokens: float) -> "DecoupledPlan":
        """One fused ``argmin(base + size/BW + E * steady)`` over the
        same precomputed grid as :meth:`PlanSpace.decide`."""
        t0 = time.perf_counter()
        sp = self.space
        cost = sp.size_flat / float(bandwidth)
        cost += sp.base
        cost += self._steady_extra(bandwidth, expected_tokens)
        j = int(cost.argmin())
        best = float(cost.flat[j])
        ms = (time.perf_counter() - t0) * 1e3
        if best == _INF:
            return self.cloud_only_plan(bandwidth, expected_tokens, ms)
        i, jj = divmod(j, cost.shape[1])
        ci, ki = divmod(jj, len(sp.codecs))
        return _plan_cls()(
            point=sp.point_rows[i],
            bits=sp.bits_choices[ci],
            predicted_latency=best,
            predicted_acc_drop=float(sp.acc_flat.flat[j]),
            solve_ms=ms,
            codec=sp.codecs[ki],
        )

    # ------------------------------------------------------------ oracles
    def ilp_problem(self, bandwidth: float,
                    expected_tokens: float) -> ILPProblem:
        """The exact streaming selection problem for the enumeration /
        branch-and-bound oracles (cell costs equal :meth:`decide`'s)."""
        sp = self.space
        cost = sp.base_raw + sp.size_flat / float(bandwidth)
        cost = cost + self._steady_extra(bandwidth, expected_tokens)
        return ILPProblem(cost, np.asarray(sp.acc_flat), sp.budget)

    def plan_from_solution(self, sol: ILPSolution) -> "DecoupledPlan":
        return self.space.plan_from_solution(sol)


# ---------------------------------------------------------------------------
# Fleet decision plane: D devices, one fused re-plan
# ---------------------------------------------------------------------------

# Devices per argmin chunk. The scratch working set is 2 * CHUNK * N floats
# (~3 MB at N=50) — small enough to stay cache-resident, so the per-device
# cost of decide_all is flat in D instead of falling off a RAM cliff at
# 10^5 devices.
_FLEET_CHUNK = 4096


@dataclass(frozen=True, eq=False)
class FleetDecision:
    """All D plans of one ``decide_all`` call, held as arrays.

    ``flat_j[d]`` is the winning cell of device d on the flattened
    (N, C·K) grid (-1 = cloud-only fallback) and ``cost[d]`` its
    predicted latency — bitwise-identical to what the per-device
    ``PlanSpace.with_edge(p).decide(bw)`` oracle returns. ``plan(d)``
    materializes the matching :class:`DecoupledPlan` on demand, so a
    10^5-device re-plan never builds 10^5 Python objects unless asked.
    """

    fleet: "FleetPlanSpace"
    bandwidths: np.ndarray            # (D,) the bandwidths decided under
    flat_j: np.ndarray                # (D,) int64 cell index, -1 cloud-only
    cost: np.ndarray                  # (D,) predicted latency Z
    solve_ms: float = 0.0

    def __len__(self) -> int:
        return int(self.flat_j.shape[0])

    def plan(self, d: int) -> "DecoupledPlan":
        space = self.fleet.space
        j = int(self.flat_j[d])
        if j < 0:
            return _plan_cls()(-1, 0, float(self.cost[d]), 0.0,
                               self.solve_ms)
        i, jj = divmod(j, space.n_choices)
        ci, ki = divmod(jj, len(space.codecs))
        return _plan_cls()(
            point=space.point_rows[i],
            bits=space.bits_choices[ci],
            predicted_latency=float(self.cost[d]),
            predicted_acc_drop=float(space.acc_flat[i, jj]),
            solve_ms=self.solve_ms,
            codec=space.codecs[ki],
        )

    def plans(self) -> List["DecoupledPlan"]:
        return [self.plan(d) for d in range(len(self))]


@dataclass(frozen=True, eq=False)
class FleetPlanSpace:
    """One shared :class:`PlanSpace` stacked across D edge devices.

    ``with_edge`` generalized from one profile to D profiles: the
    size/accuracy tables, cloud vector and cumulative-FMAC profile are
    shared by identity; per-device state is two ``(D,)`` scalars
    (``w``, ``flops``) plus the derived ``(D, N)`` edge-time matrix.
    ``decide_all(bandwidths)`` is the fleet-wide re-plan — one fused
    ``argmin(base + size/BW)`` over the ``(D, N·C·K)`` decision grid,
    returning all D plans at once.

    **Exactness.** The (C·K) choice axis enters the objective only
    through ``size_flat / BW`` (+the feasibility mask): with BW > 0 the
    per-row argmin over columns is bandwidth-independent, so it is
    hoisted to build time (``j_star``/``s_star``) and the runtime op is
    an ``argmin`` over ``(D, N)`` — the same argmin over the same float64
    bits, factored. Per-device ties resolve to the lowest flat index in
    both forms, so ``decide_all`` agrees *bitwise* with D independent
    ``PlanSpace.with_edge(p).decide(bw)`` calls, and with the
    reference's ``FleetPlanSpace`` (``tests/test_torch_fleet_planner.py``).

    **Memory shape.** The edge term is recomputed on the fly inside the
    argmin from the ``(D,)`` device scalars (cache-resident chunks)
    instead of streaming a precomputed ``(D, N)`` matrix from RAM — that
    keeps the per-device cost flat to 10^5 devices. The stacked
    ``edge_mat`` is still materialized (lazily) for the O(1)-per-device
    gathers: ``stage_times_all``, ``plan_cost_all`` and the per-device
    object views.
    """

    space: PlanSpace
    profiles: Tuple[DeviceProfile, ...]   # may be empty for array-built fleets
    w_vec: np.ndarray                     # (D,) fitted multiplier per device
    flops_vec: np.ndarray                 # (D,) peak FLOP/s per device
    j_star: np.ndarray                    # (N,) bw-independent best column
    s_star: np.ndarray                    # (N,) min feasible wire bytes (+inf)
    cloud_only_exec: float                # T_C of the full network
    _edge_mat: Optional[np.ndarray] = field(default=None, repr=False)

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, space: PlanSpace,
              profiles: Optional[Sequence[DeviceProfile]] = None, *,
              flops: Optional[np.ndarray] = None,
              w: Optional[np.ndarray] = None) -> "FleetPlanSpace":
        """Stack D device views over one shared ``space``. Pass either
        ``profiles`` (the object API) or raw ``flops``/``w`` arrays (so a
        10^5-device fleet never materializes 10^5 profile objects)."""
        if profiles is not None:
            if flops is not None or w is not None:
                raise ValueError(
                    "pass either profiles or (flops, w) arrays, not both")
            profs = tuple(profiles)
            w_vec = _readonly(np.array([p.w for p in profs]))
            flops_vec = _readonly(np.array([p.flops for p in profs]))
        else:
            if flops is None or w is None:
                raise ValueError("need either profiles or (flops, w) arrays")
            profs = ()
            w_vec = _readonly(np.asarray(w))
            flops_vec = _readonly(np.asarray(flops))
        if w_vec.shape != flops_vec.shape or w_vec.ndim != 1:
            raise ValueError("w and flops must be matching (D,) vectors")
        if not (flops_vec > 0).all():
            raise ValueError("device flops must be positive")
        masked = np.where(space.feasible, space.size_flat, np.inf)
        return cls(
            space=space,
            profiles=profs,
            w_vec=w_vec,
            flops_vec=flops_vec,
            j_star=_freeze(masked.argmin(axis=1)),
            s_star=_readonly(masked.min(axis=1)),
            cloud_only_exec=space.cloud_exec_full(),
        )

    # ------------------------------------------------------------ queries
    @property
    def n_devices(self) -> int:
        return int(self.w_vec.shape[0])

    def profile(self, d: int) -> DeviceProfile:
        if self.profiles:
            return self.profiles[d]
        return DeviceProfile(f"fleet-{d}", float(self.flops_vec[d]),
                             float(self.w_vec[d]))

    def device_view(self, d: int) -> PlanSpace:
        """The scalar per-device view — ``with_edge`` over the shared
        space, bitwise-identical to ``edge_mat[d]``."""
        return self.space.with_edge(self.profile(d))

    @property
    def edge_mat(self) -> np.ndarray:
        """(D, N) stacked edge-time matrix: row d == the ``edge_vec`` of
        ``with_edge(profile(d))``, bit for bit (same ``(w*q)/F`` float64
        ops, vectorized). Built lazily, cached, read-only."""
        if self._edge_mat is None:
            mat = (self.w_vec[:, None] * self.space.cum_fmacs[None, :])
            mat /= self.flops_vec[:, None]
            object.__setattr__(self, "_edge_mat", _readonly(mat))
        return self._edge_mat

    def _gather_wf(self, devices: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        if devices is None:
            return self.w_vec, self.flops_vec
        dv = np.asarray(devices, dtype=np.int64)
        return self.w_vec[dv], self.flops_vec[dv]

    def cloud_only_time_all(self, bandwidths: np.ndarray,
                            image_ratio: float = 1.0) -> np.ndarray:
        """Vectorized ``PlanSpace.cloud_only_time`` (same float64 ops)."""
        return (self.space.input_bytes * image_ratio
                / np.asarray(bandwidths, dtype=np.float64)
                + self.cloud_only_exec)

    # ----------------------------------------------------------- deciding
    def decide_all(self, bandwidths: np.ndarray,
                   devices: Optional[np.ndarray] = None) -> FleetDecision:
        """Re-plan the fleet under per-device bandwidths: ONE fused
        ``argmin(base + size/BW)`` over the stacked (D, N·C·K) grid
        (factored — see class docstring), with the per-device cloud-only
        fallback exactly where the scalar ``decide`` falls back.

        ``devices`` restricts the op to a subset (the serving waves use
        this); ``bandwidths`` then aligns with that subset.
        """
        t0 = time.perf_counter()
        bw = np.ascontiguousarray(bandwidths, dtype=np.float64)
        w, flops = self._gather_wf(devices)
        d = bw.shape[0]
        if d != w.shape[0]:
            raise ValueError(
                f"got {d} bandwidths for {w.shape[0]} devices")
        space = self.space
        cf, cl, s = space.cum_fmacs, space.cloud_vec, self.s_star
        n = cf.shape[0]
        rows = np.empty(d, dtype=np.int64)
        best = np.empty(d, dtype=np.float64)
        chunk = max(1, min(_FLEET_CHUNK, d))
        ebuf = np.empty((chunk, n))
        cbuf = np.empty((chunk, n))
        for lo in range(0, d, chunk):
            hi = min(lo + chunk, d)
            e = ebuf[:hi - lo]
            # base = T_E + T_C, recomputed from the device scalars with
            # the exact with_edge float64 ops: (w * cum_fmacs) / flops
            np.multiply(w[lo:hi, None], cf[None, :], out=e)
            e /= flops[lo:hi, None]
            e += cl[None, :]
            c = cbuf[:hi - lo]
            # cost = size/BW + base — same op order as PlanSpace.decide
            # (true division; += is bitwise-commutative for floats)
            np.divide(s[None, :], bw[lo:hi, None], out=c)
            c += e
            rr = c.argmin(axis=1)
            rows[lo:hi] = rr
            best[lo:hi] = c[np.arange(hi - lo), rr]
        flat = rows * space.n_choices + self.j_star[rows]
        infeasible = np.isinf(best)
        if infeasible.any():
            flat[infeasible] = -1
            best[infeasible] = self.cloud_only_time_all(bw[infeasible])
        ms = (time.perf_counter() - t0) * 1e3
        return FleetDecision(self, bw, flat, best, ms)

    def stage_times_all(self, flat_j: np.ndarray,
                        devices: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized ``PlanSpace.stage_times``: (T_E, T_C) arrays for
        one plan cell per device (−1 = cloud-only: T_E=0, full-network
        T_C)."""
        j = np.asarray(flat_j, dtype=np.int64)
        co = j < 0
        rows = np.where(co, 0, j) // self.space.n_choices
        dv = (np.arange(self.n_devices) if devices is None
              else np.asarray(devices, dtype=np.int64))
        edge_t = np.where(co, 0.0, self.edge_mat[dv, rows])
        cloud_t = np.where(co, self.cloud_only_exec,
                           self.space.cloud_vec[rows])
        return edge_t, cloud_t

    def plan_cost_all(self, flat_j: np.ndarray, bandwidths: np.ndarray,
                      devices: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized ``PlanSpace.plan_cost``: Z of one held plan cell
        per device at per-device bandwidths — the fleet hysteresis
        check reads this."""
        j = np.asarray(flat_j, dtype=np.int64)
        bw = np.asarray(bandwidths, dtype=np.float64)
        co = j < 0
        safe = np.where(co, 0, j)
        rows, cols = np.divmod(safe, self.space.n_choices)
        dv = (np.arange(self.n_devices) if devices is None
              else np.asarray(devices, dtype=np.int64))
        base = self.edge_mat[dv, rows] + self.space.cloud_vec[rows]
        cost = base + self.space.size_flat[rows, cols] / bw
        if co.any():
            cost = np.where(co, self.cloud_only_time_all(bw), cost)
        return cost


__all__: List[str] = ["PlanSpace", "FleetPlanSpace", "FleetDecision"]
