"""Three-tier decision space: two ordered cuts over device → edge server
→ cloud, with heterogeneous links and a per-tier energy term.

The port's own copy of the reference's ``core/tri_planner.py``, kept
float64 bit-identical (same operations in the same order, ties broken
alike), so both packages decide the same plans from the same tables,
the per-token streaming extension (``TriStreamPlanTerms``) included.

The two-tier :class:`~repro_torch.core.planner.PlanSpace` prices one cut
``i`` over one link. The general case (DNN-partition survey, arXiv:2304.10020;
MCC scheduling with per-link rates and per-core power) is a chain of
tiers: the device runs layers ``[0, i1]``, an edge server runs
``(i1, i2]`` and the cloud runs the rest, with each boundary quantized
and coded independently and shipped over its own link:

    Z(i1, i2, j1, j2, BW1, BW2) = T_dev(i1) + S(i1, j1)/BW1
                                + T_es(i1, i2) + S(i2, j2)/BW2
                                + T_cl(i2)

:class:`TriPlanSpace` keeps the planner's "precompute everything
bandwidth-independent, re-solve as one fused argmin" contract: the space
is the upper-triangular pair grid ``(i1 <= i2)`` crossed with the
``(C·K)²`` per-cut choice axis, infeasible cells folded into ``base`` as
+inf, and a runtime re-solve is

    argmin(base + size1/BW1 + size2/BW2)

**Diagonal (relay) cells.** ``i1 == i2`` means the edge server runs
nothing: the device's blob is relayed over both links unchanged, so only
``j1 == j2`` cells are valid (one encode, one accuracy drop — NOT
doubled), ``T_es = 0`` and both links carry the same bytes. These cells
ARE today's two-tier plans priced over the two-hop path.

**Energy.** Each tier draws ``p_tier`` watts while computing and each
link's transmitter draws ``p_tx`` watts while sending, so a request costs

    E = p_dev·T_dev + p_es·T_es + p_cl·T_cl + p_tx1·S1/BW1 + p_tx2·S2/BW2

joules. With objective weight λ (s/J) the objective Z + λ·E *factors
back into the fused-argmin form*: every compute term picks up a constant
``k_tier = 1 + λ·p_tier`` and every size a constant ``k_tx = 1 + λ·p_tx``
— all bandwidth-independent, folded in at build. λ = 0 multiplies by
exactly 1.0, which preserves float64 bits. An optional hard energy
*budget* (joules) is bandwidth-dependent (it includes transmit energy),
so it is applied at decide time as one extra masked compare.

**Two-tier equivalence (pinned).** ``degenerate()`` masks the middle
tier (diagonal pairs only). With ``BW1 = inf`` the first link vanishes
(``S/inf == 0.0`` exactly and ``x + 0.0`` preserves the bits of
non-negative ``x``), every surviving cell reproduces the two-tier cell
bit for bit, and the cells appear in the same (i-major, j) order — so
``degenerate().decide(inf, BW)`` is bitwise-identical to
``PlanSpace.decide(BW)``, cloud-only fallback included. Brute-force
enumeration over ``(i1, i2, j1, j2)`` (:func:`solve_tri_enumeration`)
and the generic ILP solvers (via :meth:`TriPlanSpace.ilp_problem`, with
the energy budget as a resource row) are kept as cross-checked oracles.

:class:`TriFleetPlanSpace` is the D-device plane. The choice axis can't
be hoisted like the two-tier fleet's (two size terms, two bandwidths),
but two bandwidth-independent reductions keep the fused ``(D, ·)``
re-solve at paper scale under the fleet latency budget:

* **j2 hoist** — for a fixed ``(i1, i2, j1)`` cell the best ``j2``
  minimizes ``size2`` subject to the remaining accuracy budget,
  independent of both bandwidths; ``argmin`` over the masked row picks
  the lowest ``j2`` on ties exactly like the scalar argmin.
* **Pareto prune** — a cell's per-device cost is monotone in the four
  coordinates ``(cum_fmacs(i1), T_es+T_cl, size1, size2*)``; a cell
  whose coordinates are all >= another's can never win an argmin for
  any (device, BW1, BW2), so only the 4-D Pareto frontier of cells is
  kept (exact ties keep the lowest flat index, preserving the scalar
  tie-break).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.types import DeviceProfile, TierPowerModel
from repro_torch.core.ilp import ILPProblem, ILPSolution
from repro_torch.core.latency import CloudMeshModel, LatencyModel, _freeze
from repro_torch.core.planner import _plan_cls, _readonly

if TYPE_CHECKING:
    from repro_torch.core.decoupler import DecoupledPlan
    from repro_torch.core.predictor import PredictorTables

_INF = float("inf")


@dataclass(frozen=True, eq=False)
class TriPlanSpace:
    """Precomputed three-tier decision space over the flattened
    ``(pair, j1·CK + j2)`` grid for one (device, edge-server, cloud)
    triple. Pairs are ordered i1-major then i2 ascending (the row-major
    upper triangle), matching the scalar enumeration order that argmin
    tie-breaking is pinned against."""

    point_rows: Tuple[int, ...]        # table row -> model point index
    bits_choices: Tuple[int, ...]
    codecs: Tuple[str, ...]
    budget: float
    device: DeviceProfile
    edge_server: DeviceProfile
    cloud: DeviceProfile
    power: TierPowerModel
    energy_weight: float               # λ, seconds per joule
    cum_fmacs: np.ndarray              # (N,) cumulative FMACs at each row
    total_fmacs: float
    input_bytes: float                 # raw input bytes PER BATCH
    dev_vec: np.ndarray                # (N,) T_dev at each row
    cl_vec: np.ndarray                 # (N,) T_cl at each row (mesh-aware)
    size_flat: np.ndarray              # (N, C*K) wire bytes PER BATCH
    acc_flat: np.ndarray               # (N, C*K) accuracy drop
    i1_idx: np.ndarray                 # (P,) int64 first-cut row per pair
    i2_idx: np.ndarray                 # (P,) int64 second-cut row per pair
    diag_only: bool = False            # degenerate view: no middle tier
    cloud_mesh: CloudMeshModel = CloudMeshModel()
    n_model_points: int = 0
    cloud_vec_single: np.ndarray = field(repr=False, default=None)
    # --- derived in finalize() ---
    mid_vec: np.ndarray = field(repr=False, default=None)   # (P,) raw T_es
    midcl: np.ndarray = field(repr=False, default=None)     # (P,) aug T_es+T_cl
    acc: np.ndarray = field(repr=False, default=None)       # (P, CK²)
    feasible: np.ndarray = field(repr=False, default=None)  # (P, CK²) bool
    size1_eff: np.ndarray = field(repr=False, default=None)  # (P, CK²)
    size2_eff: np.ndarray = field(repr=False, default=None)  # (P, CK²)
    base: np.ndarray = field(repr=False, default=None)       # (P, CK²) +inf
    base_raw: np.ndarray = field(repr=False, default=None)   # unmasked
    energy_base: np.ndarray = field(repr=False, default=None)  # (P,) joules
    _pair_of: Dict[Tuple[int, int], int] = field(repr=False, default=None)
    _row_of_point: Dict[int, int] = field(repr=False, default=None)
    _tx_cache: list = field(repr=False, default=None)

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, tables: "PredictorTables", latency: LatencyModel,
              budget: float, *,
              edge_server: DeviceProfile,
              power: Optional[TierPowerModel] = None,
              energy_weight: float = 0.0,
              point_indices: Optional[Sequence[int]] = None
              ) -> "TriPlanSpace":
        """``latency.edge`` is the *device* tier; the middle tier's time
        is derived from the same cumulative-FMAC profile with the
        ``edge_server`` device model."""
        rows = (list(point_indices) if point_indices is not None
                else list(range(len(tables.points))))
        n = len(rows)
        dev_vec = _readonly(latency.edge_times()[rows])
        cl_vec = _readonly(latency.cloud_times()[rows])
        cum = _readonly(latency.cum_fmacs[rows])
        size_flat = _readonly(tables.size_bytes.reshape(n, -1))
        acc_flat = _readonly(tables.acc_drop.reshape(n, -1))
        i1, i2 = np.triu_indices(n)
        return cls(
            point_rows=tuple(rows),
            bits_choices=tuple(tables.bits_choices),
            codecs=tuple(tables.codecs),
            budget=float(budget),
            device=latency.edge,
            edge_server=edge_server,
            cloud=latency.cloud,
            power=power or TierPowerModel(),
            energy_weight=float(energy_weight),
            cum_fmacs=cum,
            total_fmacs=latency.total_fmacs,
            input_bytes=float(latency.input_bytes),
            dev_vec=dev_vec,
            cl_vec=cl_vec,
            size_flat=size_flat,
            acc_flat=acc_flat,
            i1_idx=_freeze(i1.astype(np.int64)),
            i2_idx=_freeze(i2.astype(np.int64)),
            n_model_points=latency.n_points,
        ).finalize()

    # Objective scale factors: Z + λE folds into the latency terms as
    # constant multipliers. λ = 0 gives exactly 1.0 (bitwise identity).
    @property
    def k_dev(self) -> float:
        return 1.0 + self.energy_weight * self.power.device_w

    @property
    def k_es(self) -> float:
        return 1.0 + self.energy_weight * self.power.edge_server_w

    @property
    def k_cl(self) -> float:
        return 1.0 + self.energy_weight * self.power.cloud_w

    @property
    def k_tx1(self) -> float:
        return 1.0 + self.energy_weight * self.power.tx1_w

    @property
    def k_tx2(self) -> float:
        return 1.0 + self.energy_weight * self.power.tx2_w

    def finalize(self) -> "TriPlanSpace":
        """Derive the fused-argmin operands; returns self for chaining."""
        if self.cloud_vec_single is None:
            object.__setattr__(self, "cloud_vec_single", self.cl_vec)
        p = self.i1_idx.shape[0]
        ck = self.size_flat.shape[1]
        i1, i2 = self.i1_idx, self.i2_idx
        # Middle-tier time: same (w*q)/F float64 ops as DeviceProfile
        # .exec_time, vectorized over the pair grid. Zero FMACs -> 0.0
        # exactly, so diagonal pairs cost the device's blob a free relay.
        es = self.edge_server
        mid = es.w * (self.cum_fmacs[i2] - self.cum_fmacs[i1]) / es.flops
        # Per-cell accuracy: additive across the two lossy boundaries;
        # diagonal pairs have ONE boundary, so only j1 == j2 cells are
        # real (acc NOT doubled) and the rest are +inf — which the
        # budget compare below folds into infeasibility for free.
        a1 = self.acc_flat[i1]                       # (P, CK)
        a2 = self.acc_flat[i2]
        acc = (a1[:, :, None] + a2[:, None, :])      # (P, CK, CK)
        diag = i1 == i2
        if diag.any():
            nd = int(diag.sum())
            acc_d = np.full((nd, ck, ck), np.inf)
            acc_d[:, np.arange(ck), np.arange(ck)] = self.acc_flat[i1[diag]]
            acc[diag] = acc_d
        acc = np.ascontiguousarray(acc.reshape(p, ck * ck))
        feasible = acc <= self.budget
        # Energy-weighted sizes (λ=0 -> *1.0, bitwise identity).
        s1 = self.size_flat[i1] * self.k_tx1         # (P, CK)
        s2 = self.size_flat[i2] * self.k_tx2
        size1_eff = np.ascontiguousarray(
            np.broadcast_to(s1[:, :, None], (p, ck, ck)).reshape(p, ck * ck))
        size2_eff = np.ascontiguousarray(
            np.broadcast_to(s2[:, None, :], (p, ck, ck)).reshape(p, ck * ck))
        # base = T_dev + (T_es + T_cl), each tier scaled by its k factor.
        dev_aug = self.dev_vec * self.k_dev
        midcl = mid * self.k_es + self.cl_vec[i2] * self.k_cl
        base_pair = dev_aug[i1] + midcl
        base_raw = np.broadcast_to(base_pair[:, None], (p, ck * ck))
        if self.diag_only:
            feasible = feasible & diag[:, None]
        base = np.where(feasible, base_raw, np.inf)
        base.flags.writeable = False
        pw = self.power
        e_base = (pw.device_w * self.dev_vec[i1] + pw.edge_server_w * mid
                  + pw.cloud_w * self.cl_vec[i2])
        object.__setattr__(self, "mid_vec", _readonly(mid))
        object.__setattr__(self, "midcl", _readonly(midcl))
        object.__setattr__(self, "acc", _readonly(acc))
        object.__setattr__(self, "feasible", _freeze(feasible))
        object.__setattr__(self, "size1_eff", _readonly(size1_eff))
        object.__setattr__(self, "size2_eff", _readonly(size2_eff))
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "base_raw", _readonly(base_raw))
        object.__setattr__(self, "energy_base", _readonly(e_base))
        object.__setattr__(
            self, "_pair_of",
            {(int(a), int(b)): q for q, (a, b) in enumerate(zip(i1, i2))})
        object.__setattr__(
            self, "_row_of_point",
            {pt: r for r, pt in enumerate(self.point_rows)})
        object.__setattr__(self, "_tx_cache", [None])
        return self

    def degenerate(self) -> "TriPlanSpace":
        """The two-tier derived view: mask the middle tier (diagonal
        pairs only survive). With ``BW1 = inf`` this reproduces
        ``PlanSpace.decide`` bitwise (see module docstring)."""
        return replace(self, diag_only=True, mid_vec=None).finalize()

    def with_cloud_mesh(self, mesh: CloudMeshModel) -> "TriPlanSpace":
        """Mesh-parallel cloud *tail* tier, exactly PlanSpace's model:
        ``T_cl^mesh(i) = T_cl(i)/M + coll * (layers after i)``. Derived
        from ``cloud_vec_single`` so meshed views never compound;
        identity at ``CloudMeshModel(1, 0.0)``."""
        n_total = self.n_model_points or (
            max(self.point_rows) + 1 if self.point_rows else 0)
        remaining = (float(n_total) - 1.0
                     - np.asarray(self.point_rows, dtype=np.float64))
        vec = (self.cloud_vec_single / float(mesh.n_devices)
               + float(mesh.collective_s_per_point) * remaining)
        return replace(self, cloud_mesh=mesh, cl_vec=_readonly(vec),
                       mid_vec=None).finalize()

    # ------------------------------------------------------------ queries
    @property
    def n_pairs(self) -> int:
        return int(self.i1_idx.shape[0])

    @property
    def n_inner(self) -> int:
        return int(self.size_flat.shape[1])

    @property
    def n_cells(self) -> int:
        return self.n_pairs * self.n_inner * self.n_inner

    def _unflatten(self, f: int) -> Tuple[int, int, int]:
        """flat cell -> (pair, j1, j2)."""
        ck = self.n_inner
        q, j12 = divmod(f, ck * ck)
        j1, j2 = divmod(j12, ck)
        return q, j1, j2

    def _choice(self, j: int) -> Tuple[int, str]:
        ci, ki = divmod(j, len(self.codecs))
        return self.bits_choices[ci], self.codecs[ki]

    def _j_of(self, bits: int, codec: str) -> int:
        return (self.bits_choices.index(bits) * len(self.codecs)
                + self.codecs.index(codec))

    def row_of_point(self, point: int) -> int:
        return self._row_of_point[point]

    def cloud_exec_full(self) -> float:
        """Full-network cloud execution time under the mesh model (raw
        seconds, no energy weighting)."""
        m = self.cloud_mesh
        return (self.cloud.exec_time(self.total_fmacs) / float(m.n_devices)
                + float(m.collective_s_per_point) * float(
                    self.n_model_points or len(self.point_rows)))

    def cloud_only_time(self, bw1: float, bw2: float,
                        image_ratio: float = 1.0) -> float:
        """Objective of the no-decoupling fallback: upload the input over
        BOTH links (device → edge server → cloud relay), run everything
        on the cloud. At ``BW1 = inf`` and λ = 0 this is bitwise the
        two-tier ``PlanSpace.cloud_only_time(BW2)``."""
        return (self.input_bytes * self.k_tx2 * image_ratio / float(bw2)
                + self.input_bytes * self.k_tx1 * image_ratio / float(bw1)
                + self.cloud_exec_full() * self.k_cl)

    def cloud_only_energy(self, bw1: float, bw2: float,
                          image_ratio: float = 1.0) -> float:
        pw = self.power
        return (pw.tx2_w * self.input_bytes * image_ratio / float(bw2)
                + pw.tx1_w * self.input_bytes * image_ratio / float(bw1)
                + pw.cloud_w * self.cloud_exec_full())

    def _cell_of_plan(self, plan: "DecoupledPlan") -> Tuple[int, int, int]:
        q = self._pair_of[(self._row_of_point[plan.point],
                           self._row_of_point[plan.point2])]
        return q, self._j_of(plan.bits, plan.codec), self._j_of(
            plan.bits2, plan.codec2)

    def stage_times(self, plan: "DecoupledPlan"
                    ) -> Tuple[float, float, float]:
        """(T_dev, T_es, T_cl) wall seconds of a concrete plan — what the
        three-hop serving clock charges per stage (raw times; the energy
        weight only skews the *objective*). Cloud-only runs everything on
        the cloud."""
        if plan.is_cloud_only:
            return 0.0, 0.0, self.cloud_exec_full()
        q, _, _ = self._cell_of_plan(plan)
        return (float(self.dev_vec[self.i1_idx[q]]),
                float(self.mid_vec[q]),
                float(self.cl_vec[self.i2_idx[q]]))

    def plan_sizes(self, plan: "DecoupledPlan") -> Tuple[float, float]:
        """(S1, S2) predicted wire bytes of the two boundary transfers."""
        if plan.is_cloud_only:
            return self.input_bytes, self.input_bytes
        q, j1, j2 = self._cell_of_plan(plan)
        return (float(self.size_flat[self.i1_idx[q], j1]),
                float(self.size_flat[self.i2_idx[q], j2]))

    def plan_cost(self, plan: "DecoupledPlan", bw1: float,
                  bw2: float) -> float:
        """Objective of a concrete plan at concrete bandwidths — the
        hysteresis check routes through here. Same op order as the fused
        decide, so held-plan and fresh-plan costs compare bitwise."""
        if plan.is_cloud_only:
            return self.cloud_only_time(bw1, bw2)
        q, j1, j2 = self._cell_of_plan(plan)
        j12 = j1 * self.n_inner + j2
        return float(self.size2_eff[q, j12] / float(bw2)
                     + self.size1_eff[q, j12] / float(bw1)
                     + self.base_raw[q, j12])

    def energy_of(self, plan: "DecoupledPlan", bw1: float,
                  bw2: float) -> float:
        """Per-request joules of a concrete plan at concrete bandwidths."""
        if plan.is_cloud_only:
            return self.cloud_only_energy(bw1, bw2)
        q, j1, j2 = self._cell_of_plan(plan)
        pw = self.power
        return float(self.energy_base[q]
                     + pw.tx1_w * self.size_flat[self.i1_idx[q], j1]
                     / float(bw1)
                     + pw.tx2_w * self.size_flat[self.i2_idx[q], j2]
                     / float(bw2))

    def _tx_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Lazy (P, CK²) transmit-energy numerators p_tx·S (joule·B/s)."""
        if self._tx_cache[0] is None:
            p, ck = self.n_pairs, self.n_inner
            t1 = self.size_flat[self.i1_idx] * self.power.tx1_w
            t2 = self.size_flat[self.i2_idx] * self.power.tx2_w
            tx1 = np.ascontiguousarray(np.broadcast_to(
                t1[:, :, None], (p, ck, ck)).reshape(p, ck * ck))
            tx2 = np.ascontiguousarray(np.broadcast_to(
                t2[:, None, :], (p, ck, ck)).reshape(p, ck * ck))
            self._tx_cache[0] = (_readonly(tx1), _readonly(tx2))
        return self._tx_cache[0]

    def energy_grid(self, bw1: float, bw2: float) -> np.ndarray:
        """(P, CK²) per-request joules of every cell at the given
        bandwidths — the energy-budget mask operand."""
        tx1, tx2 = self._tx_arrays()
        e = tx2 / float(bw2)
        e += tx1 / float(bw1)
        e += self.energy_base[:, None]
        return e

    # ----------------------------------------------------------- deciding
    def cloud_only_plan(self, bw1: float, bw2: float,
                        solve_ms: float = 0.0) -> "DecoupledPlan":
        return _plan_cls()(-1, 0, self.cloud_only_time(bw1, bw2),
                           0.0, solve_ms)

    def _plan_from_flat(self, f: int, best: float,
                        ms: float) -> "DecoupledPlan":
        q, j1, j2 = self._unflatten(f)
        bits1, codec1 = self._choice(j1)
        bits2, codec2 = self._choice(j2)
        return _plan_cls()(
            point=self.point_rows[self.i1_idx[q]],
            bits=bits1,
            predicted_latency=best,
            predicted_acc_drop=float(self.acc.flat[f]),
            solve_ms=ms,
            codec=codec1,
            point2=self.point_rows[self.i2_idx[q]],
            bits2=bits2,
            codec2=codec2,
        )

    def decide(self, bw1: float, bw2: float,
               energy_budget: Optional[float] = None) -> "DecoupledPlan":
        """Re-solve under fresh link bandwidths: one fused
        ``argmin(base + size1/BW1 + size2/BW2)`` over the precomputed
        grid, with an optional energy-budget mask (the budget is the one
        term that can't be hoisted — transmit joules depend on BW)."""
        t0 = time.perf_counter()
        # True division + two-operand adds: each += is bitwise
        # commutative, so the cell values match the enumeration oracle's
        # scalar arithmetic exactly.
        cost = self.size2_eff / float(bw2)
        cost += self.size1_eff / float(bw1)
        cost += self.base
        if energy_budget is not None:
            cost = np.where(self.energy_grid(bw1, bw2)
                            <= float(energy_budget), cost, np.inf)
        f = int(cost.argmin())
        best = float(cost.flat[f])
        ms = (time.perf_counter() - t0) * 1e3
        if best == _INF:
            return self.cloud_only_plan(bw1, bw2, ms)
        return self._plan_from_flat(f, best, ms)

    # ------------------------------------------------------------ oracles
    def ilp_problem(self, bw1: float, bw2: float,
                    energy_budget: Optional[float] = None) -> ILPProblem:
        """The exact selection problem for the generic enumeration/B&B
        solvers, with the energy budget as a resource-constraint row.
        Cost cells are bitwise-identical to :meth:`decide` (same operand
        bits, commutative float64 adds); diagonal ``j1 != j2`` cells are
        excluded through their +inf accuracy."""
        cost = self.size2_eff / float(bw2)
        cost += self.size1_eff / float(bw1)
        cost = cost + self.base_raw
        usage = limits = None
        if energy_budget is not None:
            usage = self.energy_grid(bw1, bw2)[None]
            limits = np.array([float(energy_budget)])
        return ILPProblem(cost, np.asarray(self.acc), self.budget,
                          usage=usage, limits=limits)

    def plan_from_solution(self, sol: ILPSolution) -> "DecoupledPlan":
        f = sol.point * self.n_inner * self.n_inner + sol.bits_index
        return self._plan_from_flat(f, sol.objective, sol.solve_ms)

    def with_streaming(self, d_model: int,
                       tokens_per_batch: float) -> "TriStreamPlanTerms":
        """Per-token steady-state extension: two boundary streams priced
        every decode step (see :class:`TriStreamPlanTerms`)."""
        return TriStreamPlanTerms.build(self, d_model, tokens_per_batch)


def solve_tri_enumeration(tri: TriPlanSpace, bw1: float, bw2: float,
                          energy_budget: Optional[float] = None
                          ) -> Optional[Tuple[int, float]]:
    """Brute-force two-cut oracle: python loops over every
    ``(i1 <= i2, j1, j2)`` cell, recomputing cost and feasibility from
    the component vectors with the documented op order — no shared
    fused-path arrays beyond the operand bits. Returns ``(flat, cost)``
    of the winner or None if everything is infeasible."""
    ck = tri.n_inner
    best_f, best_c = -1, _INF
    for q in range(tri.n_pairs):
        i1, i2 = int(tri.i1_idx[q]), int(tri.i2_idx[q])
        for j1 in range(ck):
            for j2 in range(ck):
                if i1 == i2:
                    if j1 != j2:
                        continue
                    a = float(tri.acc_flat[i1, j1])
                else:
                    a = float(tri.acc_flat[i1, j1]
                              + tri.acc_flat[i2, j2])
                if not a <= tri.budget:
                    continue
                if energy_budget is not None:
                    pw = tri.power
                    e = (pw.tx2_w * float(tri.size_flat[i2, j2]) / float(bw2)
                         + pw.tx1_w * float(tri.size_flat[i1, j1])
                         / float(bw1)
                         + float(tri.energy_base[q]))
                    if not e <= float(energy_budget):
                        continue
                c = (float(tri.size_flat[i2, j2]) * tri.k_tx2 / float(bw2)
                     + float(tri.size_flat[i1, j1]) * tri.k_tx1 / float(bw1)
                     + (float(tri.dev_vec[i1]) * tri.k_dev
                        + (float(tri.mid_vec[q]) * tri.k_es
                           + float(tri.cl_vec[i2]) * tri.k_cl)))
                if c < best_c:
                    best_f = (q * ck + j1) * ck + j2
                    best_c = c
    if best_f < 0:
        return None
    return best_f, best_c


# ---------------------------------------------------------------------------
# Token streaming: two per-token boundary streams
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class TriStreamPlanTerms:
    """Per-token steady-state extension of one :class:`TriPlanSpace` —
    the three-tier :class:`~repro_torch.core.planner.StreamPlanTerms`. Token
    streaming pays BOTH wires every decode step:

        Z_stream = Z_prefill(i1,i2,j1,j2,BW1,BW2)
                 + E[tokens] * (t_dev + t_es + t_cl
                                + tok(j1)/BW1 + tok(j2)/BW2)

    where the per-token stage times are the batch-unit compute vectors
    divided by ``tokens_per_batch`` and ``tok(j)`` is the stream-frame
    wire size of one ``(1, 1, d_model)`` boundary row (codec shape-only
    size minus the amortized 1-byte bits tag, exactly the two-tier
    constant). Relay (diagonal) cells stream the SAME frame over both
    links — which falls out for free since only ``j1 == j2`` diagonal
    cells are feasible. Energy weighting applies the same ``k`` factors
    as the one-shot objective, so λ = 0 stays bitwise; at ``BW1 = inf``
    over the ``degenerate()`` view this reproduces the two-tier
    ``StreamPlanTerms.decide`` bitwise."""

    tri: TriPlanSpace
    d_model: int
    tokens_per_batch: float
    token_bytes: np.ndarray            # (CK,) stream-frame bytes per token

    @classmethod
    def build(cls, tri: TriPlanSpace, d_model: int,
              tokens_per_batch: float) -> "TriStreamPlanTerms":
        if tokens_per_batch <= 0:
            raise ValueError("tokens_per_batch must be positive")
        from repro_torch.codec import get_codec  # lazy: codec imports core

        shape = (1, 1, int(d_model))
        k = len(tri.codecs)
        tb = np.empty(tri.n_inner, dtype=np.float64)
        for j in range(tri.n_inner):
            ci, ki = divmod(j, k)
            tb[j] = float(
                get_codec(tri.codecs[ki]).wire_size_bytes(
                    shape, tri.bits_choices[ci])) - 1.0
        return cls(tri=tri, d_model=int(d_model),
                   tokens_per_batch=float(tokens_per_batch),
                   token_bytes=_readonly(tb))

    # ------------------------------------------------------------- costs
    def _steady_extra(self, bw1: float, bw2: float,
                      expected_tokens: float) -> np.ndarray:
        """(P, CK²) matrix of E[tokens] * per-token steady-state cost.
        Op order mirrors the two-tier ``_steady_extra`` with the first
        link's term added last, so at ``BW1 = inf`` every add is the
        two-tier add (x + 0.0 preserves bits)."""
        tri = self.tri
        ck = tri.n_inner
        # Per-pair compute term with the energy k factors — identical
        # operand bits to the one-shot ``base`` construction.
        comp = (tri.dev_vec * tri.k_dev)[tri.i1_idx] + tri.midcl
        tok1 = np.broadcast_to(
            (self.token_bytes * tri.k_tx1)[:, None], (ck, ck)).reshape(-1)
        tok2 = np.broadcast_to(
            (self.token_bytes * tri.k_tx2)[None, :], (ck, ck)).reshape(-1)
        extra = comp[:, None] / self.tokens_per_batch
        extra = extra + tok2[None, :] / float(bw2)
        extra = extra + tok1[None, :] / float(bw1)
        extra = extra * float(expected_tokens)
        return extra

    def token_time(self, plan: "DecoupledPlan", bw1: float,
                   bw2: float) -> float:
        """Raw steady-state seconds per generated token under a concrete
        plan (no energy weighting — the serving clock charges walltime)."""
        tri = self.tri
        if plan.is_cloud_only:
            return (4.0 / float(bw2) + 4.0 / float(bw1)
                    + tri.cloud_exec_full() / self.tokens_per_batch)
        t_dev, t_es, t_cl = tri.stage_times(plan)
        j1 = tri._j_of(plan.bits, plan.codec)
        j2 = tri._j_of(plan.bits2, plan.codec2)
        return float(
            (t_dev + t_es + t_cl) / self.tokens_per_batch
            + self.token_bytes[j1] / float(bw1)
            + self.token_bytes[j2] / float(bw2)
        )

    def cloud_only_stream_time(self, bw1: float, bw2: float,
                               expected_tokens: float) -> float:
        """Z_stream of the no-decoupling fallback: input relayed over
        both links, everything on the cloud, one 4-byte token id back per
        step (over both links, energy-weighted like the one-shot)."""
        tri = self.tri
        per_tok = (4.0 * tri.k_tx2 / float(bw2)
                   + 4.0 * tri.k_tx1 / float(bw1)
                   + tri.cloud_exec_full() * tri.k_cl
                   / self.tokens_per_batch)
        return (tri.cloud_only_time(bw1, bw2)
                + float(expected_tokens) * per_tok)

    def cloud_only_plan(self, bw1: float, bw2: float,
                        expected_tokens: float,
                        solve_ms: float = 0.0) -> "DecoupledPlan":
        return _plan_cls()(
            -1, 0,
            self.cloud_only_stream_time(bw1, bw2, expected_tokens),
            0.0, solve_ms)

    # ----------------------------------------------------------- deciding
    def decide(self, bw1: float, bw2: float,
               expected_tokens: float) -> "DecoupledPlan":
        """One fused ``argmin(base + size1/BW1 + size2/BW2 + E*steady)``
        over the same precomputed grid as :meth:`TriPlanSpace.decide`."""
        t0 = time.perf_counter()
        tri = self.tri
        cost = tri.size2_eff / float(bw2)
        cost += tri.size1_eff / float(bw1)
        cost += tri.base
        cost += self._steady_extra(bw1, bw2, expected_tokens)
        f = int(cost.argmin())
        best = float(cost.flat[f])
        ms = (time.perf_counter() - t0) * 1e3
        if best == _INF:
            return self.cloud_only_plan(bw1, bw2, expected_tokens, ms)
        return tri._plan_from_flat(f, best, ms)

    # ------------------------------------------------------------ oracles
    def ilp_problem(self, bw1: float, bw2: float,
                    expected_tokens: float) -> ILPProblem:
        """Exact streaming selection problem for the enumeration/B&B
        oracles — cell costs bitwise-identical to :meth:`decide`."""
        tri = self.tri
        cost = tri.size2_eff / float(bw2)
        cost += tri.size1_eff / float(bw1)
        cost = cost + tri.base_raw
        cost = cost + self._steady_extra(bw1, bw2, expected_tokens)
        return ILPProblem(cost, np.asarray(tri.acc), tri.budget)

    def plan_from_solution(self, sol: ILPSolution) -> "DecoupledPlan":
        return self.tri.plan_from_solution(sol)


# ---------------------------------------------------------------------------
# Fleet decision plane: D devices, one fused two-cut re-plan
# ---------------------------------------------------------------------------

_TRI_FLEET_CHUNK = 1024


def _pareto_keep(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Boolean keep-mask of the Pareto frontier under all-coordinate <=
    dominance. Exact full-coordinate ties keep the lowest index, so the
    surviving set always contains the lowest-index minimizer of any
    monotone positive combination of the coordinates (the argmin
    tie-break contract).

    Lex-scan: sort by (c0, c1, ..., index); any dominator sorts strictly
    earlier (or is an identical tuple with lower index), so one forward
    pass checking each point against the kept set is exact."""
    m = int(cols[0].shape[0])
    if m == 0:
        return np.zeros(0, dtype=bool)
    idx = np.lexsort(tuple([np.arange(m)] + [np.asarray(c) for c in
                                             reversed(list(cols))]))
    pts = np.stack([np.asarray(c)[idx] for c in cols], axis=1)
    keep = np.zeros(m, dtype=bool)
    buf = np.empty((m, len(cols)))
    k = 0
    for t in range(m):
        p = pts[t]
        if k and bool(np.any(np.all(buf[:k] <= p, axis=1))):
            continue
        buf[k] = p
        k += 1
        keep[idx[t]] = True
    return keep


@dataclass(frozen=True, eq=False)
class TriFleetDecision:
    """All D three-tier plans of one ``decide_all``, held as arrays.
    ``cell[d]`` indexes the fleet's kept-cell table (-1 = cloud-only);
    ``flat_of_cell`` maps it back to the scalar space's flat cell id for
    oracle cross-checks."""

    fleet: "TriFleetPlanSpace"
    bw1: np.ndarray                   # (D,)
    bw2: np.ndarray                   # (D,)
    cell: np.ndarray                  # (D,) int64, -1 = cloud-only
    cost: np.ndarray                  # (D,) objective
    solve_ms: float = 0.0

    def __len__(self) -> int:
        return int(self.cell.shape[0])

    def plan(self, d: int) -> "DecoupledPlan":
        fl = self.fleet
        c = int(self.cell[d])
        if c < 0:
            return _plan_cls()(-1, 0, float(self.cost[d]), 0.0,
                               self.solve_ms)
        tri = fl.tri
        bits1, codec1 = tri._choice(int(fl.j1A[c]))
        bits2, codec2 = tri._choice(int(fl.j2A[c]))
        return _plan_cls()(
            point=tri.point_rows[fl.i1A[c]],
            bits=bits1,
            predicted_latency=float(self.cost[d]),
            predicted_acc_drop=float(fl.accA[c]),
            solve_ms=self.solve_ms,
            codec=codec1,
            point2=tri.point_rows[fl.i2A[c]],
            bits2=bits2,
            codec2=codec2,
        )

    def plans(self) -> List["DecoupledPlan"]:
        return [self.plan(d) for d in range(len(self))]


@dataclass(frozen=True, eq=False)
class TriFleetPlanSpace:
    """One shared :class:`TriPlanSpace` stacked across D devices.

    Build hoists everything bandwidth-independent (see module
    docstring): the best ``j2`` per ``(pair, j1)`` cell, then the 4-D
    Pareto frontier over ``(cum_fmacs(i1), T_es+T_cl, size1, size2*)``.
    ``decide_all`` is then one fused chunked
    ``argmin(e + s1/BW1 + s2*/BW2)`` over ``(D, n_cells)`` with the
    per-device device-tier term recomputed from the (w, flops) scalars
    — the same float64 ops as the scalar ``decide``, so fleet plans
    agree with D independent scalar solves (and, restricted to the
    degenerate view at BW1 = inf, bitwise with
    ``FleetPlanSpace.decide_all``)."""

    tri: TriPlanSpace
    profiles: Tuple[DeviceProfile, ...]
    w_vec: np.ndarray                 # (D,)
    flops_vec: np.ndarray             # (D,)
    # Kept-cell table (all (P_kept,) arrays, ordered by scalar flat id).
    cum1A: np.ndarray                 # cum FMACs at i1 (device-term operand)
    midclA: np.ndarray                # aug T_es + T_cl
    s1A: np.ndarray                   # effective first-boundary bytes
    s2A: np.ndarray                   # effective best second-boundary bytes
    i1A: np.ndarray
    i2A: np.ndarray
    j1A: np.ndarray
    j2A: np.ndarray
    accA: np.ndarray
    flat_of_cell: np.ndarray          # scalar flat cell id per kept cell
    midA_raw: np.ndarray              # raw T_es
    clA_raw: np.ndarray               # raw T_cl
    cloud_only_exec: float

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, tri: TriPlanSpace,
              profiles: Optional[Sequence[DeviceProfile]] = None, *,
              flops: Optional[np.ndarray] = None,
              w: Optional[np.ndarray] = None) -> "TriFleetPlanSpace":
        if profiles is not None:
            if flops is not None or w is not None:
                raise ValueError(
                    "pass either profiles or (flops, w) arrays, not both")
            profs = tuple(profiles)
            w_vec = _readonly(np.array([pr.w for pr in profs]))
            flops_vec = _readonly(np.array([pr.flops for pr in profs]))
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
        p, ck = tri.n_pairs, tri.n_inner
        # j2 hoist: per (pair, j1), the feasible j2 minimizing size2.
        # argmin over the masked row picks the lowest j2 on exact ties —
        # the scalar argmin's tie-break along the fastest axis.
        m = np.where(tri.feasible, tri.size2_eff,
                     np.inf).reshape(p, ck, ck)
        j2b = m.argmin(axis=2)                        # (P, CK)
        s2b = np.take_along_axis(m, j2b[:, :, None], axis=2)[:, :, 0]
        s1c = np.ascontiguousarray(
            tri.size1_eff.reshape(p, ck, ck)[:, :, 0])  # (P, CK)
        alive = np.isfinite(s2b)
        p_ids, j1_ids = np.nonzero(alive)             # row-major: flat order
        cum1 = tri.cum_fmacs[tri.i1_idx[p_ids]]
        midcl = tri.midcl[p_ids]
        s1 = s1c[alive]
        s2 = s2b[alive]
        keep = _pareto_keep((cum1, midcl, s1, s2))
        p_ids, j1_ids = p_ids[keep], j1_ids[keep]
        i1 = tri.i1_idx[p_ids]
        i2 = tri.i2_idx[p_ids]
        j2 = j2b[alive][keep]
        flat = (p_ids * ck + j1_ids) * ck + j2
        return cls(
            tri=tri,
            profiles=profs,
            w_vec=w_vec,
            flops_vec=flops_vec,
            cum1A=_readonly(cum1[keep]),
            midclA=_readonly(midcl[keep]),
            s1A=_readonly(s1[keep]),
            s2A=_readonly(s2[keep]),
            i1A=_freeze(i1.astype(np.int64)),
            i2A=_freeze(i2.astype(np.int64)),
            j1A=_freeze(j1_ids.astype(np.int64)),
            j2A=_freeze(j2.astype(np.int64)),
            accA=_readonly(tri.acc.reshape(p, ck, ck)[p_ids, j1_ids, j2]),
            flat_of_cell=_freeze(flat.astype(np.int64)),
            midA_raw=_readonly(tri.mid_vec[p_ids]),
            clA_raw=_readonly(tri.cl_vec[i2]),
            cloud_only_exec=tri.cloud_exec_full(),
        )

    # ------------------------------------------------------------ queries
    @property
    def n_devices(self) -> int:
        return int(self.w_vec.shape[0])

    @property
    def n_cells(self) -> int:
        return int(self.cum1A.shape[0])

    def profile(self, d: int) -> DeviceProfile:
        if self.profiles:
            return self.profiles[d]
        return DeviceProfile(f"fleet-{d}", float(self.flops_vec[d]),
                             float(self.w_vec[d]))

    def _gather_wf(self, devices: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        if devices is None:
            return self.w_vec, self.flops_vec
        dv = np.asarray(devices, dtype=np.int64)
        return self.w_vec[dv], self.flops_vec[dv]

    def cloud_only_time_all(self, bw1: np.ndarray,
                            bw2: np.ndarray,
                            image_ratio: float = 1.0) -> np.ndarray:
        """Vectorized ``TriPlanSpace.cloud_only_time`` (same op order)."""
        tri = self.tri
        return (tri.input_bytes * tri.k_tx2 * image_ratio
                / np.asarray(bw2, dtype=np.float64)
                + tri.input_bytes * tri.k_tx1 * image_ratio
                / np.asarray(bw1, dtype=np.float64)
                + self.cloud_only_exec * tri.k_cl)

    # ----------------------------------------------------------- deciding
    def decide_all(self, bw1: np.ndarray, bw2: np.ndarray,
                   devices: Optional[np.ndarray] = None
                   ) -> TriFleetDecision:
        """Re-plan the fleet under per-device link bandwidths: ONE fused
        chunked ``argmin`` over the ``(D, n_cells)`` kept-cell grid, with
        the per-device cloud-only fallback exactly where the scalar
        decide falls back."""
        t0 = time.perf_counter()
        b1 = np.ascontiguousarray(bw1, dtype=np.float64)
        b2 = np.ascontiguousarray(bw2, dtype=np.float64)
        w, flops = self._gather_wf(devices)
        d = b1.shape[0]
        if d != b2.shape[0] or d != w.shape[0]:
            raise ValueError(
                f"got ({b1.shape[0]}, {b2.shape[0]}) bandwidths for "
                f"{w.shape[0]} devices")
        tri = self.tri
        nc = self.n_cells
        cells = np.empty(d, dtype=np.int64)
        best = np.empty(d, dtype=np.float64)
        if nc == 0:
            cells[:] = -1
            best[:] = self.cloud_only_time_all(b1, b2)
            ms = (time.perf_counter() - t0) * 1e3
            return TriFleetDecision(self, b1, b2, cells, best, ms)
        chunk = max(1, min(_TRI_FLEET_CHUNK, d))
        ebuf = np.empty((chunk, nc))
        cbuf = np.empty((chunk, nc))
        tbuf = np.empty((chunk, nc))
        for lo in range(0, d, chunk):
            hi = min(lo + chunk, d)
            e = ebuf[:hi - lo]
            # Device-tier term recomputed from the (w, flops) scalars
            # with the scalar space's exact ops: ((w*q)/F) * k_dev.
            np.multiply(w[lo:hi, None], self.cum1A[None, :], out=e)
            e /= flops[lo:hi, None]
            e *= tri.k_dev
            e += self.midclA[None, :]
            c = cbuf[:hi - lo]
            # cost = s2/BW2 + s1/BW1 + base — the scalar decide's order.
            np.divide(self.s2A[None, :], b2[lo:hi, None], out=c)
            t = tbuf[:hi - lo]
            np.divide(self.s1A[None, :], b1[lo:hi, None], out=t)
            c += t
            c += e
            rr = c.argmin(axis=1)
            cells[lo:hi] = rr
            best[lo:hi] = c[np.arange(hi - lo), rr]
        infeasible = np.isinf(best)
        if infeasible.any():
            cells[infeasible] = -1
            best[infeasible] = self.cloud_only_time_all(
                b1[infeasible], b2[infeasible])
        ms = (time.perf_counter() - t0) * 1e3
        return TriFleetDecision(self, b1, b2, cells, best, ms)

    def stage_times_all(self, cell: np.ndarray,
                        devices: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized ``TriPlanSpace.stage_times``: raw (T_dev, T_es,
        T_cl) per device for one held cell each (-1 = cloud-only)."""
        c = np.asarray(cell, dtype=np.int64)
        co = c < 0
        if self.n_cells == 0:          # empty kept grid: all cloud-only
            z = np.zeros(c.shape[0])
            return z, z.copy(), np.full(c.shape[0], self.cloud_only_exec)
        safe = np.where(co, 0, c)
        w, flops = self._gather_wf(devices)
        dev_t = w * self.cum1A[safe] / flops
        dev_t = np.where(co, 0.0, dev_t)
        es_t = np.where(co, 0.0, self.midA_raw[safe])
        cl_t = np.where(co, self.cloud_only_exec, self.clA_raw[safe])
        return dev_t, es_t, cl_t

    def plan_cost_all(self, cell: np.ndarray, bw1: np.ndarray,
                      bw2: np.ndarray,
                      devices: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized ``TriPlanSpace.plan_cost``: objective of one held
        cell per device at per-device bandwidths — the fleet hysteresis
        check reads this."""
        c = np.asarray(cell, dtype=np.int64)
        b1 = np.asarray(bw1, dtype=np.float64)
        b2 = np.asarray(bw2, dtype=np.float64)
        co = c < 0
        if self.n_cells == 0:          # empty kept grid: all cloud-only
            return self.cloud_only_time_all(b1, b2)
        safe = np.where(co, 0, c)
        w, flops = self._gather_wf(devices)
        e = w * self.cum1A[safe] / flops
        e *= self.tri.k_dev
        e += self.midclA[safe]
        cost = self.s2A[safe] / b2
        cost += self.s1A[safe] / b1
        cost += e
        if co.any():
            cost = np.where(co, self.cloud_only_time_all(b1, b2), cost)
        return cost


__all__: List[str] = [
    "TriPlanSpace", "TriFleetPlanSpace", "TriFleetDecision",
    "TriStreamPlanTerms", "solve_tri_enumeration",
]
