"""The decoupling decision ILP (paper Sec. III-E).

    min   sum_ic (T_E_i + T_C_i + T_trans_ic) x_ic
    s.t.  sum_ic x_ic = 1
          sum_ic A_i(c) x_ic <= delta_alpha
          x_ic in {0, 1}

With N*C binary variables and the pick-exactly-one structure this is a
fixed-dimension ILP (Lenstra 1983) — solvable in polynomial time. We ship
two solvers that must agree (tested):

* ``solve_enumeration`` — O(N*C) exhaustive scan (the paper's observation
  that the problem is tiny; their desktop solves it in 1.77 ms).
* ``solve_branch_and_bound`` — a generic 0-1 branch-and-bound over the same
  formulation, with an admissible lower bound (min unconstrained cost of
  the remaining choices). Exercises the ILP machinery properly and scales
  to extensions with more constraints (e.g. edge-memory limits).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ILPProblem:
    """Cost/constraint tables. ``cost[i, c]`` is the total latency Z of
    choosing decoupling point i with bits-choice index c; ``acc_drop[i, c]``
    the predicted accuracy drop; ``budget`` is delta_alpha."""

    cost: np.ndarray          # (N, C) float
    acc_drop: np.ndarray      # (N, C) float
    budget: float
    # Optional extra resource constraint rows: usage[k, i, c] <= limits[k].
    usage: Optional[np.ndarray] = None    # (K, N, C)
    limits: Optional[np.ndarray] = None   # (K,)

    def feasible(self) -> np.ndarray:
        ok = self.acc_drop <= self.budget
        if self.usage is not None:
            for k in range(self.usage.shape[0]):
                ok &= self.usage[k] <= self.limits[k]
        return ok


@dataclass(frozen=True)
class ILPSolution:
    point: int                # i*
    bits_index: int           # c*
    objective: float
    solve_ms: float
    nodes: int = 0


def solve_enumeration(p: ILPProblem) -> Optional[ILPSolution]:
    t0 = time.perf_counter()
    ok = p.feasible()
    if not ok.any():
        return None
    cost = np.where(ok, p.cost, np.inf)
    idx = int(np.argmin(cost))
    i, c = np.unravel_index(idx, cost.shape)
    return ILPSolution(int(i), int(c), float(cost[i, c]),
                       (time.perf_counter() - t0) * 1e3)


def solve_branch_and_bound(p: ILPProblem) -> Optional[ILPSolution]:
    """Best-first branch-and-bound on the choice variable.

    Nodes fix a prefix of rows to "not chosen" and branch on choosing a
    concrete (i, c) from the next row or skipping the row. The bound for a
    subtree is the unconstrained minimum cost among remaining rows — always
    <= any feasible completion, hence admissible."""
    t0 = time.perf_counter()
    n, c = p.cost.shape
    ok = p.feasible()
    row_min = np.array([
        np.min(np.where(ok[i], p.cost[i], np.inf)) for i in range(n)
    ])
    suffix_min = np.full(n + 1, np.inf)
    for i in range(n - 1, -1, -1):
        suffix_min[i] = min(row_min[i], suffix_min[i + 1])
    best: Optional[Tuple[float, int, int]] = None
    nodes = 0
    heap = [(suffix_min[0], 0)]      # (bound, next_row)
    while heap:
        bound, row = heapq.heappop(heap)
        nodes += 1
        if best is not None and bound >= best[0]:
            break                     # best-first: done
        if row >= n:
            continue
        # Branch A: choose some (row, c).
        for cc in range(c):
            if ok[row, cc]:
                cost = float(p.cost[row, cc])
                if best is None or cost < best[0]:
                    best = (cost, row, cc)
        # Branch B: skip this row entirely.
        if row + 1 <= n and suffix_min[row + 1] < (
            best[0] if best else np.inf
        ):
            heapq.heappush(heap, (float(suffix_min[row + 1]), row + 1))
    if best is None:
        return None
    return ILPSolution(best[1], best[2], best[0],
                       (time.perf_counter() - t0) * 1e3, nodes)


def solve(p: ILPProblem, method: str = "enumeration") -> Optional[ILPSolution]:
    if method == "enumeration":
        return solve_enumeration(p)
    if method == "bnb":
        return solve_branch_and_bound(p)
    raise ValueError(method)
