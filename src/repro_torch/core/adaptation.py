"""Edge-cloud structure adaptation (paper Sec. III-E, last paragraph).

The controller watches the measured bandwidth (EWMA over observed
transfers), re-solves the decision when conditions drift, and
"synchronizes" the edge and cloud onto the new decoupling. Re-decoupling is
hysteretic: it switches only when the predicted latency of the new plan
beats the current plan's predicted latency at the *current* bandwidth by
``switch_margin``.

Two implementations of the same state machine live here:

* :class:`AdaptationController`, the scalar original, one device per
  instance (the single-device servers use it);
* :class:`FleetAdaptationController`, the vectorized form over ``(D,)``
  bandwidth / plan arrays on a :class:`~repro_torch.core.planner.
  FleetPlanSpace`, which replaces the per-device controller loop inside
  the fleet server. It makes the same plan / switch sequence as D
  independent scalar controllers, event for event.

:class:`TriFleetAdaptationController` is the fleet form over the
three-tier two-cut index (one EWMA a link), for the three-tier server.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.decoupler import DecoupledPlan, JaladEngine
from repro_torch.core.planner import FleetPlanSpace
from repro_torch.core.tri_planner import TriFleetPlanSpace


@dataclass
class BandwidthEstimator:
    """EWMA of observed bytes/sec."""

    alpha: float = 0.3
    estimate: Optional[float] = None

    def observe(self, nbytes: float, seconds: float) -> Optional[float]:
        if seconds <= 0.0 or nbytes <= 0.0:
            # A zero/negative duration (clock skew, cached transfer) or an
            # empty transfer carries no rate information; folding it in
            # would poison the EWMA with an infinite/garbage sample.
            return self.estimate
        sample = nbytes / seconds
        if self.estimate is None:
            self.estimate = sample
        else:
            self.estimate = (
                self.alpha * sample + (1 - self.alpha) * self.estimate
            )
        return self.estimate


@dataclass
class AdaptationEvent:
    step: int
    bandwidth: float
    old_plan: Optional[DecoupledPlan]
    new_plan: DecoupledPlan


@dataclass
class AdaptationController:
    engine: JaladEngine
    switch_margin: float = 0.05       # relative latency gain required
    # Current bandwidth estimate. NB: the annotation makes this a real
    # dataclass field (per-instance, in __init__/repr/eq); without it,
    # ``bw = None`` silently declared a class attribute shared by every
    # controller.
    bw: Optional[float] = None
    plan: Optional[DecoupledPlan] = None
    history: List[AdaptationEvent] = field(default_factory=list)
    _estimator: BandwidthEstimator = field(default_factory=BandwidthEstimator)
    _step: int = 0
    # Re-decoupling listeners, called (outside the lock, on the replanning
    # thread) with each AdaptationEvent as it is committed. The pipelined
    # server uses this to register the new (point, bits) runner in its
    # shared cache and to log plan switches against its simulated clock.
    # The lock makes observe/replan safe when the link stage and the edge
    # stage run on different threads.
    _listeners: List[Callable[[AdaptationEvent], None]] = field(
        default_factory=list
    )
    _lock: threading.RLock = field(default_factory=threading.RLock)
    # Retain at most this many events (None = unbounded). Long-running
    # serving commits an event per plan switch forever; the cap evicts
    # oldest-first while ``switch_count`` keeps counting evicted switches.
    max_history: Optional[int] = None
    _switches: int = 0
    # Events committed by the in-flight call, drained by current_plan to
    # fire listeners (an index into ``history`` would shift under the
    # max_history eviction).
    _pending_events: List[AdaptationEvent] = field(default_factory=list)

    def add_listener(self, fn: Callable[[AdaptationEvent], None]) -> None:
        self._listeners.append(fn)

    def switch_count(self) -> int:
        """Committed re-decouplings (excluding the initial plan commit),
        counted across the full run — eviction never loses switches."""
        return self._switches

    def _commit(self, event: AdaptationEvent) -> None:
        self.history.append(event)
        self._pending_events.append(event)
        if event.old_plan is not None:
            self._switches += 1
        if self.max_history is not None and \
                len(self.history) > self.max_history:
            del self.history[:len(self.history) - self.max_history]
        self.plan = event.new_plan

    def observe_transfer(self, nbytes: float, seconds: float
                         ) -> Optional[float]:
        with self._lock:
            self.bw = self._estimator.observe(nbytes, seconds)
            return self.bw

    def current_plan(self, bandwidth: Optional[float] = None) -> DecoupledPlan:
        """Return the active plan, re-deciding if conditions warrant."""
        with self._lock:
            plan = self._current_plan_locked(bandwidth)
            fired = self._pending_events
            self._pending_events = []
        for event in fired:      # listeners run unlocked: they may be slow
            for fn in self._listeners:
                fn(event)
        return plan

    def _current_plan_locked(self, bandwidth: Optional[float]
                             ) -> DecoupledPlan:
        self._step += 1
        bw = bandwidth if bandwidth is not None else self.bw
        if bw is None:
            bw = self.engine.cfg.bandwidth_bytes_per_s
        candidate = self.engine.decide(bw)
        if self.plan is None:
            self._commit(AdaptationEvent(self._step, bw, None, candidate))
            return self.plan
        if candidate.point == self.plan.point and \
                candidate.bits == self.plan.bits and \
                candidate.codec == self.plan.codec:
            return self.plan
        # Predicted latency of keeping the old plan under the NEW bandwidth
        # — the engine's PlanSpace is the single Z(i,c,k,BW) implementation.
        old_cost = self.engine.plan_space.plan_cost(self.plan, bw)
        if candidate.predicted_latency < old_cost * (1 - self.switch_margin):
            self._commit(AdaptationEvent(self._step, bw, self.plan,
                                         candidate))
        return self.plan


# ---------------------------------------------------------------------------
# Vectorized fleet adaptation: D hysteresis state machines, one array op
# ---------------------------------------------------------------------------

# plan_j sentinels (the flat (N, C*K) cell index is always >= 0)
NO_PLAN = -2          # device has not committed a first plan yet
CLOUD_ONLY = -1       # the paper's x_NC = 1 fallback


@dataclass(frozen=True)
class FleetAdaptationRecord:
    """One committing round of the fleet controller, held as arrays: the
    AdaptationEvents of every device that committed in that round.
    ``old_j == NO_PLAN`` marks initial commits (scalar ``old_plan is
    None``)."""

    devices: np.ndarray               # (K,) device ids that committed
    steps: np.ndarray                 # (K,) per-device step counters
    bandwidths: np.ndarray            # (K,) bandwidth decided under
    old_j: np.ndarray                 # (K,) previous plan cell (NO_PLAN)
    old_lat: np.ndarray               # (K,) previous predicted latency
    old_acc: np.ndarray               # (K,) previous predicted acc drop
    new_j: np.ndarray                 # (K,) committed plan cell
    new_lat: np.ndarray               # (K,) committed predicted latency
    new_acc: np.ndarray               # (K,) committed predicted acc drop


@dataclass
class FleetAdaptationController:
    """The :class:`AdaptationController` state machine vectorized over a
    fleet: per-device EWMA bandwidth estimates, current-plan cells and
    hysteresis checks live in ``(D,)`` arrays, and one call to
    ``current_plans`` advances every (selected) device with a single
    fused ``FleetPlanSpace.decide_all`` — no per-device Python.

    Semantics are pinned to D independent scalar controllers sharing the
    same ``switch_margin``/EWMA ``alpha``: identical plan/switch
    sequences, event for event, over arbitrary bandwidth walks (the
    regression test drives jitter, step changes and flash-crowd drops).
    Unlike the scalar controller this one is not thread-safe — the fleet
    server advances it from one thread.
    """

    fleet: FleetPlanSpace
    switch_margin: float = 0.05
    alpha: float = 0.3                   # EWMA factor (BandwidthEstimator)
    default_bw: float = 1e6              # used when nothing observed yet
    history: List[FleetAdaptationRecord] = field(default_factory=list)
    # Retain at most this many committing rounds (None = unbounded);
    # oldest rounds are evicted whole. ``switch_count`` stays exact under
    # eviction (evicted switches are folded into a counter);
    # ``history_for`` returns the retained (most recent) events only.
    max_history: Optional[int] = None
    _evicted_switches: int = 0
    # (D,) state arrays, allocated in __post_init__
    bw_est: np.ndarray = field(default=None, repr=False)
    plan_j: np.ndarray = field(default=None, repr=False)
    plan_lat: np.ndarray = field(default=None, repr=False)
    plan_acc: np.ndarray = field(default=None, repr=False)
    steps: np.ndarray = field(default=None, repr=False)
    _plan_cache: Dict[int, DecoupledPlan] = field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        d = self.fleet.n_devices
        self.bw_est = np.full(d, np.nan)
        self.plan_j = np.full(d, NO_PLAN, dtype=np.int64)
        self.plan_lat = np.zeros(d)
        self.plan_acc = np.zeros(d)
        self.steps = np.zeros(d, dtype=np.int64)

    @property
    def n_devices(self) -> int:
        return self.fleet.n_devices

    # ------------------------------------------------------------ observe
    def observe_transfers(self, nbytes, seconds, devices=None) -> None:
        """Vectorized ``BandwidthEstimator.observe`` over the fleet (or a
        ``devices`` subset): invalid samples (zero/negative duration or
        empty transfer) leave the per-device estimate untouched."""
        dv = (slice(None) if devices is None
              else np.asarray(devices, dtype=np.int64))
        nb = np.asarray(nbytes, dtype=np.float64)
        sec = np.asarray(seconds, dtype=np.float64)
        valid = (sec > 0.0) & (nb > 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            sample = nb / sec
        prev = self.bw_est[dv]
        # same float64 ops as the scalar EWMA: a*s + (1-a)*est
        ewma = self.alpha * sample + (1 - self.alpha) * prev
        updated = np.where(np.isnan(prev), sample, ewma)
        self.bw_est[dv] = np.where(valid, updated, prev)

    # ------------------------------------------------------------- decide
    def current_plans(self, bandwidths=None, devices=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the selected devices one step and return their active
        ``(plan_j, predicted_latency)`` arrays.

        Per device this is exactly ``AdaptationController.current_plan``:
        bandwidth = given | EWMA estimate | default; one candidate solve
        (here: the fleet-wide fused argmin); first call commits; a
        changed candidate commits only if it beats the held plan's cost
        at the new bandwidth by ``switch_margin``.
        """
        dv = (np.arange(self.n_devices, dtype=np.int64) if devices is None
              else np.asarray(devices, dtype=np.int64))
        self.steps[dv] += 1
        if bandwidths is None:
            est = self.bw_est[dv]
            bw = np.where(np.isnan(est), self.default_bw, est)
        else:
            bw = np.asarray(bandwidths, dtype=np.float64)
        decision = self.fleet.decide_all(bw, dv)
        cand_j, cand_lat = decision.flat_j, decision.cost
        cand_acc = self._acc_of(cand_j)

        cur_j = self.plan_j[dv]
        fresh = cur_j == NO_PLAN
        changed = ~fresh & (cand_j != cur_j)
        commit = fresh.copy()
        if changed.any():
            old_cost = self.fleet.plan_cost_all(
                cur_j[changed], bw[changed], dv[changed])
            # scalar hysteresis, verbatim: cand < old * (1 - margin)
            beats = (cand_lat[changed]
                     < old_cost * (1 - self.switch_margin))
            commit[changed] = beats
        if commit.any():
            self._commit(dv, bw, cand_j, cand_lat, cand_acc, commit)
        return self.plan_j[dv], self.plan_lat[dv]

    def _acc_of(self, flat_j: np.ndarray) -> np.ndarray:
        co = flat_j < 0
        safe = np.where(co, 0, flat_j)
        rows, cols = np.divmod(safe, self.fleet.space.n_choices)
        return np.where(co, 0.0, self.fleet.space.acc_flat[rows, cols])

    def _commit(self, dv, bw, cand_j, cand_lat, cand_acc, mask) -> None:
        idx = dv[mask]
        self.history.append(FleetAdaptationRecord(
            devices=idx,
            steps=self.steps[idx].copy(),
            bandwidths=bw[mask].copy(),
            old_j=self.plan_j[idx].copy(),
            old_lat=self.plan_lat[idx].copy(),
            old_acc=self.plan_acc[idx].copy(),
            new_j=cand_j[mask].copy(),
            new_lat=cand_lat[mask].copy(),
            new_acc=cand_acc[mask].copy(),
        ))
        if self.max_history is not None and \
                len(self.history) > self.max_history:
            evict = len(self.history) - self.max_history
            for rec in self.history[:evict]:
                self._evicted_switches += int((rec.old_j != NO_PLAN).sum())
            del self.history[:evict]
        self.plan_j[idx] = cand_j[mask]
        self.plan_lat[idx] = cand_lat[mask]
        self.plan_acc[idx] = cand_acc[mask]
        if len(idx) >= len(self._plan_cache):
            self._plan_cache.clear()
        else:
            for d in idx:
                self._plan_cache.pop(int(d), None)

    # -------------------------------------------------------------- views
    def _materialize(self, j: int, lat: float, acc: float) -> DecoupledPlan:
        space = self.fleet.space
        if j < 0:
            return DecoupledPlan(-1, 0, lat, 0.0, 0.0)
        i, jj = divmod(j, space.n_choices)
        ci, ki = divmod(jj, len(space.codecs))
        return DecoupledPlan(
            point=space.point_rows[i], bits=space.bits_choices[ci],
            predicted_latency=lat, predicted_acc_drop=acc, solve_ms=0.0,
            codec=space.codecs[ki],
        )

    def plan_for(self, d: int) -> Optional[DecoupledPlan]:
        """The device's active plan as a DecoupledPlan (cached; None
        before the first commit)."""
        j = int(self.plan_j[d])
        if j == NO_PLAN:
            return None
        plan = self._plan_cache.get(d)
        if plan is None:
            plan = self._materialize(j, float(self.plan_lat[d]),
                                     float(self.plan_acc[d]))
            self._plan_cache[d] = plan
        return plan

    def history_for(self, d: int) -> List[AdaptationEvent]:
        """Materialize one device's event sequence — shaped exactly like
        the scalar controller's ``history`` (``old_plan is None`` on the
        initial commit). Test/inspection path, not the hot path."""
        events: List[AdaptationEvent] = []
        for rec in self.history:
            hits = np.nonzero(rec.devices == d)[0]
            for k in hits:
                old = None
                if rec.old_j[k] != NO_PLAN:
                    old = self._materialize(int(rec.old_j[k]),
                                            float(rec.old_lat[k]),
                                            float(rec.old_acc[k]))
                events.append(AdaptationEvent(
                    step=int(rec.steps[k]),
                    bandwidth=float(rec.bandwidths[k]),
                    old_plan=old,
                    new_plan=self._materialize(int(rec.new_j[k]),
                                               float(rec.new_lat[k]),
                                               float(rec.new_acc[k])),
                ))
        return events

    def switch_count(self) -> int:
        """Committed re-decouplings across the fleet, excluding each
        device's initial plan commit. Exact across the full run even when
        ``max_history`` has evicted old rounds."""
        return self._evicted_switches + sum(
            int((rec.old_j != NO_PLAN).sum()) for rec in self.history)


# ---------------------------------------------------------------------------
# Three-tier fleet adaptation: two links, one fused two-cut re-plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TriFleetAdaptationRecord:
    """One committing round of the three-tier fleet controller. Shaped
    like :class:`FleetAdaptationRecord` with one bandwidth column per
    link; ``old_c``/``new_c`` index the fleet's kept-cell table
    (:class:`~repro_torch.core.tri_planner.TriFleetPlanSpace`), with the same
    NO_PLAN / CLOUD_ONLY sentinels."""

    devices: np.ndarray
    steps: np.ndarray
    bandwidths1: np.ndarray
    bandwidths2: np.ndarray
    old_c: np.ndarray
    old_lat: np.ndarray
    old_acc: np.ndarray
    new_c: np.ndarray
    new_lat: np.ndarray
    new_acc: np.ndarray


@dataclass
class TriFleetAdaptationController:
    """The fleet hysteresis state machine over the flattened two-cut
    index: per-device EWMA estimates for BOTH links, current plan cells
    on a :class:`~repro_torch.core.tri_planner.TriFleetPlanSpace`, and one
    fused ``decide_all(BW1, BW2)`` per round. The commit rule is the
    scalar controller's, verbatim: first decision commits; a changed
    candidate commits only if it beats the held cell's objective at the
    new bandwidths by ``switch_margin``. ``max_history`` bounds the
    record list exactly like :class:`FleetAdaptationController`."""

    fleet: TriFleetPlanSpace
    switch_margin: float = 0.05
    alpha: float = 0.3
    default_bw1: float = 1e6
    default_bw2: float = 20e6
    history: List[TriFleetAdaptationRecord] = field(default_factory=list)
    max_history: Optional[int] = None
    bw1_est: np.ndarray = field(default=None, repr=False)
    bw2_est: np.ndarray = field(default=None, repr=False)
    plan_c: np.ndarray = field(default=None, repr=False)
    plan_lat: np.ndarray = field(default=None, repr=False)
    plan_acc: np.ndarray = field(default=None, repr=False)
    steps: np.ndarray = field(default=None, repr=False)
    _plan_cache: Dict[int, DecoupledPlan] = field(
        default_factory=dict, repr=False)
    _evicted_switches: int = 0

    def __post_init__(self):
        d = self.fleet.n_devices
        self.bw1_est = np.full(d, np.nan)
        self.bw2_est = np.full(d, np.nan)
        self.plan_c = np.full(d, NO_PLAN, dtype=np.int64)
        self.plan_lat = np.zeros(d)
        self.plan_acc = np.zeros(d)
        self.steps = np.zeros(d, dtype=np.int64)

    @property
    def n_devices(self) -> int:
        return self.fleet.n_devices

    # ------------------------------------------------------------ observe
    def observe_transfers(self, nbytes, seconds, devices=None, *,
                          link: int = 1) -> None:
        """Per-link vectorized EWMA: ``link=1`` feeds the device →
        edge-server estimate, ``link=2`` the edge-server → cloud one.
        Invalid samples leave the estimate untouched."""
        if link not in (1, 2):
            raise ValueError(f"link must be 1 or 2, got {link}")
        est = self.bw1_est if link == 1 else self.bw2_est
        dv = (slice(None) if devices is None
              else np.asarray(devices, dtype=np.int64))
        nb = np.asarray(nbytes, dtype=np.float64)
        sec = np.asarray(seconds, dtype=np.float64)
        valid = (sec > 0.0) & (nb > 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            sample = nb / sec
        prev = est[dv]
        ewma = self.alpha * sample + (1 - self.alpha) * prev
        updated = np.where(np.isnan(prev), sample, ewma)
        est[dv] = np.where(valid, updated, prev)

    # ------------------------------------------------------------- decide
    def current_plans(self, bandwidths1=None, bandwidths2=None,
                      devices=None) -> Tuple[np.ndarray, np.ndarray]:
        """Advance the selected devices one step and return their active
        ``(cell, predicted_objective)`` arrays."""
        dv = (np.arange(self.n_devices, dtype=np.int64) if devices is None
              else np.asarray(devices, dtype=np.int64))
        self.steps[dv] += 1
        if bandwidths1 is None:
            est = self.bw1_est[dv]
            b1 = np.where(np.isnan(est), self.default_bw1, est)
        else:
            b1 = np.asarray(bandwidths1, dtype=np.float64)
        if bandwidths2 is None:
            est = self.bw2_est[dv]
            b2 = np.where(np.isnan(est), self.default_bw2, est)
        else:
            b2 = np.asarray(bandwidths2, dtype=np.float64)
        decision = self.fleet.decide_all(b1, b2, dv)
        cand_c, cand_lat = decision.cell, decision.cost
        cand_acc = self._acc_of(cand_c)

        cur_c = self.plan_c[dv]
        fresh = cur_c == NO_PLAN
        changed = ~fresh & (cand_c != cur_c)
        commit = fresh.copy()
        if changed.any():
            old_cost = self.fleet.plan_cost_all(
                cur_c[changed], b1[changed], b2[changed], dv[changed])
            beats = (cand_lat[changed]
                     < old_cost * (1 - self.switch_margin))
            commit[changed] = beats
        if commit.any():
            self._commit(dv, b1, b2, cand_c, cand_lat, cand_acc, commit)
        return self.plan_c[dv], self.plan_lat[dv]

    def _acc_of(self, cell: np.ndarray) -> np.ndarray:
        co = cell < 0
        if self.fleet.n_cells == 0:      # all-infeasible: only cloud-only
            return np.zeros(cell.shape[0])
        safe = np.where(co, 0, cell)
        return np.where(co, 0.0, self.fleet.accA[safe])

    def _commit(self, dv, b1, b2, cand_c, cand_lat, cand_acc,
                mask) -> None:
        idx = dv[mask]
        self.history.append(TriFleetAdaptationRecord(
            devices=idx,
            steps=self.steps[idx].copy(),
            bandwidths1=b1[mask].copy(),
            bandwidths2=b2[mask].copy(),
            old_c=self.plan_c[idx].copy(),
            old_lat=self.plan_lat[idx].copy(),
            old_acc=self.plan_acc[idx].copy(),
            new_c=cand_c[mask].copy(),
            new_lat=cand_lat[mask].copy(),
            new_acc=cand_acc[mask].copy(),
        ))
        if self.max_history is not None and \
                len(self.history) > self.max_history:
            evict = len(self.history) - self.max_history
            for rec in self.history[:evict]:
                self._evicted_switches += int((rec.old_c != NO_PLAN).sum())
            del self.history[:evict]
        self.plan_c[idx] = cand_c[mask]
        self.plan_lat[idx] = cand_lat[mask]
        self.plan_acc[idx] = cand_acc[mask]
        if len(idx) >= len(self._plan_cache):
            self._plan_cache.clear()
        else:
            for d in idx:
                self._plan_cache.pop(int(d), None)

    # -------------------------------------------------------------- views
    def _materialize(self, c: int, lat: float, acc: float) -> DecoupledPlan:
        fl = self.fleet
        if c < 0:
            return DecoupledPlan(-1, 0, lat, 0.0, 0.0)
        tri = fl.tri
        bits1, codec1 = tri._choice(int(fl.j1A[c]))
        bits2, codec2 = tri._choice(int(fl.j2A[c]))
        return DecoupledPlan(
            point=tri.point_rows[fl.i1A[c]], bits=bits1,
            predicted_latency=lat, predicted_acc_drop=acc, solve_ms=0.0,
            codec=codec1, point2=tri.point_rows[fl.i2A[c]], bits2=bits2,
            codec2=codec2,
        )

    def plan_for(self, d: int) -> Optional[DecoupledPlan]:
        c = int(self.plan_c[d])
        if c == NO_PLAN:
            return None
        plan = self._plan_cache.get(d)
        if plan is None:
            plan = self._materialize(c, float(self.plan_lat[d]),
                                     float(self.plan_acc[d]))
            self._plan_cache[d] = plan
        return plan

    def history_for(self, d: int) -> List[AdaptationEvent]:
        """One device's retained event sequence (bandwidth = link 1's;
        the record keeps both columns)."""
        events: List[AdaptationEvent] = []
        for rec in self.history:
            hits = np.nonzero(rec.devices == d)[0]
            for k in hits:
                old = None
                if rec.old_c[k] != NO_PLAN:
                    old = self._materialize(int(rec.old_c[k]),
                                            float(rec.old_lat[k]),
                                            float(rec.old_acc[k]))
                events.append(AdaptationEvent(
                    step=int(rec.steps[k]),
                    bandwidth=float(rec.bandwidths1[k]),
                    old_plan=old,
                    new_plan=self._materialize(int(rec.new_c[k]),
                                               float(rec.new_lat[k]),
                                               float(rec.new_acc[k])),
                ))
        return events

    def switch_count(self) -> int:
        """Committed re-decouplings across the fleet, exact under
        ``max_history`` eviction."""
        return self._evicted_switches + sum(
            int((rec.old_c != NO_PLAN).sum()) for rec in self.history)
