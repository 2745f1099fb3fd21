"""Edge-cloud structure adaptation (paper Sec. III-E, last paragraph).

The controller watches the measured bandwidth (EWMA over observed
transfers), re-solves the decision when conditions drift, and
"synchronizes" the edge and cloud onto the new decoupling. Re-decoupling is
hysteretic: it switches only when the predicted latency of the new plan
beats the current plan's predicted latency at the *current* bandwidth by
``switch_margin``. The fleet-vectorized controller is not ported yet.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.core.decoupler import DecoupledPlan, JaladEngine


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
