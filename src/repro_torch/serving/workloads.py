"""Trace-shaped fleet workloads: diurnal load, bandwidth walks, flash crowds.

The fleet server is only as believable as the traffic driving it. This
module generates seed-deterministic, trace-shaped request streams instead
of hand-built request lists:

* **Diurnal load curves** — per-step request probability follows a
  day-shaped sinusoid (the classic serving-traffic pattern), so fleets
  see load peaks and troughs rather than uniform arrivals.
* **Per-device bandwidth walks** — each device's link follows a bounded
  log-space random walk (multiplicative jitter, heterogeneous starting
  rates), the Fig. 8 scenario generalized from one device to D.
* **Flash crowds** — a window where arrival rates spike while link
  bandwidth collapses (everyone on the same congested cell), the event
  that forces fleet-wide re-decoupling.

Everything derives from one ``np.random.default_rng(seed)`` stream, so a
trace is reproducible from ``(params, seed)`` alone on any host. The
draws are taken in the reference's order (``repro.serving.workloads``),
so both packages make bit-identical traces from the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.fleet import FleetRequest

BatchFactory = Callable[[int, int], Any]   # (request uid, device id) -> batch


def diurnal_rates(n_steps: int, *, base: float = 0.15, peak: float = 0.85,
                  period_steps: Optional[int] = None,
                  phase: float = 0.0) -> np.ndarray:
    """Per-step request probability following a day curve: a raised
    sinusoid from ``base`` (night trough) to ``peak`` (daytime), one full
    period over ``period_steps`` (default: the whole trace)."""
    if n_steps <= 0:
        return np.zeros(0)
    period = period_steps or n_steps
    t = np.arange(n_steps)
    wave = 0.5 * (1.0 - np.cos(2.0 * np.pi * (t / period + phase)))
    return np.clip(base + (peak - base) * wave, 0.0, 1.0)


def bandwidth_walks(n_devices: int, n_steps: int, *, seed: int,
                    mean_bps: float = 1e6, sigma: float = 0.15,
                    spread: float = 4.0, lo_bps: float = 32e3,
                    hi_bps: float = 32e6,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(T, D) per-device link-bandwidth series: bounded multiplicative
    random walks. Devices start log-uniform in ``[mean/spread,
    mean*spread]`` (heterogeneous links) and take i.i.d. log-normal steps
    of scale ``sigma``, clamped step-by-step to ``[lo_bps, hi_bps]``."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    lo, hi = np.log(lo_bps), np.log(hi_bps)
    log_bw = np.empty((n_steps, n_devices))
    log_bw[0] = np.clip(
        np.log(mean_bps) + rng.uniform(-np.log(spread), np.log(spread),
                                       n_devices),
        lo, hi)
    for t in range(1, n_steps):
        log_bw[t] = np.clip(log_bw[t - 1] + rng.normal(0.0, sigma,
                                                       n_devices), lo, hi)
    return np.exp(log_bw)


@dataclass(frozen=True)
class FleetTrace:
    """A materialized fleet workload: per-device bandwidth series plus a
    flattened, arrival-ordered request stream over them."""

    seed: int
    dt_s: float                       # seconds per trace step
    bw_walks: np.ndarray              # (T, D) per-device bandwidth series
    rates: np.ndarray                 # (T,) per-device request probability
    arrival_s: np.ndarray             # (R,) sorted arrival times
    device_ids: np.ndarray            # (R,) device of each request
    step_ids: np.ndarray              # (R,) trace step of each request
    bandwidths: np.ndarray            # (R,) true link bandwidth per request
    flash_window_s: Optional[Tuple[float, float]] = None
    # Three-tier traces: the edge-server -> cloud backhaul, an independent
    # walk per device's serving edge server. None = two-tier trace.
    bw2_walks: Optional[np.ndarray] = None    # (T, D) second-link series
    bandwidths2: Optional[np.ndarray] = None  # (R,) second link per request

    @property
    def has_link2(self) -> bool:
        return self.bw2_walks is not None

    @property
    def n_steps(self) -> int:
        return int(self.bw_walks.shape[0])

    @property
    def n_devices(self) -> int:
        return int(self.bw_walks.shape[1])

    @property
    def n_requests(self) -> int:
        return int(self.arrival_s.shape[0])

    @property
    def duration_s(self) -> float:
        return self.n_steps * self.dt_s

    def in_flash_window(self, t_s: np.ndarray) -> np.ndarray:
        """Boolean mask of times inside the flash-crowd window."""
        if self.flash_window_s is None:
            return np.zeros(np.shape(t_s), dtype=bool)
        lo, hi = self.flash_window_s
        t = np.asarray(t_s, dtype=np.float64)
        return (t >= lo) & (t < hi)

    def requests(self, batch_factory: Optional[BatchFactory] = None
                 ) -> List[FleetRequest]:
        """Materialize the stream as FleetRequests (arrival order).
        ``batch_factory(uid, device_id)`` supplies real model inputs;
        without it, ``batch=None`` — enough for decision-plane runs."""
        out = []
        for uid in range(self.n_requests):
            d = int(self.device_ids[uid])
            out.append(FleetRequest(
                uid=uid,
                device_id=d,
                batch=batch_factory(uid, d) if batch_factory else None,
                bandwidth=float(self.bandwidths[uid]),
                arrival_s=float(self.arrival_s[uid]),
                bandwidth2=(float(self.bandwidths2[uid])
                            if self.bandwidths2 is not None else 0.0),
            ))
        return out


def make_trace(n_devices: int, n_steps: int, *, seed: int,
               kind: str = "steady", dt_s: float = 0.05,
               base_rate: float = 0.3, peak_rate: float = 0.9,
               mean_bps: float = 1e6, sigma: float = 0.15,
               spread: float = 4.0, lo_bps: float = 32e3,
               hi_bps: float = 32e6,
               flash_start: float = 0.5, flash_len: float = 0.2,
               flash_bw_drop: float = 8.0,
               flash_load_spike: float = 3.0,
               link2: bool = False, mean2_bps: float = 20e6,
               sigma2: float = 0.10, spread2: float = 2.0,
               lo2_bps: float = 1e6, hi2_bps: float = 200e6) -> FleetTrace:
    """Generate a seed-deterministic fleet trace.

    ``kind``:
      * ``"steady"`` — constant per-step request probability
        ``base_rate``, bandwidth walks only;
      * ``"diurnal"`` — request probability follows ``diurnal_rates``
        (one day-period over the trace);
      * ``"flash_crowd"`` — steady load, then a window starting at
        ``flash_start`` (fraction of the trace) of length ``flash_len``
        where arrival probability multiplies by ``flash_load_spike`` and
        every device's bandwidth divides by ``flash_bw_drop``.

    ``link2=True`` makes the trace three-tier drivable: a second,
    independent family of bounded walks (the edge-server -> cloud
    backhaul — faster, steadier, tighter spread by default) drawn from
    the SAME rng stream, immediately after the first-link walks and
    before arrival sampling. Two-tier traces (``link2=False``) consume
    exactly the rng draws they always did, so existing seeds reproduce
    bit-identical traces. A flash crowd congests the cellular uplink
    only; the backhaul walk is untouched.
    """
    if kind not in ("steady", "diurnal", "flash_crowd"):
        raise ValueError(f"unknown trace kind {kind!r}")
    rng = np.random.default_rng(seed)
    walks = bandwidth_walks(n_devices, n_steps, seed=seed,
                            mean_bps=mean_bps, sigma=sigma, spread=spread,
                            lo_bps=lo_bps, hi_bps=hi_bps, rng=rng)
    walks2 = None
    if link2:
        walks2 = bandwidth_walks(n_devices, n_steps, seed=seed,
                                 mean_bps=mean2_bps, sigma=sigma2,
                                 spread=spread2, lo_bps=lo2_bps,
                                 hi_bps=hi2_bps, rng=rng)
    if kind == "diurnal":
        rates = diurnal_rates(n_steps, base=base_rate, peak=peak_rate)
    else:
        rates = np.full(n_steps, base_rate)
    flash_window = None
    if kind == "flash_crowd":
        t0 = int(n_steps * flash_start)
        t1 = min(n_steps, t0 + max(1, int(n_steps * flash_len)))
        walks = walks.copy()
        walks[t0:t1] /= flash_bw_drop
        rates = rates.copy()
        rates[t0:t1] = np.clip(rates[t0:t1] * flash_load_spike, 0.0, 1.0)
        flash_window = (t0 * dt_s, t1 * dt_s)
    # Arrival sampling: per step, each device fires with prob rates[t];
    # a request's arrival jitters uniformly inside its step so the
    # stream is not lock-step synchronized across the fleet.
    arrivals, devices, steps, bws, bws2 = [], [], [], [], []
    for t in range(n_steps):
        active = np.nonzero(rng.random(n_devices) < rates[t])[0]
        if active.size == 0:
            continue
        jitter = rng.random(active.size) * dt_s
        arrivals.append(t * dt_s + jitter)
        devices.append(active)
        steps.append(np.full(active.size, t, dtype=np.int64))
        bws.append(walks[t, active])
        if walks2 is not None:
            bws2.append(walks2[t, active])
    if arrivals:
        arrival_s = np.concatenate(arrivals)
        device_ids = np.concatenate(devices)
        step_ids = np.concatenate(steps)
        bandwidths = np.concatenate(bws)
        # arrival order, ties broken by device id (stable per-device FIFO:
        # each device fires at most once per step, and steps are ordered)
        order = np.lexsort((device_ids, arrival_s))
        arrival_s, device_ids = arrival_s[order], device_ids[order]
        step_ids, bandwidths = step_ids[order], bandwidths[order]
        bandwidths2 = (np.concatenate(bws2)[order]
                       if walks2 is not None else None)
    else:
        arrival_s = np.zeros(0)
        device_ids = np.zeros(0, dtype=np.int64)
        step_ids = np.zeros(0, dtype=np.int64)
        bandwidths = np.zeros(0)
        bandwidths2 = np.zeros(0) if walks2 is not None else None
    return FleetTrace(
        seed=seed, dt_s=dt_s, bw_walks=walks, rates=rates,
        arrival_s=arrival_s, device_ids=device_ids, step_ids=step_ids,
        bandwidths=bandwidths, flash_window_s=flash_window,
        bw2_walks=walks2, bandwidths2=bandwidths2,
    )


__all__ = [
    "BatchFactory",
    "FleetTrace",
    "bandwidth_walks",
    "diurnal_rates",
    "make_trace",
]
