"""Kind ``fleet_open``: an open loop of one-shot requests from a fleet of
edge devices, each on its own link.

The trace is the port's ``serving/workloads.py`` ``make_trace``, copied
and frozen (its two-link variant left out): seeded bandwidth walks, and
steady, diurnal or flash-crowd arrivals. Every device fires with
probability ``base_rate`` a step of ``dt_s`` seconds, so the mean offered
rate is ``n_devices * base_rate / dt_s``; a cell gives that rate as
``rate_per_s`` and the loop derives ``base_rate`` from it.

The loop: whenever the harness is free it hands every request already due
to one call into the program; requests that fall due during a call wait
for the next. A request is timed from its due time on the schedule to its
answer on the host. Arrivals stop at the window's end, and the loop
serves what is still due (the drain), timed the same way."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def diurnal_rates(n_steps: int, *, base: float = 0.15, peak: float = 0.85,
                  period_steps: Optional[int] = None,
                  phase: float = 0.0) -> np.ndarray:
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
class Trace:
    dt_s: float
    bw_walks: np.ndarray              # (T, D)
    rates: np.ndarray                 # (T,)
    arrival_s: np.ndarray             # (R,) sorted
    device_ids: np.ndarray            # (R,)
    bandwidths: np.ndarray            # (R,)
    flash_window_s: Optional[Tuple[float, float]] = None

    @property
    def n_requests(self) -> int:
        return int(self.arrival_s.shape[0])


def make_trace(n_devices: int, n_steps: int, *, seed: int,
               kind: str = "steady", dt_s: float = 0.05,
               base_rate: float = 0.3, peak_rate: float = 0.9,
               mean_bps: float = 1e6, sigma: float = 0.15,
               spread: float = 4.0, lo_bps: float = 32e3,
               hi_bps: float = 32e6,
               flash_start: float = 0.5, flash_len: float = 0.2,
               flash_bw_drop: float = 8.0,
               flash_load_spike: float = 3.0) -> Trace:
    if kind not in ("steady", "diurnal", "flash_crowd"):
        raise ValueError(f"unknown trace kind {kind!r}")
    rng = np.random.default_rng(seed)
    walks = bandwidth_walks(n_devices, n_steps, seed=seed,
                            mean_bps=mean_bps, sigma=sigma, spread=spread,
                            lo_bps=lo_bps, hi_bps=hi_bps, rng=rng)
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
    arrivals, devices, bws = [], [], []
    for t in range(n_steps):
        active = np.nonzero(rng.random(n_devices) < rates[t])[0]
        if active.size == 0:
            continue
        jitter = rng.random(active.size) * dt_s
        arrivals.append(t * dt_s + jitter)
        devices.append(active)
        bws.append(walks[t, active])
    if arrivals:
        arrival_s = np.concatenate(arrivals)
        device_ids = np.concatenate(devices)
        bandwidths = np.concatenate(bws)
        order = np.lexsort((device_ids, arrival_s))
        arrival_s, device_ids = arrival_s[order], device_ids[order]
        bandwidths = bandwidths[order]
    else:
        arrival_s = np.zeros(0)
        device_ids = np.zeros(0, dtype=np.int64)
        bandwidths = np.zeros(0)
    return Trace(dt_s=dt_s, bw_walks=walks, rates=rates, arrival_s=arrival_s,
                 device_ids=device_ids, bandwidths=bandwidths,
                 flash_window_s=flash_window)


TRACE_KEYS = ("kind", "dt_s", "peak_rate", "mean_bps", "sigma", "spread",
              "lo_bps", "hi_bps", "flash_start", "flash_len",
              "flash_bw_drop", "flash_load_spike")


def schedule(mix: dict, seed: int, seconds: float) -> Trace:
    """The window's trace: ``seconds`` of steps of the mix's trace at its
    ``rate_per_s``."""
    dt = float(mix["dt_s"])
    n = mix["n_devices"]
    base = float(mix["rate_per_s"]) * dt / n
    if not 0.0 < base <= 1.0:
        raise ValueError(f"rate {mix['rate_per_s']}/s needs a per-step "
                         f"probability of {base}; shorten dt_s")
    kw = {k: mix[k] for k in TRACE_KEYS if k in mix}
    kw["kind"] = mix["trace"]
    return make_trace(n, max(1, int(round(seconds / dt))), seed=seed,
                      base_rate=base, **kw)


def drive(system, mix: dict, seed: int, seconds: float, rec) -> None:
    """Offer the window's trace to ``system`` (``serve(uids, devices,
    bandwidths)`` returning one meta dict a call, its ``answered`` the
    uids answered) and record into ``rec``: each answered request's
    latency, each call's span. A request left unanswered has failed."""
    tr = schedule(mix, seed, seconds)
    n = tr.n_requests
    rec.attempted = n
    clock = time.perf_counter
    t0 = clock()
    rec.window_start = t0
    i = 0
    while i < n:
        now = clock() - t0
        if tr.arrival_s[i] > now:
            time.sleep(min(tr.arrival_s[i] - now, 0.05))
            continue
        j = int(np.searchsorted(tr.arrival_s, now, side="right"))
        uids = np.arange(i, j)
        with rec.span("serve", t0) as meta:
            meta.update(system.serve(uids, tr.device_ids[i:j],
                                     tr.bandwidths[i:j]))
        span = rec.spans[-1]
        due = tr.arrival_s[np.asarray(span["answered"], np.int64)]
        rec.latencies_ms.extend(((span["t1"] - t0) - due) * 1e3)
        rec.late_ms.extend(((span["t0"] - t0) - tr.arrival_s[i:j]) * 1e3)
        i = j
    rec.window_end = t0 + seconds
    rec.drain_s = max(0.0, clock() - rec.window_end)
    rec.answered = len(rec.latencies_ms)


def warm(system, mix: dict, seed: int, rec) -> None:
    """Serve ``warm_s`` seconds of another trace of the mix, as fast as the
    program goes: the plans the window's links pick, on its shapes."""
    tr = schedule(mix, seed + 1, mix["warm_s"])
    step = max(1, int(math.ceil(float(mix["rate_per_s"]) * 0.05)))
    for i in range(0, tr.n_requests, step):
        system.serve(np.arange(i, min(i + step, tr.n_requests)) - tr.n_requests,
                     tr.device_ids[i:i + step], tr.bandwidths[i:i + step])
