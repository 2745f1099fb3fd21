"""Kind ``fleet_burst``: an open loop of bursts of one-shot requests from a
fleet of edge devices, each on its own link: cameras that fire together
on one event.

Bursts fall at the times of a Poisson process, and each fires ``burst``
distinct devices, drawn from the seed, at one due time. The mean rate of
requests is the cell's ``rate_per_s``, so bursts come at ``rate_per_s /
burst`` a second. Each device's link follows ``fleet_open``'s seeded
bandwidth walk, a step of ``dt_s``; a request takes its device's
bandwidth at the step of its due time.

The loop is ``fleet_open``'s: whenever the harness is free it hands every
request already due to one call into the program, and times each from
its due time to its answer on the host; arrivals stop at the window's
end and the loop serves what is still due. Warm-up serves whole bursts
of another schedule of the mix, as fast as the program goes."""
from __future__ import annotations

import time

import numpy as np

from bench.traffic.fleet_open import Trace, bandwidth_walks

WALK_KEYS = ("mean_bps", "sigma", "spread", "lo_bps", "hi_bps")


def schedule(mix: dict, seed: int, seconds: float) -> Trace:
    """The bursts of ``seconds`` of the mix at its ``rate_per_s``: each
    request's due time, device and bandwidth, sorted by due time."""
    n, burst, dt = mix["n_devices"], mix["burst"], float(mix["dt_s"])
    rate = float(mix["rate_per_s"])
    if not 1 <= burst <= n or rate <= 0:
        raise ValueError(f"bursts of {burst} from {n} devices at "
                         f"{rate}/s cannot be drawn")
    rng = np.random.default_rng(seed)
    n_steps = max(1, int(round(seconds / dt)))
    walks = bandwidth_walks(n, n_steps, seed=seed, rng=rng,
                            **{k: mix[k] for k in WALK_KEYS if k in mix})
    times = []
    t = rng.exponential(burst / rate)
    while t < seconds:
        times.append(t)
        t += rng.exponential(burst / rate)
    devices = [np.sort(rng.choice(n, burst, replace=False)) for _ in times]
    arrival_s = np.repeat(np.asarray(times, np.float64), burst)
    device_ids = (np.concatenate(devices) if devices
                  else np.zeros(0, np.int64))
    steps = np.minimum((arrival_s / dt).astype(np.int64), n_steps - 1)
    return Trace(dt_s=dt, bw_walks=walks,
                 rates=np.full(n_steps, rate * dt / n),
                 arrival_s=arrival_s, device_ids=device_ids,
                 bandwidths=walks[steps, device_ids])


def drive(system, mix: dict, seed: int, seconds: float, rec) -> None:
    """Offer the window's bursts to ``system`` and record into ``rec``, as
    ``fleet_open.drive`` does its arrivals: ``serve(uids, devices,
    bandwidths)`` returns one meta dict a call, its ``answered`` the uids
    answered; a request left unanswered has failed."""
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
        with rec.span("serve", t0) as meta:
            meta.update(system.serve(np.arange(i, j), tr.device_ids[i:j],
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
    """Serve ``warm_s`` seconds of another schedule of the mix, one whole
    burst a call: the plans its links pick, in the window's wave sizes."""
    tr = schedule(mix, seed + 1, mix["warm_s"])
    step = mix["burst"]
    for i in range(0, tr.n_requests, step):
        system.serve(np.arange(i, i + step) - tr.n_requests,
                     tr.device_ids[i:i + step], tr.bandwidths[i:i + step])
