"""Parity of the port's trace generator with the reference's.

``make_trace`` draws everything from one ``np.random.default_rng(seed)``
stream; the port takes the same draws in the same order, so every array of
a trace (bandwidth walks, rates, arrivals, devices, steps, per-request
bandwidths, the second link's walks) must be bit-identical to the
reference's for every ``kind``, with and without ``link2``. Tolerance:
none (``np.array_equal``).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import workloads as jw  # noqa: E402
from repro_torch.serving import workloads as tw  # noqa: E402

ARRAYS = ("bw_walks", "rates", "arrival_s", "device_ids", "step_ids",
          "bandwidths", "bw2_walks", "bandwidths2")


def assert_traces_equal(got, want):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            assert np.array_equal(a, b), name
    assert got.flash_window_s == want.flash_window_s
    assert (got.seed, got.dt_s, got.n_steps, got.n_devices, got.n_requests,
            got.has_link2) == (want.seed, want.dt_s, want.n_steps,
                               want.n_devices, want.n_requests,
                               want.has_link2)


@pytest.mark.parametrize("link2", (False, True))
@pytest.mark.parametrize("kind", ("steady", "diurnal", "flash_crowd"))
@pytest.mark.parametrize("seed", (0, 13))
def test_make_trace_is_bit_identical(seed, kind, link2):
    kw = dict(seed=seed, kind=kind, link2=link2)
    if kind == "flash_crowd":
        kw.update(mean_bps=2e6, flash_bw_drop=16.0)
    got, want = tw.make_trace(6, 40, **kw), jw.make_trace(6, 40, **kw)
    assert want.n_requests > 0
    assert_traces_equal(got, want)
    t = np.linspace(0.0, got.duration_s, 17)
    assert np.array_equal(got.in_flash_window(t), want.in_flash_window(t))
    reqs = got.requests(lambda uid, d: (uid, d))
    jreqs = want.requests(lambda uid, d: (uid, d))
    assert len(reqs) == len(jreqs) == got.n_requests
    for r, jr in zip(reqs, jreqs):
        assert (r.uid, r.device_id, r.batch, r.bandwidth, r.arrival_s,
                r.bandwidth2) == (jr.uid, jr.device_id, jr.batch,
                                  jr.bandwidth, jr.arrival_s, jr.bandwidth2)
        assert isinstance(r, tw.FleetRequest)


def test_walks_rates_and_empty_traces_are_bit_identical():
    kw = dict(seed=5, mean_bps=3e5, sigma=0.4, lo_bps=1e5, hi_bps=1e6)
    assert np.array_equal(tw.bandwidth_walks(4, 50, **kw),
                          jw.bandwidth_walks(4, 50, **kw))
    for n in (0, 1, 24):
        assert np.array_equal(tw.diurnal_rates(n, phase=0.25),
                              jw.diurnal_rates(n, phase=0.25))
    for link2 in (False, True):
        got = tw.make_trace(3, 10, seed=2, base_rate=0.0, link2=link2)
        assert got.n_requests == 0 and got.requests() == []
        assert_traces_equal(got, jw.make_trace(3, 10, seed=2, base_rate=0.0,
                                               link2=link2))
    with pytest.raises(ValueError):
        tw.make_trace(2, 4, seed=0, kind="bursty")
    trace = tw.make_trace(2, 4, seed=0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        trace.seed = 1
