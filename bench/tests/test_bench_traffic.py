"""The frozen traffic generators against the port's, and the closed loop's
fixed work a block."""
import numpy as np
import pytest

from bench.traffic import closed_chat, fleet_open

workloads = pytest.importorskip("repro_torch.serving.workloads")


@pytest.mark.parametrize("kind,seed", [("steady", 0), ("steady", 2**31 + 7),
                                       ("diurnal", 5), ("flash_crowd", 13)])
def test_make_trace_is_the_ports(kind, seed):
    kw = dict(kind=kind, dt_s=0.05, base_rate=0.3, mean_bps=20e6,
              spread=4.0, sigma=0.15, hi_bps=200e6)
    ours = fleet_open.make_trace(16, 60, seed=seed, **kw)
    theirs = workloads.make_trace(16, 60, seed=seed, **kw)
    for name in ("bw_walks", "rates", "arrival_s", "device_ids",
                 "bandwidths"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    assert ours.flash_window_s == theirs.flash_window_s


def test_schedule_offers_the_cells_rate():
    mix = {"kind": "fleet_open", "trace": "steady", "n_devices": 16,
           "dt_s": 0.05, "rate_per_s": 100.0, "mean_bps": 20e6}
    tr = fleet_open.schedule(mix, 3, 40.0)
    assert abs(tr.n_requests / 40.0 - 100.0) < 5.0
    assert tr.arrival_s.max() < 40.0
    with pytest.raises(ValueError):
        fleet_open.schedule(dict(mix, rate_per_s=400.0), 3, 1.0)


def test_chat_blocks_hold_the_same_lengths():
    mix = {"clients": 32, "prompt_tokens": [128, 2048],
           "output_tokens": [32, 256]}
    blocks = []
    for seed in (1, 2**33 + 5):
        reqs = closed_chat.Requests(mix, seed, 50304)
        draws = [reqs.next() for _ in range(64)]
        blocks.append([(len(t), o) for t, o in draws])
        assert all(1 <= t.min() and t.max() < 50304 for t, _ in draws)
    for got in blocks:
        for b in (got[:32], got[32:]):
            assert sorted(p for p, _ in b) == sorted(
                closed_chat.log_uniform_grid(128, 2048, 32).tolist())
            assert sorted(o for _, o in b) == sorted(
                closed_chat.log_uniform_grid(32, 256, 32).tolist())
    assert blocks[0] != blocks[1]
    again = closed_chat.Requests(mix, 1, 50304)
    first = [again.next() for _ in range(3)]
    ref = closed_chat.Requests(mix, 1, 50304)
    for (t, o), (t2, o2) in zip(first, (ref.next() for _ in range(3))):
        np.testing.assert_array_equal(t, t2)
        assert o == o2
