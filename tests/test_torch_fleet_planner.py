"""Parity of the port's fleet decision plane with the reference's.

``FleetPlanSpace`` and ``FleetAdaptationController`` of both packages get
the same tables, device profiles and bandwidths, made with numpy from a
seed. Tolerance: none. ``decide_all``, ``stage_times_all``,
``plan_cost_all`` and the controller's state are float64 numpy in both
packages, computed by the same operations in the same order, so every
array must be bitwise equal (``np.array_equal``), including over device
subsets, infeasible budgets and cloud-only fallbacks. The port's decisions
must also equal D scalar ``with_edge(p).decide(bw)`` calls of its own.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.config import types as jtypes  # noqa: E402
from repro.core import adaptation as jadapt  # noqa: E402
from repro.core import latency as jlatency  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.serving.workloads import make_trace as jmake_trace  # noqa: E402
from repro_torch.config import types as ttypes  # noqa: E402
from repro_torch.core import adaptation as tadapt  # noqa: E402
from repro_torch.core import latency as tlatency  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import predictor as tpredictor  # noqa: E402

SEEDS = range(6)


def random_space(pkg, seed, budget=None):
    """(PlanSpace of ``pkg``) over random tables; both packages get the
    same arrays for the same seed."""
    types, latency, predictor, planner = pkg
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    c = int(rng.integers(1, 5))
    k = int(rng.integers(1, 4))
    fmacs = rng.random(n) * 1e9 + 1e8
    lat = latency.LatencyModel(fmacs, types.EDGE_TX2, types.CLOUD_1080TI,
                               input_bytes=150_528.0)
    tables = predictor.PredictorTables(
        points=[f"p{i}" for i in range(n)],
        bits_choices=[2 + i for i in range(c)],
        codecs=[f"codec{i}" for i in range(k)],
        acc_drop=rng.random((n, c, k)) * 0.3,
        size_bytes=rng.random((n, c, k)) * 1e6 + 1e3,
        base_accuracy=0.9,
    )
    budget = budget if budget is not None else float(rng.random() * 0.3)
    return planner.PlanSpace.build(tables, lat, budget)


def random_profiles(types, seed, d):
    rng = np.random.default_rng(seed ^ 0x5EED)
    return [types.DeviceProfile(f"dev-{i}", float(rng.uniform(1e11, 8e12)),
                                float(rng.uniform(0.7, 1.6)))
            for i in range(d)]


def random_bandwidths(seed, d):
    # Starved links to fiber: mid-grid and extreme argmins, and the
    # cloud-only transfer term.
    return 10 ** np.random.default_rng(seed ^ 0xBA0D).uniform(3.0, 8.5, d)


JPKG = (jtypes, jlatency, jpredictor, jplanner)
TPKG = (ttypes, tlatency, tpredictor, tplanner)


def both_fleets(seed, d, budget=None):
    jspace = random_space(JPKG, seed, budget=budget)
    tspace = random_space(TPKG, seed, budget=budget)
    jfleet = jplanner.FleetPlanSpace.build(
        jspace, random_profiles(jtypes, seed, d))
    tprofiles = random_profiles(ttypes, seed, d)
    tfleet = tplanner.FleetPlanSpace.build(tspace, tprofiles)
    return jfleet, tfleet, tspace, tprofiles


def plan_key(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


@pytest.mark.parametrize("budget", (None, -1.0))
@pytest.mark.parametrize("seed", SEEDS)
def test_decide_all_matches_reference_and_scalar_oracle(seed, budget):
    d = int(np.random.default_rng(seed ^ 0xD).integers(1, 40))
    jfleet, tfleet, tspace, tprofiles = both_fleets(seed, d, budget)
    bws = random_bandwidths(seed, d)
    got, want = tfleet.decide_all(bws), jfleet.decide_all(bws)
    assert np.array_equal(got.flat_j, want.flat_j)
    assert np.array_equal(got.cost, want.cost)
    assert np.array_equal(tfleet.j_star, jfleet.j_star)
    assert np.array_equal(tfleet.s_star, jfleet.s_star)
    if budget is not None:
        assert np.all(got.flat_j == tadapt.CLOUD_ONLY)
    for i, plan in enumerate(got.plans()):
        ref = tspace.with_edge(tprofiles[i]).decide(float(bws[i]))
        assert plan_key(plan) == plan_key(ref) == plan_key(want.plan(i))
        assert plan.is_cloud_only == ref.is_cloud_only


@pytest.mark.parametrize("seed", SEEDS)
def test_decide_all_over_device_subsets(seed):
    rng = np.random.default_rng(seed ^ 0x5B)
    d = int(rng.integers(2, 30))
    jfleet, tfleet, _, _ = both_fleets(seed, d)
    bws = random_bandwidths(seed, d)
    sub = np.sort(rng.choice(d, size=int(rng.integers(1, d + 1)),
                             replace=False))
    got = tfleet.decide_all(bws[sub], devices=sub)
    want = jfleet.decide_all(bws[sub], devices=sub)
    assert np.array_equal(got.flat_j, want.flat_j)
    assert np.array_equal(got.cost, want.cost)
    full = tfleet.decide_all(bws)
    assert np.array_equal(got.flat_j, full.flat_j[sub])
    assert np.array_equal(got.cost, full.cost[sub])


@pytest.mark.parametrize("seed", SEEDS)
def test_stage_times_and_plan_cost_match_reference(seed):
    d = int(np.random.default_rng(seed ^ 0x57).integers(1, 25))
    jfleet, tfleet, _, _ = both_fleets(seed, d, budget=(
        -1.0 if seed % 3 == 0 else None))
    bws = random_bandwidths(seed, d)
    flat = tfleet.decide_all(bws).flat_j
    # Held plans decided under other bandwidths: every cell kind,
    # cloud-only included.
    held = np.where(np.arange(d) % 4 == 0, tadapt.CLOUD_ONLY,
                    tfleet.decide_all(bws[::-1].copy()).flat_j)
    for cells in (flat, held):
        for got, want in zip(tfleet.stage_times_all(cells),
                             jfleet.stage_times_all(cells)):
            assert np.array_equal(got, want)
        assert np.array_equal(tfleet.plan_cost_all(cells, bws),
                              jfleet.plan_cost_all(cells, bws))
    sub = np.arange(0, d, 2)
    assert np.array_equal(
        tfleet.plan_cost_all(flat[sub], bws[sub], sub),
        jfleet.plan_cost_all(flat[sub], bws[sub], sub))
    assert np.array_equal(tfleet.cloud_only_time_all(bws),
                          jfleet.cloud_only_time_all(bws))
    assert np.array_equal(tfleet.edge_mat, jfleet.edge_mat)


def test_build_forms_views_and_validation():
    jfleet, tfleet, tspace, tprofiles = both_fleets(123, 9)
    flops = np.array([p.flops for p in tprofiles])
    w = np.array([p.w for p in tprofiles])
    bws = random_bandwidths(123, 9)
    raw = tplanner.FleetPlanSpace.build(tspace, flops=flops, w=w)
    a, b = tfleet.decide_all(bws), raw.decide_all(bws)
    assert np.array_equal(a.flat_j, b.flat_j)
    assert np.array_equal(a.cost, b.cost)
    assert raw.profile(2).flops == tprofiles[2].flops
    view = tfleet.device_view(1)
    assert view.size_flat is tspace.size_flat
    assert view.acc_flat is tspace.acc_flat
    assert np.array_equal(tfleet.edge_mat[1], view.edge_vec)
    assert tfleet.edge_mat is tfleet.edge_mat       # built once, cached
    assert not tfleet.edge_mat.flags.writeable
    with pytest.raises(ValueError):
        tplanner.FleetPlanSpace.build(tspace, tprofiles, flops=flops)
    with pytest.raises(ValueError):
        tplanner.FleetPlanSpace.build(tspace, flops=flops, w=w[:3])
    with pytest.raises(ValueError):
        tplanner.FleetPlanSpace.build(tspace, flops=0 * flops, w=w)
    with pytest.raises(ValueError):
        tplanner.FleetPlanSpace.build(tspace)
    with pytest.raises(ValueError):
        tfleet.decide_all(np.ones(3))


def test_decide_all_chunks_match_one_pass(monkeypatch):
    """The chunked loop (``_FLEET_CHUNK`` devices at a time) gives the
    same bits as one pass over the fleet."""
    _, tfleet, _, _ = both_fleets(7, 37)
    bws = random_bandwidths(7, 37)
    whole = tfleet.decide_all(bws)
    monkeypatch.setattr(tplanner, "_FLEET_CHUNK", 5)
    chunked = tfleet.decide_all(bws)
    assert np.array_equal(whole.flat_j, chunked.flat_j)
    assert np.array_equal(whole.cost, chunked.cost)


# ---------------------------------------------------------------------------
# FleetAdaptationController, event for event
# ---------------------------------------------------------------------------


def paper_fleets(seed, d):
    """Both packages' fleets over a space with the paper's trade-off:
    early cuts ship big boundaries, deep cuts geometrically smaller ones,
    so the argmin walks down the network as the link degrades and a flash
    crowd forces switches. The 4-bit column is over budget everywhere."""
    rng = np.random.default_rng(seed)
    n, bits = 14, [4, 8]
    fmacs = rng.uniform(2e8, 6e8, n)
    i = np.arange(n)[:, None, None]
    b = np.array(bits)[None, :, None]
    size = np.broadcast_to(1e6 * (0.5 ** i) * (b / 8.0), (n, 2, 1)).copy()
    acc = np.broadcast_to(np.where(b == 8, 0.05 + 0.005 * i, 0.5),
                          (n, 2, 1)).copy()
    out = []
    for types, latency, predictor, planner in (JPKG, TPKG):
        lat = latency.LatencyModel(fmacs, types.EDGE_TX2,
                                   types.CLOUD_1080TI, input_bytes=150_528.0)
        tables = predictor.PredictorTables(
            points=[f"p{j}" for j in range(n)], bits_choices=bits,
            codecs=["huffman"], acc_drop=acc, size_bytes=size,
            base_accuracy=0.9)
        space = planner.PlanSpace.build(tables, lat, 0.2)
        out.append(planner.FleetPlanSpace.build(
            space, random_profiles(types, seed, d)))
    return out


def events(ctrl, d):
    return [(e.step, e.bandwidth,
             None if e.old_plan is None else plan_key(e.old_plan),
             plan_key(e.new_plan)) for e in ctrl.history_for(d)]


@pytest.mark.parametrize("max_history", (None, 2))
@pytest.mark.parametrize("seed", range(4))
def test_fleet_controller_matches_reference_over_a_flash_crowd(seed,
                                                               max_history):
    """A flash-crowd trace drives both controllers: each step advances the
    devices that fire in it (explicit bandwidths), then feeds transfers to
    the EWMA (some invalid), then advances every device from its own
    estimate. State, histories and switch counts must be equal."""
    d = 6
    jfleet, tfleet = paper_fleets(seed, d)
    jc = jadapt.FleetAdaptationController(jfleet, default_bw=1e6,
                                          max_history=max_history)
    tc = tadapt.FleetAdaptationController(tfleet, default_bw=1e6,
                                          max_history=max_history)
    trace = jmake_trace(d, 30, seed=seed, kind="flash_crowd",
                        mean_bps=2e6, flash_bw_drop=16.0)
    rng = np.random.default_rng(seed ^ 0xE3)
    for t in range(trace.n_steps):
        sel = np.nonzero(trace.step_ids == t)[0]
        dv = trace.device_ids[sel]
        for ctrl in (jc, tc):
            if dv.size:
                ctrl.current_plans(trace.bandwidths[sel], dv)
        nbytes = rng.uniform(-1e4, 1e6, d)
        secs = rng.uniform(-0.01, 0.5, d)
        tc.observe_transfers(nbytes, secs)
        jc.observe_transfers(nbytes, secs)
        tj, tl = tc.current_plans()
        jj, jl = jc.current_plans()
        assert np.array_equal(tj, jj) and np.array_equal(tl, jl)
        for name in ("bw_est", "plan_j", "plan_lat", "plan_acc", "steps"):
            assert np.array_equal(getattr(tc, name), getattr(jc, name),
                                  equal_nan=name == "bw_est"), name
    assert tc.switch_count() == jc.switch_count() >= 1
    assert len(tc.history) == len(jc.history)
    if max_history is not None:
        assert len(tc.history) == max_history
        assert tc._evicted_switches == jc._evicted_switches > 0
    for dd in range(d):
        assert events(tc, dd) == events(jc, dd)
        got, want = tc.plan_for(dd), jc.plan_for(dd)
        assert plan_key(got) == plan_key(want)


def test_fleet_controller_cloud_only_and_initial_state():
    jfleet, tfleet, _, _ = both_fleets(42, 5, budget=-1.0)
    tc = tadapt.FleetAdaptationController(tfleet, default_bw=1e6)
    jc = jadapt.FleetAdaptationController(jfleet, default_bw=1e6)
    assert np.all(tc.plan_j == tadapt.NO_PLAN)
    assert np.all(np.isnan(tc.bw_est))
    assert tc.plan_for(0) is None and tc.history_for(0) == []
    assert tc.switch_count() == 0
    bws = random_bandwidths(42, 5)
    tc.current_plans(bws)
    jc.current_plans(bws)
    assert np.all(tc.plan_j == tadapt.CLOUD_ONLY)
    assert np.array_equal(tc.plan_lat, jc.plan_lat)
    assert tc.plan_for(3).is_cloud_only
    assert tc.switch_count() == 0                 # initial commits only
    rec = tc.history[0]
    assert isinstance(rec, tadapt.FleetAdaptationRecord)
    assert np.all(rec.old_j == tadapt.NO_PLAN)
