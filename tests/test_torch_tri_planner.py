"""Parity of the port's three-tier decision plane with the reference's.

``TriPlanSpace``, ``TriFleetPlanSpace``, ``_pareto_keep`` and
``TriFleetAdaptationController`` of both packages get the same tables,
device profiles, power models and bandwidths, made with numpy from a seed
(as ``tests/test_tri_planner.py`` makes them). Tolerance: none. Both
packages compute the decision plane in float64 numpy by the same
operations in the same order, so every plan, objective, derived array,
fleet decision and controller history must be bitwise equal. The port's
decisions must also equal its own oracles: the brute-force
``solve_tri_enumeration``, the generic ILP solvers, D scalar solves on
per-device views, and, through the ``degenerate()`` view at ``BW1 = inf``,
its two-tier ``PlanSpace`` and ``FleetPlanSpace``.
"""
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.config import types as jtypes  # noqa: E402
from repro.core import adaptation as jadapt  # noqa: E402
from repro.core import latency as jlatency  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.core import tri_planner as jtri  # noqa: E402
from repro_torch.config import types as ttypes  # noqa: E402
from repro_torch.core import adaptation as tadapt  # noqa: E402
from repro_torch.core import ilp as tilp  # noqa: E402
from repro_torch.core import latency as tlatency  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import predictor as tpredictor  # noqa: E402
from repro_torch.core import tri_planner as ttri  # noqa: E402

SEEDS = range(8)
INF = float("inf")
JPKG = (jtypes, jlatency, jpredictor, jplanner, jtri)
TPKG = (ttypes, tlatency, tpredictor, tplanner, ttri)


def random_setup(pkg, seed, budget=None, energy_weight=None, ties=False):
    """(tables, latency, budget, edge server, power, λ) of ``pkg``, drawn
    from one seed; both packages get the same arrays for the same seed.
    ``ties`` draws the wire sizes from three values, so many cells tie
    exactly and the tie-break rules decide."""
    types, latency, predictor, _, _ = pkg
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 10))
    c = int(rng.integers(1, 4))
    codecs = [f"codec{i}" for i in range(int(rng.integers(1, 4)))]
    fmacs = rng.random(n) * 1e9 + 1e8
    lat = latency.LatencyModel(fmacs, types.EDGE_TX2, types.CLOUD_1080TI,
                               input_bytes=150_528.0)
    tables = predictor.PredictorTables(
        points=[f"p{i}" for i in range(n)],
        bits_choices=[2 + i for i in range(c)],
        codecs=codecs,
        acc_drop=rng.random((n, c, len(codecs))) * 0.3,
        size_bytes=rng.random((n, c, len(codecs))) * 1e6 + 1e3,
        base_accuracy=0.9,
    )
    if ties:
        tables.size_bytes = (rng.integers(1, 4, (n, c, len(codecs)))
                             * 1e5)
    budget = budget if budget is not None else float(rng.random() * 0.3)
    es = types.DeviceProfile("es", float(rng.uniform(5e11, 8e12)),
                             float(rng.uniform(0.7, 1.6)))
    power = types.TierPowerModel(
        device_w=float(rng.uniform(1, 10)),
        edge_server_w=float(rng.uniform(30, 120)),
        cloud_w=float(rng.uniform(100, 400)),
        tx1_w=float(rng.uniform(0.5, 3)),
        tx2_w=float(rng.uniform(1, 6)),
    )
    if energy_weight is None:
        energy_weight = float(rng.choice([0.0, rng.uniform(0.0, 50.0)]))
    return tables, lat, budget, es, power, energy_weight


def random_tri(pkg, seed, **kw):
    tables, lat, budget, es, power, lam = random_setup(pkg, seed, **kw)
    return pkg[4].TriPlanSpace.build(tables, lat, budget, edge_server=es,
                                     power=power, energy_weight=lam)


def both_tri(seed, **kw):
    return random_tri(JPKG, seed, **kw), random_tri(TPKG, seed, **kw)


def random_bandwidths(seed, k=2):
    rng = np.random.default_rng(seed ^ 0xB3)
    return [float(10 ** rng.uniform(3.0, 8.5)) for _ in range(k)]


def random_profiles(types, seed, d):
    rng = np.random.default_rng(seed ^ 0xD3)
    return [types.DeviceProfile(f"dev-{i}", float(rng.uniform(1e11, 8e12)),
                                float(rng.uniform(0.7, 1.6)))
            for i in range(d)]


def plan_key(p):
    return (p.point, p.bits, p.codec, p.point2, p.bits2, p.codec2,
            p.predicted_latency, p.predicted_acc_drop)


def plan_flat(tri, plan):
    q, j1, j2 = tri._cell_of_plan(plan)
    return (q * tri.n_inner + j1) * tri.n_inner + j2


def replace_device(tri, device):
    """Per-device scalar view: same pair grid, another first tier."""
    dev_vec = tplanner._readonly(device.w * tri.cum_fmacs / device.flops)
    return replace(tri, device=device, dev_vec=dev_vec,
                   mid_vec=None).finalize()


DERIVED = ("dev_vec", "cl_vec", "cum_fmacs", "size_flat", "acc_flat",
           "i1_idx", "i2_idx", "mid_vec", "midcl", "acc", "feasible",
           "size1_eff", "size2_eff", "base", "base_raw", "energy_base")


def assert_spaces_equal(t, j):
    for name in DERIVED:
        assert np.array_equal(getattr(t, name), getattr(j, name)), name
    for k in ("k_dev", "k_es", "k_cl", "k_tx1", "k_tx2"):
        assert getattr(t, k) == getattr(j, k), k


# ---------------------------------------------------------------------------
# the scalar space: decide against the reference and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_decide_matches_reference_and_bruteforce(seed):
    jt, tt = both_tri(seed)
    assert_spaces_equal(tt, jt)
    bw1, bw2 = random_bandwidths(seed)
    plan, want = tt.decide(bw1, bw2), jt.decide(bw1, bw2)
    assert plan_key(plan) == plan_key(want)
    ref = ttri.solve_tri_enumeration(tt, bw1, bw2)
    assert ref == jtri.solve_tri_enumeration(jt, bw1, bw2)
    if ref is None:
        assert plan.is_cloud_only
        assert plan.predicted_latency == tt.cloud_only_time(bw1, bw2)
        return
    f, cost = ref
    assert plan_flat(tt, plan) == f
    assert plan.predicted_latency == cost
    assert plan.predicted_acc_drop == float(tt.acc.flat[f])
    assert tt.plan_cost(plan, bw1, bw2) == cost == jt.plan_cost(want, bw1,
                                                                 bw2)
    assert tt.stage_times(plan) == jt.stage_times(want)
    assert tt.plan_sizes(plan) == jt.plan_sizes(want)
    assert tt.energy_of(plan, bw1, bw2) == jt.energy_of(want, bw1, bw2)


@pytest.mark.parametrize("seed", SEEDS)
def test_ilp_solvers_agree_with_decide(seed):
    """The port's ``ilp_problem`` holds the reference's cost cells, and
    its enumeration and branch-and-bound solvers pick the plan that
    ``decide`` picks, with and without an energy budget."""
    jt, tt = both_tri(seed)
    bw1, bw2 = random_bandwidths(seed)
    free = tt.decide(bw1, bw2)
    budgets = [None]
    if not free.is_cloud_only:
        rng = np.random.default_rng(seed ^ 0xE)
        budgets.append(tt.energy_of(free, bw1, bw2)
                       * float(rng.uniform(0.2, 1.2)))
    for eb in budgets:
        prob = tt.ilp_problem(bw1, bw2, energy_budget=eb)
        jprob = jt.ilp_problem(bw1, bw2, energy_budget=eb)
        assert np.array_equal(prob.cost, jprob.cost)
        assert np.array_equal(prob.acc_drop, jprob.acc_drop)
        if eb is not None:
            assert np.array_equal(prob.usage, jprob.usage)
        plan = tt.decide(bw1, bw2, energy_budget=eb)
        for solver in (tilp.solve_enumeration, tilp.solve_branch_and_bound):
            sol = solver(prob)
            if sol is None:
                assert plan.is_cloud_only
                continue
            got = tt.plan_from_solution(sol)
            assert plan_key(got)[:7] == plan_key(plan)[:7], solver.__name__


@pytest.mark.parametrize("seed", SEEDS)
def test_energy_budget_matches_reference_and_bruteforce(seed):
    jt, tt = both_tri(seed)
    bw1, bw2 = random_bandwidths(seed)
    free = tt.decide(bw1, bw2)
    if free.is_cloud_only:
        free = replace(free, point=0, bits=tt.bits_choices[0],
                       codec=tt.codecs[0], point2=0,
                       bits2=tt.bits_choices[0], codec2=tt.codecs[0])
    rng = np.random.default_rng(seed ^ 0xE)
    eb = tt.energy_of(free, bw1, bw2) * float(rng.uniform(0.2, 1.2))
    plan = tt.decide(bw1, bw2, energy_budget=eb)
    assert plan_key(plan) == plan_key(jt.decide(bw1, bw2, energy_budget=eb))
    assert np.array_equal(tt.energy_grid(bw1, bw2), jt.energy_grid(bw1, bw2))
    ref = ttri.solve_tri_enumeration(tt, bw1, bw2, energy_budget=eb)
    if ref is None:
        assert plan.is_cloud_only
        assert tt.cloud_only_energy(bw1, bw2) == \
            jt.cloud_only_energy(bw1, bw2)
    else:
        f, cost = ref
        assert plan_flat(tt, plan) == f
        assert plan.predicted_latency == cost
        assert tt.energy_of(plan, bw1, bw2) <= eb


@pytest.mark.parametrize("seed", SEEDS)
def test_infeasible_budget_is_cloud_only(seed):
    jt, tt = both_tri(seed, budget=-1.0)
    bw1, bw2 = random_bandwidths(seed)
    plan = tt.decide(bw1, bw2)
    assert plan.is_cloud_only and not plan.has_second_cut
    assert plan.predicted_latency == tt.cloud_only_time(bw1, bw2) == \
        jt.decide(bw1, bw2).predicted_latency
    assert tt.stage_times(plan) == (0.0, 0.0, tt.cloud_exec_full())
    assert tt.plan_sizes(plan) == (tt.input_bytes, tt.input_bytes)
    assert ttri.solve_tri_enumeration(tt, bw1, bw2) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_relay_cells_carry_a_single_boundary(seed):
    """Diagonal pairs: only ``j1 == j2`` cells are feasible, and their
    accuracy drop is the one boundary's, not doubled."""
    _, tt = both_tri(seed)
    ck = tt.n_inner
    acc = tt.acc.reshape(tt.n_pairs, ck, ck)
    diag = np.nonzero(tt.i1_idx == tt.i2_idx)[0]
    assert len(diag) == len(tt.point_rows)
    for q in diag:
        i = tt.i1_idx[q]
        for j in range(ck):
            assert acc[q, j, j] == tt.acc_flat[i, j]
        off = ~np.eye(ck, dtype=bool)
        assert np.all(np.isinf(acc[q][off]))
        assert tt.mid_vec[q] == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_with_streaming_waits_for_the_lm_stack(seed):
    """``with_streaming`` is ported: on the same tables (registered codecs
    on the codec axis) both packages' streaming terms price the same
    frames and decide the same plans, bitwise
    (``tests/test_torch_tri_stream.py`` holds the rest)."""
    from repro_torch.codec import list_codecs

    spaces = []
    for pkg in (JPKG, TPKG):
        tables, lat, budget, es, power, lam = random_setup(pkg, seed)
        tables.codecs = list(list_codecs())[: len(tables.codecs)]
        spaces.append(pkg[4].TriPlanSpace.build(
            tables, lat, budget, edge_server=es, power=power,
            energy_weight=lam))
    jterms, tterms = (sp.with_streaming(64, 16.0) for sp in spaces)
    assert isinstance(tterms, ttri.TriStreamPlanTerms)
    assert np.array_equal(tterms.token_bytes, jterms.token_bytes)
    bw1, bw2 = random_bandwidths(seed)
    for e_tok in (1.0, 64.0):
        assert plan_key(tterms.decide(bw1, bw2, e_tok)) == \
            plan_key(jterms.decide(bw1, bw2, e_tok))


# ---------------------------------------------------------------------------
# degenerate view == the port's two-tier planner, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_degenerate_reproduces_two_tier_bitwise(seed):
    tables, lat, budget, es, power, _ = random_setup(TPKG, seed)
    space = tplanner.PlanSpace.build(tables, lat, budget)
    deg = ttri.TriPlanSpace.build(tables, lat, budget, edge_server=es,
                                  power=power, energy_weight=0.0).degenerate()
    jdeg = random_tri(JPKG, seed, energy_weight=0.0).degenerate()
    assert_spaces_equal(deg, jdeg)
    bw = random_bandwidths(seed, 1)[0]
    got = deg.decide(INF, bw)
    ref = space.decide(bw)
    assert plan_key(got) == plan_key(jdeg.decide(INF, bw))
    assert got.predicted_latency == ref.predicted_latency
    assert got.predicted_acc_drop == ref.predicted_acc_drop
    if ref.is_cloud_only:
        assert got.is_cloud_only
        assert deg.cloud_only_time(INF, bw) == space.cloud_only_time(bw)
    else:
        assert (got.point, got.bits, got.codec) == \
            (ref.point, ref.bits, ref.codec)
        assert (got.point2, got.bits2, got.codec2) == \
            (ref.point, ref.bits, ref.codec)
        t_dev, t_es, t_cl = deg.stage_times(got)
        assert t_es == 0.0
        assert (t_dev, t_cl) == space.stage_times(ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_degenerate_fleet_reproduces_two_tier_fleet(seed):
    tables, lat, budget, es, power, _ = random_setup(TPKG, seed)
    space = tplanner.PlanSpace.build(tables, lat, budget)
    deg = ttri.TriPlanSpace.build(tables, lat, budget, edge_server=es,
                                  power=power, energy_weight=0.0).degenerate()
    d = int(np.random.default_rng(seed ^ 0xF1).integers(1, 20))
    profiles = random_profiles(ttypes, seed, d)
    bws = 10 ** np.random.default_rng(seed ^ 0xF2).uniform(3.0, 8.5, d)
    two = tplanner.FleetPlanSpace.build(space, profiles).decide_all(bws)
    tri = ttri.TriFleetPlanSpace.build(deg, profiles).decide_all(
        np.full(d, INF), bws)
    for i in range(d):
        a, b = tri.plan(i), two.plan(i)
        assert a.predicted_latency == b.predicted_latency, i
        if b.is_cloud_only:
            assert a.is_cloud_only, i
        else:
            assert (a.point, a.bits, a.codec) == \
                (b.point, b.bits, b.codec), i
            assert (a.point2, a.bits2, a.codec2) == \
                (b.point, b.bits, b.codec), i


# ---------------------------------------------------------------------------
# the fleet plane
# ---------------------------------------------------------------------------

FLEET_ARRAYS = ("w_vec", "flops_vec", "cum1A", "midclA", "s1A", "s2A",
                "i1A", "i2A", "j1A", "j2A", "accA", "flat_of_cell",
                "midA_raw", "clA_raw")


def both_fleets(seed, d, **kw):
    jt, tt = both_tri(seed, **kw)
    jf = jtri.TriFleetPlanSpace.build(jt, random_profiles(jtypes, seed, d))
    tprofiles = random_profiles(ttypes, seed, d)
    tf = ttri.TriFleetPlanSpace.build(tt, tprofiles)
    for name in FLEET_ARRAYS:
        assert np.array_equal(getattr(tf, name), getattr(jf, name)), name
    assert tf.cloud_only_exec == jf.cloud_only_exec
    return jf, tf, tt, tprofiles


@pytest.mark.parametrize("case", ("free", "infeasible", "ties"))
@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_decide_all_matches_reference_and_scalar_oracle(seed, case):
    rng = np.random.default_rng(seed ^ 0xD4)
    d = int(rng.integers(1, 25))
    kw = {"free": {}, "infeasible": {"budget": -1.0},
          "ties": {"ties": True, "budget": 0.6}}[case]
    jf, tf, tt, profiles = both_fleets(seed, d, **kw)
    bw1 = 10 ** rng.uniform(3.0, 8.5, d)
    bw2 = 10 ** rng.uniform(3.0, 8.5, d)
    got, want = tf.decide_all(bw1, bw2), jf.decide_all(bw1, bw2)
    assert np.array_equal(got.cell, want.cell)
    assert np.array_equal(got.cost, want.cost)
    cost = tf.plan_cost_all(got.cell, bw1, bw2)
    assert np.array_equal(cost, jf.plan_cost_all(want.cell, bw1, bw2))
    stages = tf.stage_times_all(got.cell)
    for a, b in zip(stages, jf.stage_times_all(want.cell)):
        assert np.array_equal(a, b)
    assert np.array_equal(tf.cloud_only_time_all(bw1, bw2),
                          jf.cloud_only_time_all(bw1, bw2))
    for i in range(d):
        view = replace_device(tt, profiles[i])
        ref = view.decide(float(bw1[i]), float(bw2[i]))
        plan = got.plan(i)
        assert plan_key(plan)[:7] == plan_key(ref)[:7], i
        assert plan_key(plan) == plan_key(want.plan(i)), i
        assert got.cost[i] == ref.predicted_latency, i
        assert cost[i] == view.plan_cost(ref, float(bw1[i]),
                                         float(bw2[i])), i
        assert tuple(s[i] for s in stages) == view.stage_times(ref), i
        if not ref.is_cloud_only:
            assert tf.flat_of_cell[got.cell[i]] == plan_flat(tt, ref), i


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_decide_all_over_device_subsets(seed):
    rng = np.random.default_rng(seed ^ 0x5B)
    d = int(rng.integers(2, 30))
    jf, tf, _, _ = both_fleets(seed, d)
    bw1 = 10 ** rng.uniform(3.0, 8.5, d)
    bw2 = 10 ** rng.uniform(3.0, 8.5, d)
    sub = np.sort(rng.choice(d, size=int(rng.integers(1, d + 1)),
                             replace=False))
    got = tf.decide_all(bw1[sub], bw2[sub], devices=sub)
    want = jf.decide_all(bw1[sub], bw2[sub], devices=sub)
    assert np.array_equal(got.cell, want.cell)
    assert np.array_equal(got.cost, want.cost)
    full = tf.decide_all(bw1, bw2)
    assert np.array_equal(got.cell, full.cell[sub])
    assert np.array_equal(got.cost, full.cost[sub])


def test_fleet_build_rejects_mixed_inputs():
    _, tt = both_tri(5)
    with pytest.raises(ValueError):
        ttri.TriFleetPlanSpace.build(tt, [ttypes.EDGE_TX2], flops=np.ones(1))
    with pytest.raises(ValueError):
        ttri.TriFleetPlanSpace.build(tt)
    with pytest.raises(ValueError):
        ttri.TriFleetPlanSpace.build(tt, flops=np.ones(2), w=np.ones(3))
    with pytest.raises(ValueError):
        ttri.TriFleetPlanSpace.build(tt, flops=np.zeros(2), w=np.ones(2))


def _dominated(pts, t):
    """Brute force: some other point is <= in every coordinate and either
    differs or (an identical tuple) comes first."""
    le = np.all(pts <= pts[t], axis=1)
    same = np.all(pts == pts[t], axis=1)
    idx = np.arange(len(pts))
    return bool(np.any(le & (~same | (idx < t))))


@pytest.mark.parametrize("seed", SEEDS)
def test_pareto_keep_on_tie_heavy_inputs(seed):
    """Coordinates drawn from three values, so most points tie with
    another in some or all coordinates: the keep-mask equals the
    reference's and the brute-force frontier (identical tuples keep the
    lowest index)."""
    rng = np.random.default_rng(seed ^ 0x7A)
    m = int(rng.integers(0, 120))
    k = int(rng.integers(1, 5))
    cols = [rng.integers(0, 3, m).astype(np.float64) for _ in range(k)]
    if m > 4:
        cols = [np.concatenate([c, c[:m // 4]]) for c in cols]
    keep = ttri._pareto_keep(cols)
    assert np.array_equal(keep, jtri._pareto_keep(cols))
    pts = np.stack(cols, axis=1) if cols[0].size else np.zeros((0, k))
    want = np.array([not _dominated(pts, t) for t in range(len(pts))],
                    dtype=bool)
    assert np.array_equal(keep, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_with_cloud_mesh_identity_and_tail_only(seed):
    jt, tt = both_tri(seed)
    bw1, bw2 = random_bandwidths(seed)
    ident = tt.with_cloud_mesh(tlatency.CloudMeshModel(1, 0.0))
    assert plan_key(tt.decide(bw1, bw2))[:7] == \
        plan_key(ident.decide(bw1, bw2))[:7]
    assert np.array_equal(ident.base, tt.base)
    meshed = tt.with_cloud_mesh(tlatency.CloudMeshModel(4, 1e-5))
    jmeshed = jt.with_cloud_mesh(jlatency.CloudMeshModel(4, 1e-5))
    assert_spaces_equal(meshed, jmeshed)
    assert meshed.cloud_exec_full() == jmeshed.cloud_exec_full()
    assert np.array_equal(meshed.dev_vec, tt.dev_vec)
    assert np.array_equal(meshed.mid_vec, tt.mid_vec)
    again = meshed.with_cloud_mesh(tlatency.CloudMeshModel(4, 1e-5))
    assert np.array_equal(again.cl_vec, meshed.cl_vec)
    plan = meshed.decide(bw1, bw2)
    assert plan_key(plan) == plan_key(jmeshed.decide(bw1, bw2))
    ref = ttri.solve_tri_enumeration(meshed, bw1, bw2)
    if ref is None:
        assert plan.is_cloud_only
    else:
        assert plan_flat(meshed, plan) == ref[0]
        assert plan.predicted_latency == ref[1]


# ---------------------------------------------------------------------------
# the fleet controller: two links, hysteresis, bounded history
# ---------------------------------------------------------------------------

def _drive(mod, fleet, seed, max_history):
    """Rounds over a two-link bandwidth walk: given bandwidths on even
    rounds, the per-link EWMA estimates (fed by transfers, some invalid)
    on odd ones, device subsets on every third. Returns the controller
    and each round's returned arrays."""
    ctl = mod.TriFleetAdaptationController(
        fleet, max_history=max_history, default_bw1=2e6, default_bw2=3e7)
    rng = np.random.default_rng(seed ^ 0xC7)
    d = fleet.n_devices
    walk1 = 10 ** rng.uniform(4.0, 8.0, d)
    walk2 = 10 ** rng.uniform(5.0, 8.5, d)
    out = []
    for step in range(14):
        walk1 = walk1 * 10 ** rng.normal(0.0, 1.0, d)
        walk2 = walk2 * 10 ** rng.normal(0.0, 1.0, d)
        if step in (5, 6):                     # a backhaul collapse
            walk2 = walk2 / 1000.0
        dv = (None if step % 3 else
              np.sort(rng.choice(d, size=max(1, d // 2), replace=False)))
        sel = slice(None) if dv is None else dv
        if step % 2 == 0:
            cells, lat = ctl.current_plans(walk1[sel], walk2[sel], dv)
        else:
            cells, lat = ctl.current_plans(None, None, dv)
        out.append((cells.copy(), lat.copy()))
        n = len(walk1[sel])
        nb = rng.uniform(1e3, 1e6, n)
        for link, walk in ((1, walk1), (2, walk2)):
            sec = nb / walk[sel]
            sec[rng.random(n) < 0.15] = 0.0     # invalid samples
            ctl.observe_transfers(nb, sec, dv, link=link)
    with pytest.raises(ValueError):
        ctl.observe_transfers(np.ones(1), np.ones(1), [0], link=3)
    return ctl, out


RECORD_FIELDS = ("devices", "steps", "bandwidths1", "bandwidths2", "old_c",
                 "old_lat", "old_acc", "new_c", "new_lat", "new_acc")


# Seeds whose twelve-device fleets re-plan many times under the walk, and
# one (30) whose kept-cell table is empty (every device cloud-only).
CONTROLLER_SEEDS = (4, 5, 8, 12, 13, 15, 29, 30)


@pytest.mark.parametrize("max_history", (None, 3))
@pytest.mark.parametrize("seed", CONTROLLER_SEEDS)
def test_controller_histories_match_reference(seed, max_history):
    d = 12
    jf, tf, _, _ = both_fleets(seed, d)
    jctl, jout = _drive(jadapt, jf, seed, max_history)
    tctl, tout = _drive(tadapt, tf, seed, max_history)
    assert tctl.switch_count() > 0 or tf.n_cells == 0
    for (tc, tl), (jc, jl) in zip(tout, jout):
        assert np.array_equal(tc, jc) and np.array_equal(tl, jl)
    assert len(tctl.history) == len(jctl.history)
    if max_history is not None:
        assert len(tctl.history) <= max_history
    for a, b in zip(tctl.history, jctl.history):
        for name in RECORD_FIELDS:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for name in ("bw1_est", "bw2_est", "plan_c", "plan_lat", "plan_acc",
                 "steps"):
        assert np.array_equal(getattr(tctl, name), getattr(jctl, name),
                              equal_nan=name.startswith("bw")), name
    assert tctl.switch_count() == jctl.switch_count()
    for dev in range(d):
        p, q = tctl.plan_for(dev), jctl.plan_for(dev)
        assert (p is None) == (q is None)
        if p is not None:
            assert plan_key(p) == plan_key(q)
        ev, jev = tctl.history_for(dev), jctl.history_for(dev)
        assert len(ev) == len(jev)
        for a, b in zip(ev, jev):
            assert (a.step, a.bandwidth) == (b.step, b.bandwidth)
            assert (a.old_plan is None) == (b.old_plan is None)
            if a.old_plan is not None:
                assert plan_key(a.old_plan) == plan_key(b.old_plan)
            assert plan_key(a.new_plan) == plan_key(b.new_plan)
