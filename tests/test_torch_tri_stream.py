"""Parity of the port's three-tier streaming terms (``TriStreamPlanTerms``,
``TriPlanSpace.with_streaming``) with the reference's.

Both packages get the same tables, latency model, edge server and power
model, made with numpy from a seed, with registered codecs on the codec
axis (the stream frame's size is the codec's shape-only wire size).
Tolerance: none. The terms are float64 numpy computed by the same
operations in the same order, so the per-token frame bytes, the steady
extra, every decision, cost, ``token_time``, cloud-only stream time and
ILP cost cell must be bitwise equal, over a grid of link bandwidths,
expected tokens, energy weights and accuracy budgets. The port's
``degenerate()`` view at ``BW1 = inf`` must reproduce its two-tier
``StreamPlanTerms`` bitwise, and its fused argmin must equal the generic
enumeration solver on its streaming ILP problem.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.config import types as jtypes  # noqa: E402
from repro.core import latency as jlatency  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.core import tri_planner as jtri  # noqa: E402
from repro_torch.codec import list_codecs  # noqa: E402
from repro_torch.config import types as ttypes  # noqa: E402
from repro_torch.core import ilp as tilp  # noqa: E402
from repro_torch.core import latency as tlatency  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core import predictor as tpredictor  # noqa: E402
from repro_torch.core import tri_planner as ttri  # noqa: E402

SEEDS = range(8)
INF = float("inf")
JPKG = (jtypes, jlatency, jpredictor, jtri)
TPKG = (ttypes, tlatency, tpredictor, ttri)


def draw(pkg, seed):
    """(tables, latency, edge server, power, d_model, tokens_per_batch) of
    ``pkg`` from one seed; both packages get the same arrays for the same
    seed."""
    types, latency, predictor, _ = pkg
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 10))
    c = int(rng.integers(1, 4))
    codecs = list(list_codecs())[: int(rng.integers(1, 4))]
    lat = latency.LatencyModel(rng.random(n) * 1e9 + 1e8, types.EDGE_TX2,
                               types.CLOUD_1080TI, input_bytes=150_528.0)
    tables = predictor.PredictorTables(
        points=[f"p{i}" for i in range(n)],
        bits_choices=[2 + 2 * i for i in range(c)],
        codecs=codecs,
        acc_drop=rng.random((n, c, len(codecs))) * 0.3,
        size_bytes=rng.random((n, c, len(codecs))) * 1e6 + 1e3,
        base_accuracy=0.9,
    )
    es = types.DeviceProfile("es", float(rng.uniform(5e11, 8e12)),
                             float(rng.uniform(0.7, 1.6)))
    power = types.TierPowerModel(
        device_w=float(rng.uniform(1, 10)),
        edge_server_w=float(rng.uniform(30, 120)),
        cloud_w=float(rng.uniform(100, 400)),
        tx1_w=float(rng.uniform(0.5, 3)),
        tx2_w=float(rng.uniform(1, 6)),
    )
    return tables, lat, es, power, int(rng.integers(8, 4096)), \
        float(rng.integers(1, 64))


def stream_setup(pkg, seed, energy_weight, budget):
    """(TriPlanSpace, d_model, tokens_per_batch) of ``pkg``."""
    tables, lat, es, power, d_model, tpb = draw(pkg, seed)
    space = pkg[3].TriPlanSpace.build(tables, lat, budget, edge_server=es,
                                      power=power,
                                      energy_weight=energy_weight)
    return space, d_model, tpb


def plan_key(p):
    return (p.point, p.bits, p.codec, p.point2, p.bits2, p.codec2,
            p.predicted_latency, p.predicted_acc_drop)


def grid(seed):
    rng = np.random.default_rng(seed ^ 0x5F)
    bws = [float(10 ** rng.uniform(3.0, 8.5)) for _ in range(3)] + [INF]
    toks = [1.0, float(rng.integers(2, 256)), 4096.0]
    return [(b1, b2, e) for b1 in bws for b2 in bws[:3] for e in toks]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("energy_weight", [0.0, 7.5])
@pytest.mark.parametrize("budget", [0.0, 0.05, 0.3])
def test_stream_terms_match_reference_bitwise(seed, energy_weight, budget):
    jspace, d_model, tpb = stream_setup(JPKG, seed, energy_weight, budget)
    tspace, _, _ = stream_setup(TPKG, seed, energy_weight, budget)
    jterms = jspace.with_streaming(d_model, tpb)
    tterms = tspace.with_streaming(d_model, tpb)
    assert isinstance(tterms, ttri.TriStreamPlanTerms)
    assert tterms.d_model == jterms.d_model
    assert tterms.tokens_per_batch == jterms.tokens_per_batch
    assert np.array_equal(tterms.token_bytes, jterms.token_bytes)
    for bw1, bw2, e_tok in grid(seed):
        assert np.array_equal(tterms._steady_extra(bw1, bw2, e_tok),
                              jterms._steady_extra(bw1, bw2, e_tok))
        got = tterms.decide(bw1, bw2, e_tok)
        ref = jterms.decide(bw1, bw2, e_tok)
        assert plan_key(got) == plan_key(ref), (bw1, bw2, e_tok)
        assert got.is_cloud_only == ref.is_cloud_only
        assert tterms.token_time(got, bw1, bw2) == \
            jterms.token_time(ref, bw1, bw2)
        assert tterms.cloud_only_stream_time(bw1, bw2, e_tok) == \
            jterms.cloud_only_stream_time(bw1, bw2, e_tok)
        tp = tterms.ilp_problem(bw1, bw2, e_tok)
        jp = jterms.ilp_problem(bw1, bw2, e_tok)
        assert np.array_equal(tp.cost, jp.cost)
        assert np.array_equal(tp.acc_drop, jp.acc_drop)
        assert tp.budget == jp.budget


def test_stream_terms_reject_a_bad_rate():
    tspace, d_model, _ = stream_setup(TPKG, 0, 0.0, 0.1)
    with pytest.raises(ValueError, match="tokens_per_batch"):
        tspace.with_streaming(d_model, 0.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_degenerate_reproduces_port_two_tier_bitwise(seed):
    """At BW1 = inf over the degenerate view, two per-token streams are
    the port's two-tier StreamPlanTerms: same plan, bitwise objective."""
    tables, lat, _, _, d_model, tpb = draw(TPKG, seed)
    tri, _, _ = stream_setup(TPKG, seed, 0.0, 0.1)
    two = tplanner.PlanSpace.build(tables, lat, 0.1).with_streaming(
        d_model, tpb)
    terms = tri.degenerate().with_streaming(d_model, tpb)
    for _, bw, e_tok in grid(seed):
        got = terms.decide(INF, bw, e_tok)
        ref = two.decide(bw, e_tok)
        assert got.predicted_latency == ref.predicted_latency
        if ref.is_cloud_only:
            assert got.is_cloud_only
            assert terms.cloud_only_stream_time(INF, bw, e_tok) == \
                two.cloud_only_stream_time(bw, e_tok)
        else:
            assert (got.point, got.bits, got.codec) == \
                (ref.point, ref.bits, ref.codec)
            assert terms.token_time(got, INF, bw) == two.token_time(ref, bw)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_decide_matches_ilp_oracle(seed):
    """The fused streaming argmin equals the generic enumeration solver
    on the streaming ILPProblem, at asymmetric link bandwidths."""
    tri, d_model, tpb = stream_setup(TPKG, seed, 2.0, 0.2)
    terms = tri.with_streaming(d_model, tpb)
    for bw1, bw2, e_tok in grid(seed):
        plan = terms.decide(bw1, bw2, e_tok)
        sol = tilp.solve_enumeration(terms.ilp_problem(bw1, bw2, e_tok))
        if sol is None:
            assert plan.is_cloud_only
            assert plan.predicted_latency == \
                terms.cloud_only_stream_time(bw1, bw2, e_tok)
        else:
            assert plan_key(terms.plan_from_solution(sol))[:6] == \
                plan_key(plan)[:6]
            assert sol.objective == plan.predicted_latency
