"""Parity of the port's LM serving path with the reference's, on the CPU.

Reduced ``olmo-1b`` and ``qwen3-8b`` in float32, the reference's weights
bridged into the port: ``ServeSession``, the continuous-batching engine,
token streaming across a JALAD cut (``TokenStreamSession``,
``step_stream_group``), the streaming planner (``StreamPlanTerms``,
``decide_streaming``), ``EdgeCloudServer.serve_trace`` over batches and
sessions, and the calibration oracle.

What is held how:
- Greedy tokens and scheduler events must be identical: the logits agree
  within float32 rounding (``test_torch_lm_model.py``) and these models'
  top-2 logits are far apart.
- Inside the port a batched engine or session must emit exactly the
  tokens of serving each request alone.
- The planner is float64 numpy in both packages: on one shared table file
  its arrays and decisions must be bitwise equal.
- Wire bytes are held at the reference's own boundary rows (a header
  computed from each package's own activation can differ by an ulp).
- Session byte accounting, encode groups and the int8 KV ratio are exact,
  for every codec (Huffman's frame sizes included: on these inputs no
  symbol moves between the packages' activations).
- ``serve_trace`` breakdowns (bitpack tables) must be bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codec import get_codec as jget_codec  # noqa: E402
from repro.config import JaladConfig as JJaladConfig  # noqa: E402
from repro.config import ServeConfig as JServeConfig  # noqa: E402
from repro.core.decoupler import DecoupledPlan as JPlan  # noqa: E402
from repro.core.decoupler import JaladEngine as JEngine  # noqa: E402
from repro.core.latency import LatencyModel as JLatency  # noqa: E402
from repro.core.predictor import PredictorTables as JTables  # noqa: E402
from repro.core.predictor import build_tables as jbuild_tables  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.serving.edge_cloud import EdgeCloudServer as JServer  # noqa: E402
from repro.serving.engine import ServeSession as JSession  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    ContinuousBatchingEngine as JBatching,
    GenRequest as JRequest,
)
from repro.serving.streaming import TokenStreamSession as JStream  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.config import JaladConfig, ServeConfig  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.decoupler import DecoupledPlan, JaladEngine  # noqa: E402
from repro_torch.core.latency import LatencyModel  # noqa: E402
from repro_torch.core.predictor import (  # noqa: E402
    CalibrationStats,
    PredictorTables,
    build_tables,
    build_tables_reference,
)
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    EdgeCloudServer,
    GenRequest,
    Servable,
    ServeSession,
    TokenStreamSession,
    build_edge_cloud_server,
    step_stream_group,
)

from conftest import reduced_model  # noqa: E402

CODECS = ("huffman", "bitpack", "perchannel")
BITS = (2, 4, 8)
CALIB_BATCH, SEQ = 2, 16
POINT = 0
# Staggered requests on 2 slots: prompt length, tokens, arrival step.
SIZES, MAX_NEW, ARRIVALS = [5, 9, 7, 6], [6, 3, 8, 4], [0, 0, 2, 5]


def _port(arch):
    """The port's reduced model with the reference's weights."""
    _, jparams = reduced_model(arch)
    return (build_model(get_config(arch).reduced()),
            params_from_numpy(jax.device_get(jparams), "cpu"))


@pytest.fixture(scope="module")
def olmo():
    jmodel, jparams = reduced_model("olmo-1b")
    model, params = _port("olmo-1b")
    return jmodel, jparams, model, params


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in sizes]


def _submit(engine, req_cls, prompts, arrivals=None, max_new=None):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(
            uid=i, tokens=p,
            max_new_tokens=(max_new or MAX_NEW)[i],
            arrival=(arrivals or [0] * len(prompts))[i]))
    return {r.uid: r.result for r in engine.run()}


def _plan(cls, bits=8, codec="bitpack", point=POINT):
    return cls(point=point, bits=bits, predicted_latency=0.0,
               predicted_acc_drop=0.0, solve_ms=0.0, codec=codec)


# ---------------------------------------------------------------------------
# Sessions and continuous batching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b"])
def test_serve_session_greedy_matches_reference(arch):
    jmodel, jparams = reduced_model(arch)
    model, params = _port(arch)
    batch = jmake_batch(jmodel.cfg, 2, 6, seed=1)
    ref = JSession(jmodel, jparams, JServeConfig(
        max_batch=2, max_seq_len=16)).generate(
            {k: jnp.asarray(v) for k, v in batch.items()}, 6)
    out = ServeSession(model, params, ServeConfig(
        max_batch=2, max_seq_len=16)).generate(batch, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))
    # Sampling draws from the port's own generator: reproducible.
    sess = ServeSession(model, params, ServeConfig(max_batch=2,
                                                   max_seq_len=16))
    a = sess.generate(batch, 5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, sess.generate(batch, 5,
                                                   temperature=0.8, seed=3))


def test_continuous_batching_matches_reference_and_solo():
    """qwen3 (an untied head, so tokens move): the batched engine's
    tokens and join/evict events equal the reference's, and each request's
    tokens equal a one-slot engine serving it alone."""
    jmodel, jparams = reduced_model("qwen3-8b")
    model, params = _port("qwen3-8b")
    prompts = _prompts(model.cfg.vocab_size, SIZES, seed=3)
    jeng = JBatching(jmodel, jparams, JServeConfig(max_batch=2,
                                                   max_seq_len=48))
    ref = _submit(jeng, JRequest, prompts, ARRIVALS)
    eng = ContinuousBatchingEngine(model, params, ServeConfig(
        max_batch=2, max_seq_len=48))
    out = _submit(eng, GenRequest, prompts, ARRIVALS)
    assert eng.events == jeng.events
    for i in range(len(prompts)):
        np.testing.assert_array_equal(out[i], ref[i])
        solo = ContinuousBatchingEngine(model, params, ServeConfig(
            max_batch=1, max_seq_len=48))
        alone = _submit(solo, GenRequest, [prompts[i]],
                        max_new=[MAX_NEW[i]])
        np.testing.assert_array_equal(out[i], alone[0])
    assert len({tuple(out[i].tolist()) for i in out}) > 1
    # Sampled slots: reproducible from the port's generators.
    runs = []
    for _ in range(2):
        e = ContinuousBatchingEngine(model, params, ServeConfig(
            max_batch=2, max_seq_len=48, seed=5))
        for i, p in enumerate(prompts[:2]):
            e.submit(GenRequest(uid=i, tokens=p, max_new_tokens=4,
                                temperature=0.7))
        runs.append({r.uid: r.result.tolist() for r in e.run()})
    assert runs[0] == runs[1]


def test_batching_engine_refuses_cnn():
    model = build_model(get_config("resnet50").reduced())
    with pytest.raises(ValueError, match="autoregressive"):
        ContinuousBatchingEngine(model, {"w": torch.zeros(1)},
                                 ServeConfig())


# ---------------------------------------------------------------------------
# Token streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
def test_token_stream_session_matches_reference(olmo, codec):
    """For each codec: tokens, events, encode groups, bytes sent and the
    int8 KV ratio equal the reference session's; each request's tokens
    equal a one-slot session serving it alone."""
    jmodel, jparams, model, params = olmo
    prompts = _prompts(model.cfg.vocab_size, SIZES, seed=3)
    jsess = JStream(jmodel, jparams, JServeConfig(max_batch=2,
                                                  max_seq_len=48),
                    plan=_plan(JPlan, codec=codec))
    ref = _submit(jsess, JRequest, prompts, ARRIVALS)
    sess = TokenStreamSession(model, params, ServeConfig(
        max_batch=2, max_seq_len=48), plan=_plan(DecoupledPlan, codec=codec))
    assert sess.header.nbytes == jsess.header.nbytes
    out = _submit(sess, GenRequest, prompts, ARRIVALS)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(out[i], ref[i])
    assert sess.events == jsess.events
    assert sess.encode_groups == jsess.encode_groups
    assert sess.tokens_out == jsess.tokens_out
    assert sess.kv_bytes_ratio == jsess.kv_bytes_ratio
    assert sess.bytes_sent == jsess.bytes_sent
    for i in (1, 2):
        solo = TokenStreamSession(model, params, ServeConfig(
            max_batch=1, max_seq_len=48),
            plan=_plan(DecoupledPlan, codec=codec))
        alone = _submit(solo, GenRequest, [prompts[i]], max_new=[MAX_NEW[i]])
        np.testing.assert_array_equal(out[i], alone[0])
    # Evicted slots' rows are freed on both sides of the cut.
    for caches in (sess._head_caches, sess._tail_caches):
        assert not any(v.any() for c in caches for v in c.values())


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_stream_batched_equals_solo_on_moving_tokens(temperature):
    """qwen3's untied head moves greedy tokens (olmo's tied random
    embeddings mostly repeat one), and sampling moves them further: each
    request of a batched stream still gets the tokens of a one-slot
    session serving it alone."""
    model, params = _port("qwen3-8b")
    prompts = _prompts(model.cfg.vocab_size, SIZES, seed=9)

    def run(prompt_ids, max_batch):
        sess = TokenStreamSession(model, params, ServeConfig(
            max_batch=max_batch, max_seq_len=48, seed=4),
            plan=_plan(DecoupledPlan, codec="perchannel"))
        for i in prompt_ids:
            sess.submit(GenRequest(uid=i, tokens=prompts[i],
                                   max_new_tokens=MAX_NEW[i],
                                   temperature=temperature,
                                   arrival=ARRIVALS[i] if max_batch > 1
                                   else 0))
        return {r.uid: r.result.tolist() for r in sess.run()}

    batched = run(range(len(prompts)), 2)
    assert len({t for v in batched.values() for t in v}) > len(prompts)
    for i in range(len(prompts)):
        assert run([i], 1)[i] == batched[i]


def test_stream_session_rules(olmo):
    _, _, model, params = olmo
    sc = ServeConfig(max_batch=2, max_seq_len=32)
    with pytest.raises(ValueError, match="cloud-only"):
        TokenStreamSession(model, params, sc,
                           plan=_plan(DecoupledPlan, point=-1))
    with pytest.raises(ValueError, match="DecoupledPlan"):
        TokenStreamSession(model, params, sc)
    fp = TokenStreamSession(model, params, sc, plan=_plan(DecoupledPlan),
                            cloud_kv_bits=0)
    assert fp.kv_bytes_ratio is None
    assert not any(v.dtype == torch.int8 for c in fp._tail_caches
                   for v in c.values())


def test_stream_group_matches_separate_sessions(olmo):
    _, _, model, params = olmo
    prompts = _prompts(model.cfg.vocab_size, [5, 7, 6, 4], seed=5)

    def make(uids):
        s = TokenStreamSession(model, params, ServeConfig(
            max_batch=2, max_seq_len=48), plan=_plan(DecoupledPlan))
        for u in uids:
            s.submit(GenRequest(uid=u, tokens=prompts[u], max_new_tokens=4))
        return s

    grouped = [make([0, 1]), make([2, 3])]
    while any(s.queue or s.num_active for s in grouped):
        assert len(step_stream_group(grouped)) == 2
    solo = [make([0, 1]), make([2, 3])]
    for s in solo:
        s.run()
    for sg, ss in zip(grouped, solo):
        assert sg.bytes_sent == ss.bytes_sent
        assert sg.encode_groups == ss.encode_groups
        for rg, rs in zip(sg.completed, ss.completed):
            assert rg.uid == rs.uid
            np.testing.assert_array_equal(rg.result, rs.result)
    assert step_stream_group([]) == []
    bad = make([0])
    bad.plan = _plan(DecoupledPlan, bits=2)
    with pytest.raises(ValueError, match="mixes plans"):
        step_stream_group([grouped[0], bad])


@pytest.mark.parametrize("codec", CODECS)
def test_stream_wire_bytes_at_reference_boundary_rows(olmo, codec):
    """The stream's frames at the reference's own boundary rows: a prompt
    boundary (1, S, d) and a stack of decode rows (1, 1, d) encode to the
    reference's bytes and headers, and decode bit-exactly."""
    jmodel, jparams, _, _ = olmo
    toks = jnp.asarray(_prompts(jmodel.cfg.vocab_size, [9], seed=7)[0][None])
    boundary, head = jmodel.prefill_head(jparams, {"tokens": toks}, 16,
                                         POINT)
    rows = [np.array(boundary[:, i:i + 1]) for i in range(3)]
    jc, tc = jget_codec(codec), get_codec(codec)
    for bits in BITS:
        frames = [np.array(boundary)] + rows
        for xs in ([frames[0]], frames[1:]):
            jblobs = jc.encode_batch([jnp.asarray(x) for x in xs], bits)
            tblobs = tc.encode_batch([torch.from_numpy(x) for x in xs], bits)
            for jb, tb in zip(jblobs, tblobs):
                assert tb.payload == jb.payload
                assert tb.stream_nbytes == jb.stream_nbytes
                np.testing.assert_array_equal(
                    np.asarray(tb.x_min).view(np.int32),
                    np.asarray(jb.x_min).view(np.int32))
            jdec = jc.decode_batch(jblobs, out_dtype=jnp.float32)
            tdec = tc.decode_batch(tblobs, out_dtype=torch.float32,
                                   device="cpu")
            for jd, td in zip(jdec, tdec):
                np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# The streaming planner and serve_trace, on shared tables
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared(olmo, tmp_path_factory):
    """One table file from the reference's calibration, loaded by both
    packages' engines (codecs all three, then bitpack alone)."""
    jmodel, jparams, model, params = olmo
    batches = [jmake_batch(jmodel.cfg, CALIB_BATCH, SEQ, seed=10)]
    path = str(tmp_path_factory.mktemp("tables") / "lm.npz")
    jbuild_tables(jmodel, jparams, batches, list(BITS),
                  codecs=list(CODECS)).save(path)
    fmacs = model.per_point_fmacs(CALIB_BATCH, SEQ)
    assert fmacs == jmodel.per_point_fmacs(CALIB_BATCH, SEQ)

    def engines(codecs):
        jt, tt = JTables.load(path), PredictorTables.load(path)
        if codecs != CODECS:
            k = jt.codec_index(codecs[0])
            jt, tt = (dataclasses.replace(
                t, codecs=[codecs[0]], acc_drop=t.acc_drop[:, :, k:k + 1],
                size_bytes=t.size_bytes[:, :, k:k + 1]) for t in (jt, tt))
        jjc = JJaladConfig(bits_choices=BITS, codec_choices=codecs,
                           accuracy_drop_budget=0.5)
        tjc = JaladConfig(bits_choices=BITS, codec_choices=codecs,
                          accuracy_drop_budget=0.5)
        nbytes = float(CALIB_BATCH * SEQ * 4)
        je = JEngine(jmodel, jt, JLatency(fmacs, jjc.edge, jjc.cloud, nbytes),
                     jjc)
        te = JaladEngine(model, tt, LatencyModel(fmacs, tjc.edge, tjc.cloud,
                                                 nbytes), tjc)
        return je, te

    return engines


def _plan_tuple(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


def test_stream_plan_terms_bitwise_on_shared_tables(shared):
    je, te = shared(CODECS)
    jt, tt = je.stream_terms, te.stream_terms
    assert tt.tokens_per_batch == jt.tokens_per_batch == CALIB_BATCH * SEQ
    np.testing.assert_array_equal(tt.token_bytes, jt.token_bytes)
    for bw in (1e3, 2e5, 1e6, 1e9):
        for e_tok in (1.0, 16.0, 256.0):
            np.testing.assert_array_equal(tt._steady_extra(bw, e_tok),
                                          jt._steady_extra(bw, e_tok))
            for method in ("planner", "enumeration"):
                tp = te.decide_streaming(bw, e_tok, method=method)
                jp = je.decide_streaming(bw, e_tok, method=method)
                assert _plan_tuple(tp) == _plan_tuple(jp)
            assert tt.cloud_only_stream_time(bw, e_tok) == \
                jt.cloud_only_stream_time(bw, e_tok)
            if not tp.is_cloud_only:
                assert tt.token_time(tp, bw) == jt.token_time(jp, bw)
            np.testing.assert_array_equal(
                tt.ilp_problem(bw, e_tok).cost,
                jt.ilp_problem(bw, e_tok).cost)
    # The stream terms follow the engine's per-edge view.
    assert te.for_edge(te.cfg.edge)._stream_terms is None


def test_serve_trace_mixes_batches_and_sessions(olmo, shared):
    """serve_trace over a batch and four steps of a streaming session:
    the port's breakdowns, clock and plans equal the reference's."""
    jmodel, jparams, model, params = olmo
    je, te = shared(("bitpack",))
    jsrv, tsrv = JServer(je, jparams), EdgeCloudServer(te, params)
    logs = []
    for srv, sess_cls, plan_cls, req_cls, sc_cls, p, m in (
            (jsrv, JStream, JPlan, JRequest, JServeConfig, jparams, jmodel),
            (tsrv, TokenStreamSession, DecoupledPlan, GenRequest, ServeConfig,
             params, model)):
        sess = sess_cls(m, p, sc_cls(max_batch=2, max_seq_len=32),
                        plan=_plan(plan_cls))
        for i in range(2):
            sess.submit(req_cls(uid=i, tokens=_prompts(
                m.cfg.vocab_size, [4, 5], seed=i)[0], max_new_tokens=3))
        batch = jmake_batch(jmodel.cfg, 2, SEQ, seed=0)
        if srv is jsrv:
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
        items = [batch, sess, sess, sess, sess]
        logs.append((srv.serve_trace(items, [1e6, 2e5, 2e5, 1e6, 1e6]),
                     srv.clock))
    assert isinstance(sess, Servable)           # the port's session
    (jlog, jclock), (tlog, tclock) = logs
    assert [dataclasses.asdict(b) for b in tlog] == \
        [dataclasses.asdict(b) for b in jlog]
    assert tclock == jclock


# ---------------------------------------------------------------------------
# Calibration: the one-pass tables equal the loop oracle; the LM server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,codecs", [
    ("resnet50", ("perchannel", "bitpack", "huffman")),
    ("olmo-1b", ("huffman", "bitpack")),
])
def test_vectorized_tables_equal_the_loop_oracle(arch, codecs):
    """Port-internal, on the port's own weights from a seed."""
    model = build_model(get_config(arch).reduced())
    params = model.init(0, "cpu")
    n = len(model.decoupling_points())
    pts = [0, n // 2, n - 1]
    batches = [make_batch(model.cfg, 4, 12, seed=7)]
    s_ref, s_vec = CalibrationStats(), CalibrationStats()
    ref = build_tables_reference(model, params, batches, [2, 8],
                                 codecs=codecs, points=pts, stats=s_ref)
    vec = build_tables(model, params, batches, [2, 8], codecs=codecs,
                       points=pts, stats=s_vec)
    assert vec.points == ref.points and vec.codecs == ref.codecs
    np.testing.assert_array_equal(vec.acc_drop, ref.acc_drop)
    np.testing.assert_array_equal(vec.size_bytes, ref.size_bytes)
    assert vec.base_accuracy == ref.base_accuracy
    keys = len({get_codec(c).value_key for c in codecs})
    assert s_ref.tail_forwards == len(pts) * 2 * keys
    assert s_vec.tail_forwards == len(pts) * keys
    assert s_vec.batches == s_ref.batches == 1


def test_lm_edge_cloud_server_on_the_cpu(olmo):
    """build_edge_cloud_server's LM branch: the token-batch input bytes,
    calibration against the model's own predictions, decide_streaming,
    and a stream session from the chosen plan."""
    _, _, model, _ = olmo
    jc = JaladConfig(bits_choices=BITS, accuracy_drop_budget=0.5)
    srv, params = build_edge_cloud_server(model.cfg, jc, calib_batches=1,
                                          calib_batch_size=CALIB_BATCH,
                                          seq_len=SEQ, device="cpu")
    eng = srv.engine
    assert eng.latency.input_bytes == CALIB_BATCH * SEQ * 4
    assert eng.tables.base_accuracy == 1.0     # its own predictions
    plan = eng.decide_streaming(2e5, expected_tokens=256.0)
    oracle = eng.decide_streaming(2e5, expected_tokens=256.0,
                                  method="enumeration")
    assert _plan_tuple(plan) == _plan_tuple(oracle)
    if not plan.is_cloud_only:
        sess = eng.make_runner(params, plan).stream_session(
            ServeConfig(max_batch=2, max_seq_len=32))
        assert sess.plan_key == (plan.point, plan.bits, plan.codec)
        sess.submit(GenRequest(uid=0, tokens=np.arange(1, 5, dtype=np.int32),
                               max_new_tokens=3))
        assert len(sess.run()[0].result) == 3
    with pytest.raises(ValueError, match="autoregressive"):
        JaladEngine(build_model(get_config("resnet50").reduced()),
                    eng.tables, eng.latency, jc).stream_terms


@pytest.mark.parametrize("argv", [
    ["--continuous", "--requests", "4", "--tokens", "4", "--batch", "2"],
    ["--tokens", "4", "--batch", "2", "--prompt", "6"],
])
def test_lm_serve_cli_runs_on_the_cpu(argv, caplog):
    from repro_torch.launch.serve import main

    with caplog.at_level("INFO"):
        assert main(["--arch", "olmo-1b", "--reduced", "--device", "cpu"]
                    + argv) == 0
    assert "olmo-1b" in caplog.text
