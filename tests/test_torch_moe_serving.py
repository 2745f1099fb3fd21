"""Parity of the port's serving paths on the Mixture-of-Experts decoders
with the reference's, on the CPU.

Reduced ``grok-1-314b`` (two MoE blocks, 4 experts top-2) and reduced
``llama4-maverick-400b-a17b`` (a dense block, then an MoE block of 4
experts top-1) in float32, the reference's weights bridged into the port:
``ServeSession``, the continuous-batching engine, token streaming across
a JALAD cut (``TokenStreamSession``), the streaming planner
(``StreamPlanTerms``, ``decide_streaming``), ``build_edge_cloud_server``
and the serve CLI.

What is held how (as ``test_torch_lm_serving.py`` holds the dense family):
- Greedy tokens, scheduler events and encode groups must be identical:
  the logits agree within float32 rounding (``test_torch_moe_model.py``)
  and these models' top-2 logits are far apart.
- Inside the port a batched engine or session must emit exactly the
  tokens of serving each request alone: an MoE block routes each row's
  tokens in groups of that row alone, and every expert's product has
  the same shape (``DECODE_ROWS`` rows x 8 slots) whatever the routing.
- Session byte accounting is exact for every codec; wire bytes are held at
  the reference's own boundary rows (a header computed from each
  package's own activation can differ by an ulp).
- The planner is float64 numpy in both packages: on one shared table file
  its arrays and decisions must be bitwise equal.
- The int8 tail KV passes the bytes-halved check: both tails hold only
  attention KV (no recurrent state), at reduced and at full width.
"""
from types import SimpleNamespace

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
from repro_torch.core.predictor import PredictorTables  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    GenRequest,
    ServeSession,
    TokenStreamSession,
    build_edge_cloud_server,
)

from conftest import reduced_model  # noqa: E402


ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
CODECS = ("huffman", "bitpack", "perchannel")
BITS = (2, 4, 8)
CALIB_BATCH, SEQ = 2, 8
# The cut of each reduced model: after its first block (grok: the tail
# holds the second MoE block; llama4: its MoE block), whose int8 KV makes
# the session check the bytes ratio.
MID = 0
# Staggered requests on 2 slots: prompt length, tokens, arrival step. One
# prompt length: the reference compiles its prefill (and each codec its
# prompt-frame encode) for every length, and those compiles are most of
# these tests' time. The slots still decode at different positions (the
# arrivals are staggered).
SIZES, MAX_NEW, ARRIVALS = [6, 6, 6, 6], [6, 3, 5, 4], [0, 0, 2, 4]
_MODELS = {}


def _models(arch):
    """(reference model, reference params, port model, port params)."""
    if arch not in _MODELS:
        jm, jp = reduced_model(arch)
        _MODELS[arch] = (jm, jp, build_model(get_config(arch).reduced()),
                         params_from_numpy(jax.device_get(jp), "cpu"))
    return _MODELS[arch]


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in sizes]


def _submit(engine, req_cls, prompts, arrivals=None, max_new=None,
            temperature=0.0, uids=None):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(
            uid=(uids or range(len(prompts)))[i], tokens=p,
            max_new_tokens=(max_new or MAX_NEW)[i],
            arrival=(arrivals or [0] * len(prompts))[i],
            temperature=temperature))
    return {r.uid: r.result.tolist() for r in engine.run()}


def _plan(cls, bits=8, codec="bitpack", point=MID):
    return cls(point=point, bits=bits, predicted_latency=0.0,
               predicted_acc_drop=0.0, solve_ms=0.0, codec=codec)


# ---------------------------------------------------------------------------
# Sessions and continuous batching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_session_greedy_matches_reference(arch):
    jm, jp, m, p = _models(arch)
    batch = jmake_batch(jm.cfg, 2, 6, seed=1)
    sc = dict(max_batch=2, max_seq_len=12)
    ref = JSession(jm, jp, JServeConfig(**sc)).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, 5)
    out = ServeSession(m, p, ServeConfig(**sc)).generate(batch, 5)
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_matches_reference_and_solo(arch):
    """The batched engine's tokens and join/evict events equal the
    reference's; each request's tokens, greedy and sampled, equal a
    one-slot engine serving it alone."""
    jm, jp, m, p = _models(arch)
    prompts = _prompts(m.cfg.vocab_size, SIZES, seed=3)
    jeng = JBatching(jm, jp, JServeConfig(max_batch=2, max_seq_len=24))
    ref = _submit(jeng, JRequest, prompts, ARRIVALS)
    eng = ContinuousBatchingEngine(m, p, ServeConfig(max_batch=2,
                                                     max_seq_len=24))
    out = _submit(eng, GenRequest, prompts, ARRIVALS)
    assert out == ref and eng.events == jeng.events
    assert len({tuple(v) for v in out.values()}) > 1
    for t in (0.0, 0.9):
        batched = out if t == 0 else _submit(
            ContinuousBatchingEngine(m, p, ServeConfig(
                max_batch=2, max_seq_len=24, seed=5)),
            GenRequest, prompts, ARRIVALS, temperature=t)
        for i in range(len(prompts)):
            alone = _submit(ContinuousBatchingEngine(m, p, ServeConfig(
                max_batch=1, max_seq_len=24, seed=5)), GenRequest,
                [prompts[i]], max_new=[MAX_NEW[i]], temperature=t,
                uids=[i])
            assert alone[i] == batched[i]


# ---------------------------------------------------------------------------
# Token streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,codec", [("grok-1-314b", c) for c in CODECS]
                         + [("llama4-maverick-400b-a17b", "bitpack")])
def test_token_stream_session_matches_reference(arch, codec):
    """Tokens, events, encode groups, bytes sent and the int8 KV ratio
    (both tails hold only attention KV) equal the reference session's,
    for each codec on grok and for llama4 on bitpack (its frames are the
    same (1, 1, 256) rows); each request's tokens equal a one-slot session
    serving it alone."""
    jm, jp, m, p = _models(arch)
    prompts = _prompts(m.cfg.vocab_size, SIZES, seed=3)
    jsess = JStream(jm, jp, JServeConfig(max_batch=2, max_seq_len=24),
                    plan=_plan(JPlan, codec=codec))
    ref = _submit(jsess, JRequest, prompts, ARRIVALS)
    sess = TokenStreamSession(m, p, ServeConfig(max_batch=2,
                                                max_seq_len=24),
                              plan=_plan(DecoupledPlan, codec=codec))
    assert sess.header.nbytes == jsess.header.nbytes
    out = _submit(sess, GenRequest, prompts, ARRIVALS)
    assert out == ref
    assert sess.events == jsess.events
    assert sess.encode_groups == jsess.encode_groups
    assert sess.tokens_out == jsess.tokens_out
    assert sess.kv_bytes_ratio == jsess.kv_bytes_ratio
    assert sess.kv_bytes_ratio is not None and sess.kv_bytes_ratio < 0.6
    assert sess.bytes_sent == jsess.bytes_sent
    if codec in ("perchannel", "bitpack"):
        for i in (1, 2):
            solo = TokenStreamSession(m, p, ServeConfig(
                max_batch=1, max_seq_len=24),
                plan=_plan(DecoupledPlan, codec=codec))
            alone = _submit(solo, GenRequest, [prompts[i]],
                            max_new=[MAX_NEW[i]])
            assert alone[0] == out[i]
    # Evicted slots' rows are zeroed on both sides of the cut, as the
    # reference's are (a join overwrites a slot's whole state).
    for caches in (sess._head_caches, sess._tail_caches):
        for c in caches:
            for v in c.values():
                assert not v[:, :2].any()


@pytest.mark.parametrize("codec", CODECS)
def test_stream_wire_bytes_at_reference_boundary_rows(codec):
    """grok's stream frames, the same tensors in both packages: a prompt
    boundary (1, S, d) and a stack of decode rows (1, 1, d) encode to the
    reference's bytes and headers at 2 and 8 bits, and decode
    bit-exactly."""
    _, _, m, p = _models("grok-1-314b")
    toks = torch.from_numpy(_prompts(m.cfg.vocab_size, [9], seed=7)[0][None])
    with torch.no_grad():
        boundary = m.prefill_head(p, {"tokens": toks}, 16, MID)[0].numpy()
    frames = [boundary] + [boundary[:, i:i + 1].copy() for i in range(3)]
    jc, tc = jget_codec(codec), get_codec(codec)
    for bits in (2, 8):
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
# The streaming planner, on shared tables
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One table file per arch from the reference's calibration, loaded by
    both packages' engines."""
    out = {}
    for arch in ARCHS:
        jm, jp, m, _ = _models(arch)
        batches = [jmake_batch(jm.cfg, CALIB_BATCH, SEQ, seed=10)]
        path = str(tmp_path_factory.mktemp("tables") / f"{arch}.npz")
        jbuild_tables(jm, jp, batches, list(BITS),
                      codecs=list(CODECS)).save(path)
        fmacs = m.per_point_fmacs(CALIB_BATCH, SEQ)
        assert fmacs == jm.per_point_fmacs(CALIB_BATCH, SEQ)
        jjc = JJaladConfig(bits_choices=BITS, codec_choices=CODECS,
                           accuracy_drop_budget=0.5)
        tjc = JaladConfig(bits_choices=BITS, codec_choices=CODECS,
                          accuracy_drop_budget=0.5)
        nbytes = float(CALIB_BATCH * SEQ * 4)
        out[arch] = (
            JEngine(jm, JTables.load(path),
                    JLatency(fmacs, jjc.edge, jjc.cloud, nbytes), jjc),
            JaladEngine(m, PredictorTables.load(path),
                        LatencyModel(fmacs, tjc.edge, tjc.cloud, nbytes),
                        tjc))
    return out


def _plan_tuple(p):
    return (p.point, p.bits, p.codec, p.predicted_latency,
            p.predicted_acc_drop)


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_plan_terms_bitwise_on_shared_tables(shared, arch):
    je, te = shared[arch]
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


def test_edge_cloud_server_on_the_cpu():
    """build_edge_cloud_server's LM branch on reduced llama4, on the
    port's own weights: calibration over every point (the dense block's
    and the MoE block's) against the model's own predictions,
    decide_streaming's planner equal to the enumeration, and a stream
    session from the plan."""
    _, _, m, _ = _models("llama4-maverick-400b-a17b")
    jc = JaladConfig(bits_choices=BITS, accuracy_drop_budget=0.5)
    srv, params = build_edge_cloud_server(m.cfg, jc, calib_batches=1,
                                          calib_batch_size=CALIB_BATCH,
                                          seq_len=SEQ, device="cpu")
    eng = srv.engine
    assert eng.tables.points == m.decoupling_points()
    assert eng.tables.base_accuracy == 1.0
    for bw in (2e3, 2e5):
        plan = eng.decide_streaming(bw, expected_tokens=256.0)
        oracle = eng.decide_streaming(bw, expected_tokens=256.0,
                                      method="enumeration")
        assert _plan_tuple(plan) == _plan_tuple(oracle)
    if not plan.is_cloud_only:
        sess = eng.make_runner(params, plan).stream_session(
            ServeConfig(max_batch=2, max_seq_len=16))
        sess.submit(GenRequest(uid=0, tokens=np.arange(1, 5, dtype=np.int32),
                               max_new_tokens=3))
        assert len(sess.run()[0].result) == 3


@pytest.mark.parametrize("arch,cut,point", [
    ("grok-1-314b", dict(num_layers=4, block_pattern="eeee"), 1),
    ("llama4-maverick-400b-a17b", dict(num_layers=3, block_pattern="ded"),
     0)])
def test_int8_tail_kv_halves_the_bytes_at_full_width(arch, cut, point):
    """The session's bytes-halved check on the full-width models at the
    depths and cuts the card streams (grok after ``seg0_e1``, llama4
    after ``seg0_d0``; counted on meta tensors): the tails hold only
    bf16 attention KV, so int8 codes and one float32 scale a (position,
    kv-head) of 128 channels cost 1/2 + 4/256 of the bytes."""
    model = build_model(get_config(arch).replace(**cut))
    ratio = TokenStreamSession._check_kv_bytes(
        SimpleNamespace(model=model), model.cfg.replace(kv_cache_bits=8),
        96, point)
    assert ratio == 0.5 + 4 / 256


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("continuous", [True, False])
def test_serve_cli_runs_on_the_cpu(arch, continuous, caplog):
    from repro_torch.launch.serve import main

    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--tokens", "3",
            "--batch", "2", "--prompt", "5"]
    if continuous:
        argv += ["--continuous", "--requests", "3"]
    with caplog.at_level("INFO"):
        assert main(argv) == 0
    assert arch in caplog.text
    assert ("engine steps" in caplog.text) == continuous
