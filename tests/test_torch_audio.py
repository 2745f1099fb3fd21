"""Parity of the port's audio family (``seamless-m4t-large-v2``) with the
reference's, on the CPU.

Reduced ``seamless-m4t-large-v2`` (two ``'E'`` encoder blocks over stub
source frames, two ``'c'`` decoder blocks with cross attention, layernorm,
no RoPE, GELU MLPs) in float32, the reference's weights bridged into the
port.

Tolerances: both packages compute the same float32 function but sum the
products and reductions in other orders, so logits, encoder outputs,
boundaries and caches agree within ``RTOL`` of their scale and a layer's
output within ``ATOL`` (as in ``test_torch_lm_*``). An int8 KV cache
rounds the same keys to codes, and a key within an ulp of a rounding edge
may take the neighbouring code: codes agree within 1, and a decode step
on them within ``Q8_RTOL``. Positions, tokens and wire bytes fed the same
boundary must be equal. Inside the port the one-shot split equals the
unsplit forward bit for bit at every point.
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
from repro.config import ServeConfig as JServeConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.core.decoupler import DecoupledPlan as JPlan  # noqa: E402
from repro.core.decoupler import DecoupledRunner as JRunner  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.serving.engine import ServeSession as JSession  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    ContinuousBatchingEngine as JBatching,
    GenRequest as JRequest,
)
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.config import ServeConfig, get_config  # noqa: E402
from repro_torch.core.decoupler import (  # noqa: E402
    DecoupledPlan,
    DecoupledRunner,
)
from repro_torch.core.predictor import (  # noqa: E402
    CalibrationStats,
    build_tables,
    build_tables_reference,
)
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    GenRequest,
    ServeSession,
)

from conftest import reduced_model  # noqa: E402

ARCH = "seamless-m4t-large-v2"
RTOL = 1e-5
ATOL = 2e-5
Q8_RTOL = 1e-3          # a decode step on int8 KV: one code step a few keys
CACHE_LEN = 16
CODECS = ("huffman", "bitpack", "perchannel")
_MODELS = {}


def _models(**over):
    """(reference model, reference params, port model, port params); the
    same weights under config overrides (``kv_cache_bits``)."""
    key = tuple(sorted(over.items()))
    if key not in _MODELS:
        jm, jp = reduced_model(ARCH)
        if over:
            jm = jbuild_model(jm.cfg.replace(**over))
        _MODELS[key] = (jm, jp,
                        build_model(get_config(ARCH).reduced().replace(**over)),
                        params_from_numpy(jax.device_get(jp), "cpu"))
    return _MODELS[key]


def _batch(cfg, b, text, frames, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(
                np.int32),
            "src_frames": (rng.standard_normal((b, frames, cfg.d_model))
                           * 0.1).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(port.detach().numpy() - ref)) / max(
        np.max(np.abs(ref)), 1e-30)


def _leaves(caches):
    return [c[k] for c in caches for k in sorted(c)]


def _layer0(jp, p, *path):
    """Layer 0 of a stacked block tree in both packages."""
    jt, pt = jp, p
    for k in path:
        jt, pt = jt[k], pt[k]
    return jax.tree.map(lambda a: a[0], jt), tf._unstack(pt, 1)[0]


# ---------------------------------------------------------------------------
# Layers: cross attention, the E and c blocks
# ---------------------------------------------------------------------------


def test_cross_attention_matches_reference():
    """Non-causal attention over encoder keys of another length; a cross
    block's spec has no qk-norm even where the config asks for one."""
    jm, jp, m, p = _models()
    jl, pl = _layer0(jp, p, "segments", 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 9, 256)).astype(np.float32)
    jk, jv = jattn.cross_attention_kv(jl["xattn"], jnp.asarray(enc))
    tk, tv = attn.cross_attention_kv(pl["xattn"], torch.from_numpy(enc))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    ref = jattn.cross_attention(jl["xattn"], jnp.asarray(x), jk, jv)
    out = attn.cross_attention(pl["xattn"], torch.from_numpy(x), tk, tv)
    assert tuple(out.shape) == (2, 5, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    qk = get_config("qwen3-8b").reduced()
    assert qk.qk_norm
    assert "q_norm" in attn.attention_spec(qk)
    assert sorted(attn.attention_spec(qk, cross=True)) == sorted(
        jattn.attention_spec(jget_config("qwen3-8b").reduced(), cross=True))
    assert "q_norm" not in attn.attention_spec(qk, cross=True)


def test_encoder_block_matches_reference():
    """An ``'E'`` block: bidirectional, no RoPE (``rope_kind`` none), no
    cache even when one is asked for."""
    jm, jp, m, p = _models()
    jl, pl = _layer0(jp, p, "encoder", "segments", 0)
    x = np.random.default_rng(2).standard_normal((2, 7, 256)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    ref, _, jc = jblk.block_apply_seq(
        "E", jl, jnp.asarray(x), jblk.SeqContext(jnp.asarray(pos), None, 0,
                                                 CACHE_LEN), jm.cfg)
    out, aux, tc = blk.block_apply_seq(
        "E", pl, torch.from_numpy(x),
        blk.SeqContext(torch.from_numpy(pos.copy()), 0, CACHE_LEN), m.cfg)
    assert jc is None and tc is None and aux is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert blk.init_block_cache("E", m.cfg, 2, CACHE_LEN,
                                torch.float32) == {}
    with pytest.raises(ValueError):
        blk.block_apply_decode("E", pl, torch.from_numpy(x[:, :1]), {},
                               blk.DecodeContext(torch.tensor([7, 7]), 0),
                               m.cfg)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_cross_block_sequence_and_decode(kv_bits):
    """A ``'c'`` block over a sequence (its cache: self K/V, and the
    encoder's ``xk``/``xv`` in the activation dtype also when the self
    K/V is int8), then two decode steps against that cache."""
    jm, jp, m, p = _models(kv_cache_bits=kv_bits)
    jl, pl = _layer0(jp, p, "segments", 0)
    rng = np.random.default_rng(3 + kv_bits)
    x = rng.standard_normal((2, 6, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 9, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6))
    ref, _, jc = jblk.block_apply_seq(
        "c", jl, jnp.asarray(x),
        jblk.SeqContext(jnp.asarray(pos), None, 0, CACHE_LEN,
                        jnp.asarray(enc)), jm.cfg)
    out, aux, tc = blk.block_apply_seq(
        "c", pl, torch.from_numpy(x),
        blk.SeqContext(torch.from_numpy(pos.copy()), 0, CACHE_LEN,
                       enc_out=torch.from_numpy(enc)), m.cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert aux is None
    assert sorted(tc) == sorted(jc)
    zero = blk.init_block_cache("c", m.cfg, 2, CACHE_LEN, torch.float32,
                                enc_len=9)
    jzero = jblk.init_block_cache("c", jm.cfg, 2, CACHE_LEN, jnp.float32, 9)
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape == tuple(zero[k].shape)
        assert str(zero[k].dtype).split(".")[-1] == str(jzero[k].dtype)
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype)
    for k in ("xk", "xv"):
        assert tc[k].dtype == torch.float32
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0,
                                   atol=ATOL)
    if kv_bits == 8:
        assert tc["k"].dtype == torch.int8
        for k in ("k", "v"):
            d = tc[k].numpy().astype(np.int32) - np.asarray(jc[k]).astype(
                np.int32)
            assert np.max(np.abs(d)) <= 1
            assert _rel(tc[k + "s"], jc[k + "s"]) < RTOL
    tol = Q8_RTOL if kv_bits else RTOL
    for step in range(2):
        xs = rng.standard_normal((2, 1, 256)).astype(np.float32)
        ref, jc = jblk.block_apply_decode(
            "c", jl, jnp.asarray(xs), jc,
            jblk.DecodeContext(jnp.int32(6 + step), 0), jm.cfg)
        out, tc = blk.block_apply_decode(
            "c", pl, torch.from_numpy(xs), tc,
            blk.DecodeContext(torch.tensor([6 + step] * 2), 0), m.cfg)
        assert _rel(out, ref) < tol


# ---------------------------------------------------------------------------
# Parameters and the planning surface
# ---------------------------------------------------------------------------


def test_config_and_param_tree_match_reference():
    """Reduced: the config, the bridged tree's shapes (the ``encoder``
    subtree too), the parameter count and the decoupling points (the
    decoder's blocks only); the port's own draw has the same tree."""
    jm, jp, m, p = _models()
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jget_config(ARCH))
    shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == shapes
    assert jax.tree.map(lambda t: tuple(t.shape), m.init(0, "cpu")) == shapes
    assert m.param_count() == jm.param_count()
    assert m.decoupling_points() == jm.decoupling_points()
    assert sorted(p["encoder"]) == ["final_norm", "segments"]


def test_full_width_tree_fmacs_and_boundary_bytes():
    """Full width, specs only: shapes and dtypes, 1,632,698,368
    parameters, 24 points; the latency model's inputs equal exactly (a
    ``'c'`` block counts ``2 attn + 3 d d_ff``, as the reference does)."""
    jm, m = jbuild_model(jget_config(ARCH)), build_model(get_config(ARCH))
    jtree = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                         jm.abstract_params())
    ptree = jax.tree.map(lambda s: (tuple(s.shape), s.dtype), m.specs,
                         is_leaf=lambda x: hasattr(x, "logical"))
    assert ptree == jtree
    assert m.param_count() == jm.param_count() == 1_632_698_368
    assert m.decoupling_points() == jm.decoupling_points()
    assert len(m.decoupling_points()) == 24
    for b, s in [(1, 1), (2, 16), (4, 32)]:
        assert m.per_point_fmacs(b, s) == jm.per_point_fmacs(b, s)
        assert m.boundary_bytes(b, s) == jm.boundary_bytes(b, s)
        assert m.boundary_bytes(b, s, 2) == jm.boundary_bytes(b, s, 2)
        assert m.enc_len_for(s) == jm.enc_len_for(s) == s // 4
        assert m.vis_len_for(s) == jm.vis_len_for(s) == 0


# ---------------------------------------------------------------------------
# Encoder, forward, prefill and decode
# ---------------------------------------------------------------------------


def test_run_encoder_and_init_caches_match_reference():
    jm, jp, m, p = _models()
    src = _batch(m.cfg, 2, 4, 11, seed=4)["src_frames"]
    ref = jtf.run_encoder(jp, jm.cfg, jnp.asarray(src))
    out = tf.run_encoder(p, m.cfg, torch.from_numpy(src))
    assert tuple(out.shape) == (2, 11, 256)
    assert _rel(out, ref) < RTOL
    jc = jm.init_caches(2, CACHE_LEN, 11)
    tc = m.init_caches(2, CACHE_LEN, "cpu", enc_len=11)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape and not t.any()


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_forward_prefill_and_teacher_forced_decode(kv_bits):
    """Forward and prefill logits with ``src_frames``, every cache leaf
    (int8 codes within 1), then three teacher-forced decode steps."""
    jm, jp, m, p = _models(kv_cache_bits=kv_bits)
    batch = _batch(m.cfg, 2, 6, 8, seed=5)
    if not kv_bits:
        assert _rel(m.forward(p, _t(batch)), jm.forward(jp, _j(batch))) \
            < RTOL
    jl, jc = jm.prefill(jp, _j(batch), CACHE_LEN)
    tl, tc = m.prefill(p, _t(batch), CACHE_LEN)
    assert _rel(tl, jl) < RTOL
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.int8:
            assert np.max(np.abs(t.numpy().astype(np.int32)
                                 - np.asarray(j).astype(np.int32))) <= 1
        else:
            assert _rel(t, j) < RTOL
    nxt = np.random.default_rng(6).integers(
        0, m.cfg.vocab_size, (2, 3)).astype(np.int32)
    for i in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, i:i + 1]),
                                jnp.int32(6 + i), jc)
        tl, tc = m.decode_step(p, torch.from_numpy(nxt[:, i:i + 1]), 6 + i,
                               tc)
        assert _rel(tl, jl) < (Q8_RTOL if kv_bits else RTOL)


def test_serve_session_matches_reference_and_the_forward():
    """``ServeSession`` with ``src_frames``: greedy tokens equal the
    reference's, and the first decoded step equals a forward over the
    prompt extended by that token within RTOL (the encoder output rides
    in every ``'c'`` block's cache)."""
    jm, jp, m, p = _models()
    batch = make_batch(m.cfg, 2, 32, seed=1)       # 32 tokens, 8 frames
    assert batch["src_frames"].shape[1] == 8
    sc = dict(max_batch=2, max_seq_len=48)
    ref = JSession(jm, jp, JServeConfig(**sc)).generate(_j(batch), 5)
    out = ServeSession(m, p, ServeConfig(**sc)).generate(batch, 5)
    np.testing.assert_array_equal(out, np.asarray(ref))
    logits, caches = m.prefill(p, _t(batch), 48)
    first = logits[:, -1:].argmax(-1)
    step, _ = m.decode_step(p, first, 32, caches)
    ext = dict(_t(batch), tokens=torch.cat([_t(batch)["tokens"], first], 1))
    full = m.forward(p, ext)[:, -1:]
    assert float((step - full).abs().max() / full.abs().max()) < RTOL


# ---------------------------------------------------------------------------
# The one-shot split with extras
# ---------------------------------------------------------------------------


def test_one_shot_split_with_extras():
    """``run_head`` returns (boundary, extras): positions equal the
    reference's, the encoder output within RTOL, ``pos3d`` None in both;
    the split equals the unsplit forward bit for bit at every point, and
    ``run_segment`` chains it, returning the same extras."""
    jm, jp, m, p = _models()
    batch = _batch(m.cfg, 2, 5, 8, seed=7)
    full = m.forward(p, _t(batch))
    n = len(m.decoupling_points())
    taps = m.run_heads(p, _t(batch), list(range(n)))
    for point in range(n):
        jb, jex = jm.run_head(jp, _j(batch), point)
        tb, tex = m.run_head(p, _t(batch), point)
        assert tex["pos3d"] is None and jex["pos3d"] is None
        np.testing.assert_array_equal(tex["positions"].numpy(),
                                      np.asarray(jex["positions"]))
        assert _rel(tex["enc_out"], jex["enc_out"]) < RTOL
        assert torch.equal(taps[point][0], tb)
        assert torch.equal(taps[point][1]["enc_out"], tex["enc_out"])
        assert _rel(tb, jb) < RTOL
        jl = jm.run_tail(jp, jb, point, jex)
        tl = m.run_tail(p, torch.from_numpy(np.array(jb)), point, tex)
        assert _rel(tl, jl) < RTOL
        assert torch.equal(m.run_tail(p, tb, point, tex), full)
        for to in range(point, n):
            mid, ex2 = m.run_segment(p, tb, point, to, tex)
            assert ex2 is tex
            assert torch.equal(m.run_tail(p, mid, to, tex), full)
    with pytest.raises(ValueError, match="extras"):
        m.run_segment(p, tb, 0, 1)


@pytest.mark.parametrize("codec", CODECS)
def test_decoupled_runner_wire_bytes_equal_reference(codec):
    """As for the vlm: the port's run is its own blob's cloud step; fed
    the reference's boundary, the port's codec writes the reference's
    bytes, and the cloud step on that blob (with the port's encoder
    output beside it, never inside it) gives the reference's logits."""
    jm, jp, m, p = _models()
    batch = _batch(m.cfg, 2, 6, 8, seed=8)
    for point, bits in ((0, 8), (1, 2)):
        plan = DecoupledPlan(point, bits, 0.0, 0.0, 0.0, codec)
        runner = DecoupledRunner(m, p, plan)
        logits, nbytes = runner.run(batch)
        blob, extras = runner.edge_step(batch)
        assert nbytes == blob.nbytes and extras["enc_out"] is not None
        assert torch.equal(logits, runner.cloud_step(blob, extras))
        jrunner = JRunner(jm, jp, JPlan(point, bits, 0.0, 0.0, 0.0, codec))
        jblob, jex = jrunner.edge_step(_j(batch))
        jb, _ = jm.run_head(jp, _j(batch), point)
        tblob = get_codec(codec).encode(torch.from_numpy(np.array(jb)), bits)
        assert tblob.payload == jblob.payload
        assert tblob.nbytes == jblob.nbytes == jget_codec(codec).encode(
            jb, bits).nbytes
        out = runner.cloud_step(tblob, extras)
        assert _rel(out, jrunner.cloud_step(jblob, jex)) < RTOL


def test_build_tables_equals_the_loop_oracle():
    _, _, m, p = _models()
    batches = [make_batch(m.cfg, 2, 16, seed=9)]
    s_ref, s_vec = CalibrationStats(), CalibrationStats()
    ref = build_tables_reference(m, p, batches, [2, 4, 8], codecs=CODECS,
                                 points=[0, 1], stats=s_ref)
    vec = build_tables(m, p, batches, [2, 4, 8], codecs=CODECS,
                       points=[0, 1], stats=s_vec)
    np.testing.assert_array_equal(vec.acc_drop, ref.acc_drop)
    np.testing.assert_array_equal(vec.size_bytes, ref.size_bytes)
    assert vec.base_accuracy == ref.base_accuracy == 1.0
    assert s_vec.tail_forwards < s_ref.tail_forwards


# ---------------------------------------------------------------------------
# Serving: streaming and the engine refused, the CLI
# ---------------------------------------------------------------------------


def test_token_streaming_refused_with_the_reference_message():
    jm, jp, m, p = _models()
    batch = make_batch(m.cfg, 1, 16, seed=0)
    with pytest.raises(ValueError) as ref:
        jm.prefill_head(jp, _j(batch), 32, 0)
    with pytest.raises(ValueError) as out:
        m.prefill_head(p, _t(batch), 32, 0)
    assert str(out.value) == str(ref.value)
    assert "encoder output" in str(out.value)
    with pytest.raises(ValueError, match="token streaming"):
        DecoupledRunner(m, p, DecoupledPlan(
            0, 8, 0.0, 0.0, 0.0, "bitpack")).stream_session(
                ServeConfig(max_batch=1, max_seq_len=32))


def test_continuous_engine_refused_at_the_first_prefill():
    """The reference's engine prefills ``{"tokens"}`` alone and fails for
    want of ``src_frames`` (a ``KeyError``); the port refuses at the same
    place with a ``ValueError`` that names them."""
    jm, jp, m, p = _models()
    prompt = np.arange(1, 6, dtype=np.int32)
    jeng = JBatching(jm, jp, JServeConfig(max_batch=2, max_seq_len=32))
    jeng.submit(JRequest(uid=0, tokens=prompt, max_new_tokens=3))
    with pytest.raises(KeyError, match="src_frames"):
        jeng.run()
    eng = ContinuousBatchingEngine(m, p, ServeConfig(max_batch=2,
                                                     max_seq_len=32))
    eng.submit(GenRequest(uid=0, tokens=prompt, max_new_tokens=3))
    with pytest.raises(ValueError, match="src_frames"):
        eng.run()


def test_serve_cli_runs_on_the_cpu(caplog):
    from repro_torch.launch.serve import main

    with caplog.at_level("INFO"):
        assert main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--tokens", "4", "--batch", "2"]) == 0
    assert ARCH in caplog.text
    with pytest.raises(ValueError, match="src_frames"):
        main(["--arch", ARCH, "--reduced", "--device", "cpu", "--tokens",
              "3", "--continuous", "--requests", "2"])
