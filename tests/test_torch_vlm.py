"""Parity of the port's vlm family (``qwen2-vl-7b``) with the reference's,
on the CPU.

Reduced ``qwen2-vl-7b`` (two dense blocks, RMSNorm, M-RoPE sections (8,
12, 12) of head_dim 64, a stub vision prefix through ``vision_proj``) in
float32, the reference's weights bridged into the port.

Tolerances: both packages compute the same float32 function but sum the
products and reductions in other orders, and take ``cos`` / ``sin`` from
other libraries, so logits, boundaries and caches agree within ``RTOL`` of
their scale and a layer's output within ``ATOL`` (as in
``test_torch_lm_*``). Integer ids (positions, M-RoPE ids, tokens, wire
bytes fed the same boundary) must be equal. Inside the port the one-shot
split equals the unsplit forward bit for bit at every point: it runs the
same blocks, in the same order, on the same tensors.
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
from repro.config import assigned_archs as jassigned_archs  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.core.decoupler import DecoupledPlan as JPlan  # noqa: E402
from repro.core.decoupler import DecoupledRunner as JRunner  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.models.layers import rope as jrope  # noqa: E402
from repro.serving.engine import ServeSession as JSession  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    ContinuousBatchingEngine as JBatching,
    GenRequest as JRequest,
)
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.config import ServeConfig, assigned_archs  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.decoupler import (  # noqa: E402
    DecoupledPlan,
    DecoupledRunner,
    TriDecoupledRunner,
)
from repro_torch.core.predictor import (  # noqa: E402
    CalibrationStats,
    build_tables,
    build_tables_reference,
)
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.layers import rope  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    GenRequest,
    ServeSession,
)

from conftest import reduced_model  # noqa: E402

ARCH = "qwen2-vl-7b"
RTOL = 1e-5
ATOL = 2e-5
CACHE_LEN = 40
CODECS = ("huffman", "bitpack", "perchannel")
_MODELS = {}


def _models():
    """(reference model, reference params, port model, port params)."""
    if ARCH not in _MODELS:
        jm, jp = reduced_model(ARCH)
        _MODELS[ARCH] = (jm, jp, build_model(get_config(ARCH).reduced()),
                         params_from_numpy(jax.device_get(jp), "cpu"))
    return _MODELS[ARCH]


def _batch(cfg, b, n_vis, text, seed=0):
    """Tokens and (``n_vis`` > 0) stub vision embeddings, numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(
        np.int32)}
    if n_vis:
        out["vision_embeds"] = rng.standard_normal(
            (b, n_vis, cfg.d_model)).astype(np.float32)
    return out


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


# ---------------------------------------------------------------------------
# Config, registry, synthetic batches
# ---------------------------------------------------------------------------


def test_config_and_assigned_archs_equal_reference():
    """The config field for field, and the registry's ten assigned
    architectures (every family of the reference now registered)."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jget_config(ARCH))
    assert repr(get_config(ARCH)) == repr(jget_config(ARCH))
    assert assigned_archs() == jassigned_archs()
    assert len(assigned_archs()) == 10


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
@pytest.mark.parametrize("seq,seed", [(20, 0), (32, 1), (100, 2)])
def test_make_batch_bit_for_bit(arch, seq, seed):
    """``make_batch``: the tokens and the modality stubs (vision
    embeddings, source frames) equal the reference's bit for bit."""
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_config(arch).reduced(),
                       jget_config(arch).reduced())):
        if cfg.d_model > 512 and seq > 32:
            continue                  # full width: keep the draw small
        a, b = make_batch(cfg, 2, seq, seed), jmake_batch(jcfg, 2, seq, seed)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == np.asarray(b[k]).tobytes()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_vis", [10, 16, 17])
def test_vision_positions_3d_equal_exactly(n_vis):
    """The (t, h, w) ids of a non-square (10, 17) and a square (16) vision
    prefix and the text after it."""
    for text in (1, 5):
        ref = np.asarray(jtf._vision_positions_3d(n_vis, text, 2))
        out = tf._vision_positions_3d(n_vis, text, 2).numpy()
        assert out.shape == ref.shape == (2, n_vis + text, 3)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_vis", [10, 16, 17])
def test_apply_mrope_matches_reference(n_vis):
    """M-RoPE at vision-grid and text ids, and at text-only ids."""
    rng = np.random.default_rng(n_vis)
    text, sections = 5, (8, 12, 12)
    x = rng.standard_normal((2, n_vis + text, 4, 64)).astype(np.float32)
    p3 = np.array(jtf._vision_positions_3d(n_vis, text, 2))
    txt = np.array(jrope.text_positions_3d(
        jnp.broadcast_to(jnp.arange(n_vis + text)[None], (2, n_vis + text))))
    np.testing.assert_array_equal(
        rope.text_positions_3d(torch.arange(n_vis + text)[None].expand(
            2, -1)).numpy(), txt)
    for ids in (p3, txt):
        ref = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(ids),
                                           1e6, sections))
        out = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(ids),
                               1e6, sections)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_mrope_at_text_positions_is_rope_bit_for_bit():
    """At ids (p, p, p) M-RoPE takes the same angles as RoPE (the same
    float32 products), so the port's two agree bit for bit."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, 4, 64)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9) + torch.tensor([[0], [40]])
    a = rope.apply_mrope(x, rope.text_positions_3d(pos), 1e6, (8, 12, 12))
    b = rope.apply_rope(x, pos, 1e6)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mrope_sections_must_sum_to_half_the_head():
    x = torch.zeros((1, 2, 1, 64))
    p3 = torch.zeros((1, 2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"must sum to 32"):
        rope.apply_mrope(x, p3, 1e6, (16, 24, 24))
    with pytest.raises(ValueError, match=r"must sum to 32"):
        jrope.apply_mrope(jnp.zeros((1, 2, 1, 64)), jnp.zeros((1, 2, 3)),
                          1e6, (16, 24, 24))


# ---------------------------------------------------------------------------
# Parameters and the planning surface
# ---------------------------------------------------------------------------


def test_param_tree_matches_reference():
    """Reduced: the bridged tree's shapes, and the port's own draw's."""
    jm, jp, m, p = _models()
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == jax.tree.map(
        lambda t: tuple(t.shape), p)
    assert m.param_count() == jm.param_count()
    own = m.init(0, "cpu")
    assert own["vision_proj"].shape == p["vision_proj"].shape
    assert m.decoupling_points() == jm.decoupling_points()


def test_full_width_tree_fmacs_and_boundary_bytes():
    """Full width, specs only: shapes and dtypes, 7,628,332,544
    parameters, 28 points; the latency model's inputs equal exactly."""
    jm, m = jbuild_model(jget_config(ARCH)), build_model(get_config(ARCH))
    jtree = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                         jm.abstract_params())
    ptree = jax.tree.map(lambda s: (tuple(s.shape), s.dtype), m.specs,
                         is_leaf=lambda x: hasattr(x, "logical"))
    assert ptree == jtree
    assert m.param_count() == jm.param_count() == 7_628_332_544
    assert m.active_param_count() == jm.active_param_count()
    assert m.decoupling_points() == jm.decoupling_points()
    assert len(m.decoupling_points()) == 28
    for b, s in [(1, 1), (2, 16), (4, 32)]:
        assert m.per_point_fmacs(b, s) == jm.per_point_fmacs(b, s)
        assert m.boundary_bytes(b, s) == jm.boundary_bytes(b, s)
        assert m.boundary_bytes(b, s, 2) == jm.boundary_bytes(b, s, 2)
        assert m.vis_len_for(s) == jm.vis_len_for(s)
        assert m.enc_len_for(s) == jm.enc_len_for(s) == 0


# ---------------------------------------------------------------------------
# Forward, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_vis", [0, 10, 17])
def test_forward_prefill_and_teacher_forced_decode(n_vis):
    """Text-only (n_vis 0) and with a vision prefix: forward and prefill
    logits, every cache leaf, then three teacher-forced decode steps at
    the positions after the whole prompt."""
    jm, jp, m, p = _models()
    batch = _batch(m.cfg, 2, n_vis, 6, seed=n_vis)
    jl = jm.forward(jp, _j(batch))
    tl = m.forward(p, _t(batch))
    assert tuple(tl.shape) == (2, n_vis + 6, m.cfg.vocab_size)
    assert _rel(tl, jl) < RTOL
    jl, jc = jm.prefill(jp, _j(batch), CACHE_LEN)
    tl, tc = m.prefill(p, _t(batch), CACHE_LEN)
    assert _rel(tl, jl) < RTOL
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape and _rel(t, j) < RTOL
    nxt = np.random.default_rng(9).integers(
        0, m.cfg.vocab_size, (2, 3)).astype(np.int32)
    for i in range(3):
        pos = n_vis + 6 + i
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, i:i + 1]),
                                jnp.int32(pos), jc)
        tl, tc = m.decode_step(p, torch.from_numpy(nxt[:, i:i + 1]), pos, tc)
        assert _rel(tl, jl) < RTOL
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert _rel(t, j) < RTOL


def test_rows_at_own_positions_take_their_own_mrope_ids():
    """The port decodes rows at their own ``(B,)`` positions, and M-RoPE
    lifts each row's position to (p, p, p): one batched step of two rows
    at positions 6 and 9 equals each row decoded alone at its position."""
    _, _, m, p = _models()
    caches = []
    for seed, s in ((1, 6), (2, 9)):
        b = _batch(m.cfg, 1, 0, s, seed=seed)
        caches.append(m.prefill(p, _t(b), CACHE_LEN)[1])
    both = [{k: torch.cat([a[k], b[k]], dim=1) for k in a}
            for a, b in zip(*caches)]
    toks = torch.tensor([[3], [5]])
    lg, _ = m.decode_step(p, toks, torch.tensor([6, 9]), both)
    for r, pos in ((0, 6), (1, 9)):
        alone = [{k: torch.cat([v[:, r:r + 1]] * 2, dim=1)
                  for k, v in c.items()} for c in both]
        one, _ = m.decode_step(p, toks[r:r + 1].expand(2, 1), pos, alone)
        assert torch.equal(lg[r], one[0])


def test_serve_session_after_a_vision_prefix_keeps_the_reference_quirk():
    """``ServeSession.generate`` decodes from ``pos = tokens.shape[1]``,
    the text length, although the prefill's cache holds the vision rows
    too, and the decode lifts ``pos`` to (p, p, p) while the prefill put
    the text at t = 1..T. The reference does this (``serving/engine.py``,
    ``models/transformer.py``), so the first decoded step differs from a
    forward over the prompt extended by that token by a large share of
    the logits' scale, in both packages. The port copies the behaviour:
    its tokens equal the reference's, and its first step shows the same
    gap. A text-only prompt decodes as its forward does."""
    jm, jp, m, p = _models()
    batch = make_batch(m.cfg, 2, 32, seed=1)        # 16 vision + 16 text
    assert batch["vision_embeds"].shape[1] == 16
    sc = dict(max_batch=2, max_seq_len=48)
    ref = JSession(jm, jp, JServeConfig(**sc)).generate(_j(batch), 5)
    out = ServeSession(m, p, ServeConfig(**sc)).generate(batch, 5)
    np.testing.assert_array_equal(out, np.asarray(ref))
    for b, gap in ((batch, True), ({"tokens": batch["tokens"]}, False)):
        logits, caches = m.prefill(p, _t(b), 48)
        first = logits[:, -1:].argmax(-1)
        step, _ = m.decode_step(p, first, b["tokens"].shape[1], caches)
        ext = dict(_t(b), tokens=torch.cat([_t(b)["tokens"], first], 1))
        full = m.forward(p, ext)[:, -1:]
        rel = float((step - full).abs().max() / full.abs().max())
        jlogits, jcaches = jm.prefill(jp, _j(b), 48)
        jstep, _ = jm.decode_step(jp, jnp.asarray(first.numpy()),
                                  jnp.int32(b["tokens"].shape[1]), jcaches)
        assert _rel(step, jstep) < RTOL
        assert (rel > 1e-2) if gap else (rel < RTOL)


# ---------------------------------------------------------------------------
# The one-shot split with extras
# ---------------------------------------------------------------------------


def test_one_shot_split_with_extras():
    """``run_head`` returns (boundary, extras): positions and M-RoPE ids
    equal the reference's exactly, the boundary and the tail's logits
    within RTOL; ``run_heads``' taps and extras equal ``run_head``'s; the
    split equals the unsplit forward bit for bit at every point, and
    ``run_segment`` chains it, returning the same extras."""
    jm, jp, m, p = _models()
    batch = _batch(m.cfg, 2, 10, 5, seed=4)
    full = m.forward(p, _t(batch))
    n = len(m.decoupling_points())
    taps = m.run_heads(p, _t(batch), list(range(n)))
    for point in range(n):
        jb, jex = jm.run_head(jp, _j(batch), point)
        tb, tex = m.run_head(p, _t(batch), point)
        assert sorted(tex) == sorted(jex) == ["enc_out", "pos3d", "positions"]
        assert tex["enc_out"] is None and jex["enc_out"] is None
        for k in ("positions", "pos3d"):
            np.testing.assert_array_equal(tex[k].numpy(), np.asarray(jex[k]))
        assert torch.equal(taps[point][0], tb)
        assert torch.equal(taps[point][1]["pos3d"], tex["pos3d"])
        assert _rel(tb, jb) < RTOL
        jl = jm.run_tail(jp, jb, point, jex)
        tl = m.run_tail(p, torch.from_numpy(np.array(jb)), point, tex)
        assert _rel(tl, jl) < RTOL
        assert torch.equal(m.run_tail(p, tb, point, tex), full)
        for to in range(point, n):
            mid, ex2 = m.run_segment(p, tb, point, to, tex)
            assert ex2 is tex
            assert torch.equal(m.run_tail(p, mid, to, tex), full)
        jmid, _ = jm.run_segment(jp, jb, point, n - 1, jex)
        assert _rel(m.run_segment(p, torch.from_numpy(np.array(jb)), point,
                                  n - 1, tex)[0], jmid) < RTOL
    with pytest.raises(ValueError, match="extras"):
        m.run_tail(p, tb, 0)


@pytest.mark.parametrize("codec", CODECS)
def test_decoupled_runner_wire_bytes_equal_reference(codec):
    """``DecoupledRunner.run`` per codec: its logits are the cloud step of
    its own blob and its bytes the blob's; fed the reference's boundary,
    the port's codec writes the reference's wire bytes, and the port's
    cloud step on that blob (with the port's extras) gives the
    reference's logits within RTOL. The extras never enter the blob."""
    jm, jp, m, p = _models()
    batch = _batch(m.cfg, 2, 10, 6, seed=5)
    for point, bits in ((0, 8), (1, 4)):
        plan = DecoupledPlan(point, bits, 0.0, 0.0, 0.0, codec)
        runner = DecoupledRunner(m, p, plan)
        logits, nbytes = runner.run(batch)
        blob, extras = runner.edge_step(batch)
        assert nbytes == blob.nbytes
        assert torch.equal(logits, runner.cloud_step(blob, extras))
        jrunner = JRunner(jm, jp, JPlan(point, bits, 0.0, 0.0, 0.0, codec))
        jblob, jex = jrunner.edge_step(_j(batch))
        jb, _ = jm.run_head(jp, _j(batch), point)
        tblob = get_codec(codec).encode(torch.from_numpy(np.array(jb)), bits)
        assert tblob.payload == jblob.payload
        assert tblob.nbytes == jblob.nbytes == jget_codec(codec).encode(
            jb, bits).nbytes
        assert tblob.shape == tuple(jblob.shape)
        out = runner.cloud_step(tblob, extras)
        assert _rel(out, jrunner.cloud_step(jblob, jex)) < RTOL
        # A batch of blobs with extras runs each through cloud_step.
        outs = runner.cloud_step_batch([blob, blob], [extras, extras])
        assert all(torch.equal(o, logits) for o in outs)
        pairs = runner.edge_step_batch([batch, batch])
        assert all(b.payload == blob.payload and e is not None
                   for b, e in pairs)


def test_tri_runner_carries_the_extras_through_both_cuts():
    """Device -> edge server -> cloud with the extras beside both blobs:
    at 16 bits the logits stay within 1e-3 of the forward's scale; a
    relay passes the blob and the extras on unchanged."""
    _, _, m, p = _models()
    batch = _batch(m.cfg, 2, 10, 6, seed=6)
    full = m.forward(p, _t(batch))
    for point2 in (0, 1):
        plan = DecoupledPlan(0, 16, 0.0, 0.0, 0.0, "bitpack", point2, 16,
                             "bitpack")
        tri = TriDecoupledRunner(m, p, plan)
        logits, b1, b2 = tri.run(batch)
        rel = float((logits - full).abs().max() / full.abs().max())
        assert rel < 1e-3 and b1 > 0 and b2 > 0
        blob, extras = tri.device_step(batch)
        blob2, extras2 = tri.edge_server_step(blob, extras)
        assert extras2 is extras
        assert (blob2 is blob) == (point2 == 0)


def test_build_tables_equals_the_loop_oracle():
    """The one-pass calibration (the extras repeated across the stacked
    bit widths) equals the per-cell loop bit for bit, every codec."""
    _, _, m, p = _models()
    batches = [make_batch(m.cfg, 2, 24, seed=7)]
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
# Serving: streaming refused, the engine on text prompts, the CLI
# ---------------------------------------------------------------------------


def test_token_streaming_refused_with_the_reference_message():
    jm, jp, m, p = _models()
    batch = make_batch(m.cfg, 1, 32, seed=0)
    with pytest.raises(ValueError) as ref:
        jm.prefill_head(jp, _j(batch), 48, 0)
    with pytest.raises(ValueError) as out:
        m.prefill_head(p, _t(batch), 48, 0)
    assert str(out.value) == str(ref.value)
    assert "vision positions" in str(out.value)
    for call in (lambda: m.init_head_caches(1, 48, 0, "cpu"),
                 lambda: m.init_tail_caches(1, 48, 0, "cpu"),
                 lambda: m.prefill_tail(p, torch.zeros(1, 4, 256), 48, 0),
                 lambda: DecoupledRunner(m, p, DecoupledPlan(
                     0, 8, 0.0, 0.0, 0.0, "bitpack")).stream_session(
                         ServeConfig(max_batch=1, max_seq_len=48))):
        with pytest.raises(ValueError, match="token streaming"):
            call()


def test_engine_on_text_prompts_matches_reference_and_solo():
    """The continuous-batching engine serves a vlm's text prompts: its
    tokens and events equal the reference's, each request's tokens equal
    a one-slot engine's."""
    jm, jp, m, p = _models()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, m.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    new, arrivals = (5, 3, 6), (0, 0, 2)

    def run(engine, cls, which=range(3)):
        for i in which:
            engine.submit(cls(uid=i, tokens=prompts[i], max_new_tokens=new[i],
                              arrival=arrivals[i] if len(which) > 1 else 0))
        return {r.uid: r.result for r in engine.run()}

    jeng = JBatching(jm, jp, JServeConfig(max_batch=2, max_seq_len=32))
    ref = run(jeng, JRequest)
    eng = ContinuousBatchingEngine(m, p, ServeConfig(max_batch=2,
                                                     max_seq_len=32))
    out = run(eng, GenRequest)
    assert eng.events == jeng.events
    for i in range(3):
        np.testing.assert_array_equal(out[i], ref[i])
        solo = ContinuousBatchingEngine(m, p, ServeConfig(max_batch=1,
                                                          max_seq_len=32))
        np.testing.assert_array_equal(out[i], run(solo, GenRequest, [i])[i])


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_cli_runs_on_the_cpu(continuous, caplog):
    from repro_torch.launch.serve import main

    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--tokens", "4",
            "--batch", "2"]
    if continuous:
        argv += ["--continuous", "--requests", "3"]
    with caplog.at_level("INFO"):
        assert main(argv) == 0
    assert ARCH in caplog.text
