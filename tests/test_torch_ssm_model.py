"""Parity of the port's recurrent decoders with the reference's, on the CPU.

Reduced ``zamba2-2.7b`` (two Mamba2 blocks, then the shared attention
block ``A``), reduced ``xlstm-1.3b`` (two mLSTM blocks) and an ``"ls"``
variant of it (mLSTM, then sLSTM: ``.reduced()`` keeps the first two
blocks of the pattern, which leaves the sLSTM out), in float32, with the
reference's weights bridged into the port.

Tolerances: both packages compute the same float32 function but sum the
products, reductions and cumulative sums in other orders, so logits and
states agree within ``RTOL`` of their scale (measured up to 1.3e-6).
Inside the port, the split forward equals the unsplit one bit for bit at
every point: it runs the same blocks in the same order on the same
tensors. ``compress_state`` equals the *compiled* reference bit for bit
(XLA turns the dequant's ``/ levels`` into a multiplication by the
float32 reciprocal and fuses ``q * step + mn``; the port's
``quantize_dequantize`` does both, as the codecs' decodes do).
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

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import list_archs as jlist_archs  # noqa: E402
from repro.core.decoupler import compress_state as jcompress  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro_torch.config import get_config, list_archs  # noqa: E402
from repro_torch.core.decoupler import compress_state  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

from conftest import reduced_model  # noqa: E402


RTOL = 1e-5
CACHE_LEN = 16
# arch id -> overrides of the reduced config ("ls": the sLSTM variant).
VARIANTS = {"zamba2-2.7b": {}, "xlstm-1.3b": {},
            "xlstm-ls": {"block_pattern": "ls"}}
_MODELS = {}


def _models(name):
    """(reference model, reference params, port model, port params), built
    once per module run."""
    if name not in _MODELS:
        over = VARIANTS[name]
        arch = "xlstm-1.3b" if name == "xlstm-ls" else name
        m = build_model(get_config(arch).reduced().replace(**over))
        if over:      # the port's weights from a seed, handed to the
            jm = jbuild_model(jget_config(arch).reduced().replace(**over))
            p = m.init(1, "cpu")
            jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
        else:
            jm, jp = reduced_model(arch)
            p = params_from_numpy(jax.device_get(jp), "cpu")
        _MODELS[name] = (jm, jp, m, p)
    return _MODELS[name]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(port.detach().numpy() - ref)) / max(
        np.max(np.abs(ref)), 1e-30)


def _port_leaves(caches):
    return [c[k] for c in caches for k in sorted(c)]


def _ref_leaves(jcaches, plan):
    """The reference's cache leaves in the port's order; a shared
    segment's entry gains the port's layer axis of 1."""
    out = []
    for seg, c in zip(plan, jcaches):
        for k in sorted(c):
            a = np.asarray(c[k])
            out.append(a[None] if seg.shared else a)
    return out


# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jlist_archs())
def test_registered_configs_equal_reference(arch):
    """Every config the reference registers equals, field for field, the
    port's entry of the same arch id (the port-only archs, which the
    reference has no entry for, are held in their own tests)."""
    assert arch in list_archs()
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))
    assert repr(get_config(arch)) == repr(jget_config(arch))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_param_tree_matches_reference_at_full_width(arch):
    """Shapes, dtypes and the shared block's structure of the full-width
    trees (specs only, nothing materialized): one ``shared_attn`` set and
    an empty tree at each of its nine invocations."""
    jm, m = jbuild_model(jget_config(arch)), build_model(get_config(arch))
    jtree = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                         jm.abstract_params())
    ptree = jax.tree.map(lambda s: (tuple(s.shape), s.dtype), m.specs,
                         is_leaf=lambda x: hasattr(x, "logical"))
    assert ptree == jtree
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()
    assert m.decoupling_points() == jm.decoupling_points()
    plan = tf.segment_plan(m.cfg)
    shared = [i for i, s in enumerate(plan) if s.shared]
    assert [m.specs["segments"][i] for i in shared] == [{}] * len(shared)
    assert len(shared) == tf.num_shared_invocations(plan) == (
        9 if arch == "zamba2-2.7b" else 0)
    assert ("shared_attn" in m.specs) == bool(shared)
    for b, s in [(1, 1), (2, 16)]:
        assert m.per_point_fmacs(b, s) == jm.per_point_fmacs(b, s)
        assert m.boundary_bytes(b, s, 2) == jm.boundary_bytes(b, s, 2)


def test_block_kinds_and_reduced_trees():
    """m, l, s, A, e, E and c build (E and c with their layernorms and
    GELU MLPs); an unknown kind raises. The reduced trees bridged from the
    reference keep its shapes (sLSTM variant included)."""
    from repro_torch.models import blocks

    cfg = get_config("zamba2-2.7b").reduced()
    for kind in "mlsA":
        assert blocks.block_spec(kind, cfg)
    assert blocks.block_spec("e", get_config("grok-1-314b").reduced())
    for kind in "Ec":
        spec = blocks.block_spec(kind, cfg)
        assert set(spec["mlp"]) == {"w_in", "b_in", "w_out", "b_out"}
        assert set(spec["ln1"]) == {"scale", "bias"}
    assert "ln_x" in blocks.block_spec("c", cfg)
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.block_spec("z", cfg)
    for name in VARIANTS:
        jm, jp, m, p = _models(name)
        assert jax.tree.map(lambda a: tuple(a.shape), jp) == jax.tree.map(
            lambda t: tuple(t.shape), p)
        assert m.param_count() == jm.param_count()
        assert m.decoupling_points() == jm.decoupling_points()


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,seq", [("zamba2-2.7b", 7), ("xlstm-1.3b", 7),
                                      ("xlstm-ls", 7)])
def test_prefill_and_teacher_forced_decode(name, seq):
    """Prefill logits and every cache leaf, then two teacher-forced decode
    steps. (The chunked SSD of a 512-token prompt is held against the
    reference layer by layer in ``test_torch_ssm_layers.py``.)"""
    jm, jp, m, p = _models(name)
    toks = _tokens(m.cfg, 2, seq)
    L = seq + 4
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, L)
    with torch.no_grad():
        tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, L)
        assert _rel(tl, jl) < RTOL
        plan = tf.segment_plan(m.cfg)
        for t, j in zip(_port_leaves(tc), _ref_leaves(jc, plan)):
            assert tuple(t.shape) == j.shape and _rel(t, j) < RTOL
        nxt = _tokens(m.cfg, toks.shape[0], 2, seed=1)
        for i in range(2):
            step = nxt[:, i:i + 1]
            jl, jc = jm.decode_step(jp, jnp.asarray(step),
                                    jnp.int32(seq + i), jc)
            tl, tc = m.decode_step(p, torch.from_numpy(step), seq + i, tc)
            assert _rel(tl, jl) < RTOL


# ---------------------------------------------------------------------------
# The token split, inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,over", [
    ("zamba2-2.7b", {"block_pattern": "mmmm", "num_layers": 4}),
    ("xlstm-ls", {"block_pattern": "lsl", "num_layers": 3}),
])
def test_split_forward_bitwise_equals_unsplit(name, over):
    """prefill_head -> prefill_tail and decode_head -> decode_tail give the
    unsplit logits and caches bit for bit at every point. The zamba2
    variant's plan is m2 A m2 A, so a cut falls right before each ``A``
    (points 1, 4) and right after it (points 2, 5): the head and the tail
    each hold only their own invocations' KV caches and both read the one
    ``shared_attn`` set."""
    _, _, m0, p0 = _models(name)
    m = build_model(m0.cfg.replace(**over))
    p = m.init(3, "cpu")
    plan = tf.segment_plan(m.cfg)
    L = 12
    toks = torch.from_numpy(_tokens(m.cfg, 2, 6, seed=4))
    with torch.no_grad():
        ref_logits, ref_caches = m.prefill(p, {"tokens": toks}, L)
        nxt = ref_logits[:, -1].argmax(-1)[:, None]
        ref_step, ref_after = m.decode_step(
            p, nxt, 6, [{k: v.clone() for k, v in c.items()}
                        for c in ref_caches])
        n = len(m.decoupling_points())
        for point in range(n):
            boundary, head = m.prefill_head(p, {"tokens": toks}, L, point)
            logits, tail = m.prefill_tail(p, boundary, L, point)
            assert torch.equal(logits, ref_logits)
            b, head = m.decode_head(p, nxt, 6, head, point, L)
            step, tail = m.decode_tail(p, b, 6, tail, point, L)
            assert torch.equal(step, ref_step)
            # The head's and the tail's leaves are the unsplit ones, cut at
            # the point: whole segments, plus the two halves of a cut one.
            si, off = tf.point_to_segment(m.cfg, point)
            want_head, want_tail = [], []
            for sj, c in enumerate(ref_after):
                if sj < si or (sj == si and off + 1 == plan[sj].count):
                    want_head.append(c)
                elif sj > si:
                    want_tail.append(c)
                else:
                    want_head.append({k: v[:off + 1] for k, v in c.items()})
                    want_tail.append({k: v[off + 1:] for k, v in c.items()})
            for got, want in ((head, want_head), (tail, want_tail)):
                assert len(got) == len(want)
                for g, w in zip(_port_leaves(got), _port_leaves(want)):
                    assert torch.equal(g, w)
    if name == "zamba2-2.7b":
        assert [s.kind for s in plan] == ["m", "A", "m", "A"]
        assert [tf.point_to_segment(m.cfg, q) for q in (1, 2, 4, 5)] == [
            (0, 1), (1, 0), (2, 1), (3, 0)]


def test_idle_rows_keep_their_recurrent_state():
    """A decode with ``live`` off for a row leaves every leaf of that row
    (SSM state, conv window, mLSTM C / n / m, sLSTM c / n / hid / m)
    exactly as it was, and advances the live rows as a decode of them
    alone would."""
    for name in ("zamba2-2.7b", "xlstm-ls"):
        _, _, m, p = _models(name)
        toks = torch.from_numpy(_tokens(m.cfg, 3, 5, seed=6))
        with torch.no_grad():
            _, caches = m.prefill(p, {"tokens": toks}, 8)
            before = [{k: v.clone() for k, v in c.items()} for c in caches]
            live = torch.tensor([True, False, True])
            nxt = toks[:, -1:]
            lg, _ = m.decode_step(p, nxt, 5, caches, live)
            ref, after = m.decode_step(p, nxt, 5, [
                {k: v.clone() for k, v in c.items()} for c in before])
        for c, b, a in zip(caches, before, after):
            for k in c:
                assert torch.equal(c[k][:, 1], b[k][:, 1]), (name, k)
                assert torch.equal(c[k][:, 0], a[k][:, 0])
        assert torch.equal(lg[0], ref[0]) and torch.equal(lg[2], ref[2])


# ---------------------------------------------------------------------------
# compress_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_compress_state_equals_reference(bits):
    """The same cache trees (the port's prefill caches, handed to the
    reference in its layout): every floating leaf quantized and
    dequantized with its own range, equal bit for bit to the compiled
    reference; int8 KV codes pass through."""
    jfn = jax.jit(jcompress, static_argnums=1)
    for name in ("zamba2-2.7b", "xlstm-ls"):
        _, _, m, p = _models(name)
        plan = tf.segment_plan(m.cfg)
        toks = torch.from_numpy(_tokens(m.cfg, 2, 9, seed=8))
        models = [m]
        if name == "zamba2-2.7b":        # the int8 KV of the shared block
            models.append(build_model(m.cfg.replace(kv_cache_bits=8)))
        for model in models:
            with torch.no_grad():
                tc = model.prefill(p, {"tokens": toks}, 12)[1]
            jc = [{k: jnp.asarray(v[0].numpy() if seg.shared
                                  else v.numpy()) for k, v in c.items()}
                  for seg, c in zip(plan, tc)]
            ref = _ref_leaves(jfn(jc, bits), plan)
            got = compress_state(tc, bits)
            for g, r, src in zip(_port_leaves(got), ref,
                                 _port_leaves(tc)):
                assert str(g.dtype).split(".")[-1] == str(r.dtype)
                np.testing.assert_array_equal(
                    g.numpy().view(np.uint8), r.view(np.uint8))
                if src.dtype == torch.int8:
                    np.testing.assert_array_equal(r, src.numpy())
