"""Parity of the port's Mixture-of-Experts decoders with the reference's,
on the CPU.

Reduced ``grok-1-314b`` (pattern ``ee``: d_model 256, 4 experts top-2,
expert FFN 512) and reduced ``llama4-maverick-400b-a17b`` (pattern
``de``: a dense block, then 4 experts top-1) in float32, with the
reference's weights bridged into the port; the full-width configs on
specs only (nothing is materialized).

Tolerances: both packages compute the same float32 function but sum the
products in other orders, so logits and caches agree within ``RTOL`` of
their scale (measured up to 1.5e-6 here). The routing of these prompts has
no near-tie a float32 ulp could flip (a flipped choice would move the
logits by far more than RTOL). Inside the port the split forward equals
the unsplit one bit for bit at every point: it runs the same blocks in
the same order on the same tensors, and an MoE block's groups lie within
one row's sequence, which the cut does not change.

Also here: the CPU draw of ``models/init.py`` is pinned by a checksum of
reduced olmo-1b's seed-0 weights (taken before the device draw was
added), and the device draw is held to its contract on the CPU (seeded,
shaped, chunked); ``test_torch_cuda.py`` holds it on a card.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jget_config  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro_torch.config import get_config, list_archs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init as init_lib  # noqa: E402
from repro_torch.models.init import materialize, spec  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402

from conftest import reduced_model  # noqa: E402


ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
RTOL = 1e-5
CACHE_LEN = 16
# sha256 of every leaf's bytes (keys sorted, lists in order) of reduced
# olmo-1b's ``init(seed=0, device="cpu")``, on PyTorch 2.13's CPU
# generator, taken before the device draw existed.
OLMO_CPU_DRAW_SHA256 = (
    "a4a9edff9aac26aa78aedaeb087736b007f735050205720c3a84a72ce23867d0")
_MODELS = {}


def _models(arch):
    """(reference model, reference params, port model, port params)."""
    if arch not in _MODELS:
        jm, jp = reduced_model(arch)
        _MODELS[arch] = (jm, jp, build_model(get_config(arch).reduced()),
                         params_from_numpy(jax.device_get(jp), "cpu"))
    return _MODELS[arch]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(port.detach().numpy() - ref)) / max(
        np.max(np.abs(ref)), 1e-30)


def _leaves(caches):
    return [c[k] for c in caches for k in sorted(c)]


# ---------------------------------------------------------------------------
# Configs, parameter trees and the planning surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_tree_match_reference_at_full_width(arch):
    """The registered config, the parameter tree's shapes and dtypes, the
    parameter counts (total and active a token) and the decoupling points
    of the full-width model, on specs only."""
    assert arch in list_archs()
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jtree = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                         jm.abstract_params())
    ptree = jax.tree.map(lambda s: (tuple(s.shape), s.dtype), m.specs,
                         is_leaf=lambda x: hasattr(x, "logical"))
    assert ptree == jtree
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()
    assert m.active_param_count() < m.param_count()
    assert m.decoupling_points() == jm.decoupling_points()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_fmac_rows_equal_reference(arch, reduced):
    """Every block's FMACs a token, the ``e`` rows among them (attention,
    the k routed experts and the router), equal the reference's, and the
    boundary bytes; at the depths the card runs too."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    cut = dict(num_layers=4, block_pattern="eeee") if arch == \
        "grok-1-314b" else dict(num_layers=3, block_pattern="ded")
    for c, j in [(cfg, jcfg), (cfg.replace(**cut), jcfg.replace(**cut))]:
        m, jm = build_model(c), jbuild_model(j)
        for b, s in [(1, 1), (2, 16), (4, 32)]:
            assert m.per_point_fmacs(b, s) == jm.per_point_fmacs(b, s)
            assert m.boundary_bytes(b, s, 2) == jm.boundary_bytes(b, s, 2)
        e_rows = [f for f, k in zip(m.per_point_fmacs(1, 1),
                                    tf.default_pattern(c)) if k == "e"]
        d, hd = c.d_model, c.head_dim_
        attn = d * (c.num_heads + 2 * c.num_kv_heads) * hd \
            + c.num_heads * hd * d
        assert e_rows and set(e_rows) == {
            attn + 3.0 * d * c.moe_d_ff_ * c.experts_per_token
            + d * c.num_experts}


def test_cut_depth_trees_and_points():
    """The card's cut depths: grok ``eeee`` is one segment of four ``e``
    blocks; llama4 ``ded`` three one-layer segments. Their parameter
    counts (the bf16 bytes the card holds) and point names."""
    grok = build_model(get_config("grok-1-314b").replace(
        num_layers=4, block_pattern="eeee"))
    llama = build_model(get_config("llama4-maverick-400b-a17b").replace(
        num_layers=3, block_pattern="ded"))
    assert grok.decoupling_points() == ["seg0_e0", "seg0_e1", "seg0_e2",
                                        "seg0_e3"]
    assert llama.decoupling_points() == ["seg0_d0", "seg1_e0", "seg2_d0"]
    assert [s.kind for s in tf.segment_plan(llama.cfg)] == ["d", "e", "d"]
    assert grok.param_count() == 21_290_539_008
    jl = jbuild_model(jget_config("llama4-maverick-400b-a17b").replace(
        num_layers=3, block_pattern="ded"))
    assert llama.param_count() == jl.param_count()
    assert 18.5e9 < llama.param_count() < 18.7e9


# ---------------------------------------------------------------------------
# Prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [7, 32])
def test_prefill_and_teacher_forced_decode(arch, seq):
    """Prefill logits and every cache leaf, then two teacher-forced decode
    steps (one token a row: a group of 1, 8 slots an expert)."""
    jm, jp, m, p = _models(arch)
    toks = _tokens(m.cfg, 2, seq)
    L = seq + 4
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, L)
    with torch.no_grad():
        tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks)}, L)
        assert _rel(tl, jl) < RTOL
        for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
            assert tuple(t.shape) == j.shape and _rel(t, j) < RTOL
        nxt = _tokens(m.cfg, 2, 2, seed=1)
        for i in range(2):
            step = nxt[:, i:i + 1]
            jl, jc = jm.decode_step(jp, jnp.asarray(step),
                                    jnp.int32(seq + i), jc)
            tl, tc = m.decode_step(p, torch.from_numpy(step), seq + i, tc)
            assert _rel(tl, jl) < RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_one_shot_head_tail_equals_reference(arch):
    jm, jp, m, p = _models(arch)
    toks = _tokens(m.cfg, 2, 5, seed=3)
    for point in range(len(m.decoupling_points())):
        jb, extras = jm.run_head(jp, {"tokens": jnp.asarray(toks)}, point)
        with torch.no_grad():
            tb = m.run_head(p, {"tokens": torch.from_numpy(toks)}, point)
            assert _rel(tb, jb) < RTOL
            tl = m.run_tail(p, torch.from_numpy(np.array(jb)), point)
        assert _rel(tl, jm.run_tail(jp, jb, point, extras)) < RTOL


def test_prefill_drops_choices_as_counted():
    """A 512-token prompt (two groups of 256) on a zero router: every
    logit ties, so every token chooses experts 0 and 1 (256 choices each a
    group against 160 slots); the recorded routing counts the drops, and
    a plain recount of the same ids (each expert's first ``capacity``
    choices of a group, token-major) gives the same kept mask."""
    _, _, m, p = _models("grok-1-314b")
    mlp = dict(p["segments"][0]["mlp"])
    mlp["router"] = torch.zeros_like(mlp["router"])
    p = {**p, "segments": [dict(p["segments"][0], mlp=mlp)]}
    toks = torch.from_numpy(_tokens(m.cfg, 1, 512, seed=6))
    with torch.no_grad(), moe.record_routing() as seen:
        logits = m.forward(p, {"tokens": toks})
    assert torch.isfinite(logits).all() and len(seen) == 2
    total = 0
    for r in seen:
        ids = r.ids.numpy().reshape(2, 256 * m.cfg.experts_per_token)
        want = np.zeros_like(ids, bool)
        for gi in range(2):
            used = np.zeros(m.cfg.num_experts, int)
            for j, e in enumerate(ids[gi]):
                want[gi, j] = used[e] < r.capacity
                used[e] += 1
        np.testing.assert_array_equal(r.kept.numpy().reshape(want.shape),
                                      want)
        total += moe.dropped_choices(r)
    assert total == 2 * 2 * 2 * (256 - 160)     # layers x groups x experts


# ---------------------------------------------------------------------------
# The token split, inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,pattern", [("grok-1-314b", "eee"),
                                          ("llama4-maverick-400b-a17b",
                                           "ded")])
def test_split_forward_bitwise_equals_unsplit(arch, pattern):
    """prefill_head -> prefill_tail and decode_head -> decode_tail give the
    unsplit logits and caches bit for bit at every point; run_segment
    chains run_head to run_tail exactly. ``ded``'s points sit in three
    one-layer segments (``seg0_d0``, ``seg1_e0``, ``seg2_d0``)."""
    m = build_model(get_config(arch).reduced().replace(
        num_layers=len(pattern), block_pattern=pattern))
    p = m.init(3, "cpu")
    L = 12
    toks = torch.from_numpy(_tokens(m.cfg, 2, 6, seed=4))
    with torch.no_grad():
        ref_logits, ref_caches = m.prefill(p, {"tokens": toks}, L)
        nxt = ref_logits[:, -1].argmax(-1)[:, None]
        ref_step, ref_after = m.decode_step(
            p, nxt, 6, [{k: v.clone() for k, v in c.items()}
                        for c in ref_caches])
        full = m.forward(p, {"tokens": toks})
        plan = tf.segment_plan(m.cfg)
        for point in range(len(m.decoupling_points())):
            boundary, head = m.prefill_head(p, {"tokens": toks}, L, point)
            logits, tail = m.prefill_tail(p, boundary, L, point)
            assert torch.equal(logits, ref_logits)
            b, head = m.decode_head(p, nxt, 6, head, point, L)
            step, tail = m.decode_tail(p, b, 6, tail, point, L)
            assert torch.equal(step, ref_step)
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
                for g, w in zip(_leaves(got), _leaves(want)):
                    assert torch.equal(g, w)
            mid = m.run_segment(p, m.run_head(p, {"tokens": toks}, 0), 0,
                                point)
            assert torch.equal(m.run_tail(p, mid, point), full)
    if pattern == "ded":
        assert m.decoupling_points() == ["seg0_d0", "seg1_e0", "seg2_d0"]


# ---------------------------------------------------------------------------
# models/init.py: the CPU draw pinned, the device draw's contract
# ---------------------------------------------------------------------------


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


def test_cpu_draw_is_unchanged():
    """Reduced olmo-1b's seed-0 weights, drawn on the CPU (the default),
    are the same bits as before the device draw was added."""
    m = build_model(get_config("olmo-1b").reduced())
    assert _digest(m.init(seed=0, device="cpu")) == OLMO_CPU_DRAW_SHA256
    assert _digest(m.init(seed=0, device="cpu", draw="cpu")) == \
        OLMO_CPU_DRAW_SHA256


def test_device_draw_contract_on_the_cpu(monkeypatch):
    """draw="device" (here the CPU is the device), in chunks smaller than a
    leaf: the specs' shapes and dtypes, the same bits for a seed and other
    bits for another, constant leaves exact, and the initializer's scale
    (fan-in rule, truncation at 2 sigma; the embedding's own scale)."""
    specs = {"w": spec((3, 40, 50), ("a", "b", "c"), "bfloat16"),
             "e": spec((70, 8), ("v", "d"), "float32", init="embed",
                       scale=0.02),
             "z": spec((5,), ("d",), "bfloat16", init="zeros"),
             "o": spec((5,), ("d",), "float32", init="ones")}
    monkeypatch.setattr(init_lib, "DEVICE_CHUNK", 1000)
    a = materialize(specs, 7, "cpu", draw="device")
    b = materialize(specs, 7, "cpu", draw="device")
    c = materialize(specs, 8, "cpu", draw="device")
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape
        assert str(a[k].dtype) == f"torch.{s.dtype}"
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["w"], c["w"])
    assert (a["z"] == 0).all() and (a["o"] == 1).all()
    w = a["w"].float()
    std = 1.0 / np.sqrt(3 * 40)                 # the fan-in rule
    assert w.abs().max() <= 2 * std * 1.01      # truncated at 2 sigma
    assert 0.7 * std < float(w.std()) < 1.0 * std
    assert 0.015 < float(a["e"].std()) < 0.025
    with pytest.raises(ValueError, match="draw"):
        materialize(specs, 7, "cpu", draw="gpu")


def test_model_init_draws_on_the_device_when_asked():
    """Model.init(draw="device") fills the whole tree (an MoE model's too)
    with the spec's shapes and dtypes; the default draw is the CPU's."""
    m = build_model(get_config("llama4-maverick-400b-a17b").reduced())
    host = m.init(0, "cpu")
    dev = m.init(0, "cpu", draw="device")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), host) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), dev)
    assert _digest(host) == _digest(m.init(0, "cpu", draw="cpu"))
