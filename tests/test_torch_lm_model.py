"""Parity of the port's dense decoders with the reference's, on the CPU.

Reduced ``olmo-1b`` (non-parametric LN, tied embeddings, MHA) and reduced
``qwen3-8b`` (RMSNorm, qk-norm, GQA, an untied head) in float32, with the
reference's weights bridged into the port.

Tolerances: both packages compute the same float32 function, but sum the
matrix products and reductions in other orders, so logits and caches agree
within ``RTOL`` of their scale (measured ~6e-7 on these models). An int8
KV cache rounds the same keys to codes, and a key that lands within an ulp
of a rounding edge may take the neighbouring code: codes agree within 1,
dequantized rows within one step of their scale. Inside the port the
split forward must equal the unsplit one bit for bit at every point: it
runs the same blocks, in the same order, on the same tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jget_config  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

from conftest import reduced_model  # noqa: E402

ARCHS = ["olmo-1b", "qwen3-8b"]
RTOL = 1e-5
CACHE_LEN = 16


def _models(arch, **over):
    """(reference model, reference params, port model, port params)."""
    jmodel, jparams = reduced_model(arch)
    cfg = get_config(arch).reduced().replace(**over)
    jm = jbuild_model(jmodel.cfg.replace(**over)) if over else jmodel
    return (jm, jparams, build_model(cfg),
            params_from_numpy(jax.device_get(jparams), "cpu"))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(port.detach().numpy() - ref)) / np.max(np.abs(ref))


def _leaves(caches):
    return [c[k] for c in caches for k in sorted(c)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    jm, jparams, m, params = _models(arch)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    pshapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert jshapes == pshapes
    assert m.param_count() == jm.param_count()
    assert m.init(0, "cpu")["embed"].shape == params["embed"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(arch):
    jm, jparams, m, params = _models(arch)
    toks = _tokens(m.cfg, 2, 7)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks)}, CACHE_LEN)
    assert _rel(tl, jl) < RTOL
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape and _rel(t, j) < RTOL
    # Teacher-forced: both packages decode the same next tokens.
    nxt = _tokens(m.cfg, 2, 3, seed=1)
    for i in range(3):
        step = nxt[:, i:i + 1]
        jl, jc = jm.decode_step(jparams, jnp.asarray(step),
                                jnp.int32(7 + i), jc)
        tl, tc = m.decode_step(params, torch.from_numpy(step), 7 + i, tc)
        assert tl.shape == (2, 1, m.cfg.vocab_size)
        assert _rel(tl, jl) < RTOL
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        assert _rel(t, j) < RTOL


def test_int8_kv_cache_prefill_and_decode():
    jm, jparams, m, params = _models("qwen3-8b", kv_cache_bits=8)
    toks = _tokens(m.cfg, 2, 6, seed=2)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(toks)}, CACHE_LEN)
    assert tc[0]["k"].dtype == torch.int8 and tc[0]["ks"].dtype == \
        torch.float32
    assert _rel(tl, jl) < RTOL
    for key in ("k", "v"):
        codes = tc[0][key].numpy().astype(np.int32)
        jcodes = np.asarray(jc[0][key]).astype(np.int32)
        assert np.max(np.abs(codes - jcodes)) <= 1
        assert _rel(tc[0][key + "s"], jc[0][key + "s"]) < RTOL
    step = toks[:, -1:]
    jl, _ = jm.decode_step(jparams, jnp.asarray(step), jnp.int32(6), jc)
    tl, _ = m.decode_step(params, torch.from_numpy(step), 6, tc)
    assert _rel(tl, jl) < 1e-3           # one code step on a few keys


@pytest.mark.parametrize("arch", ARCHS)
def test_planning_surface_equals_reference(arch):
    jm, _, m, _ = _models(arch)
    assert m.decoupling_points() == jm.decoupling_points()
    for b, s in [(1, 1), (2, 16), (8, 64)]:
        assert m.boundary_bytes(b, s) == jm.boundary_bytes(b, s)
        assert m.boundary_bytes(b, s, 2) == jm.boundary_bytes(b, s, 2)
        assert m.per_point_fmacs(b, s) == jm.per_point_fmacs(b, s)
    full = get_config(arch)
    jfull = jbuild_model(jget_config(arch))
    assert repr(full) == repr(jfull.cfg)
    assert build_model(full).per_point_fmacs(4, 32) == \
        jfull.per_point_fmacs(4, 32)
    assert build_model(full).param_count() == jfull.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_shot_head_tail_equals_reference(arch):
    """run_head / run_tail of the one-shot split, and run_heads' taps."""
    jm, jparams, m, params = _models(arch)
    toks = _tokens(m.cfg, 2, 5, seed=3)
    n = len(m.decoupling_points())
    taps = m.run_heads(params, {"tokens": torch.from_numpy(toks)},
                       list(range(n)))
    for point in range(n):
        jb, extras = jm.run_head(jparams, {"tokens": jnp.asarray(toks)},
                                 point)
        tb = m.run_head(params, {"tokens": torch.from_numpy(toks)}, point)
        assert torch.equal(taps[point][0], tb)
        assert _rel(tb, jb) < RTOL
        jl = jm.run_tail(jparams, jb, point, extras)
        tl = m.run_tail(params, torch.from_numpy(np.array(jb)), point)
        assert _rel(tl, jl) < RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_split_forward_bitwise_equals_unsplit(arch):
    """prefill_head -> prefill_tail and decode_head -> decode_tail (no wire
    in between) reproduce the unsplit prefill / decode_step logits and
    caches bit for bit at every decoupling point, and run_segment chains
    run_head to run_tail exactly."""
    _, _, m, params = _models(arch)
    L = 24
    toks = torch.from_numpy(_tokens(m.cfg, 2, 6, seed=4))
    ref_logits, ref_caches = m.prefill(params, {"tokens": toks}, L)
    nxt = ref_logits[:, -1].argmax(-1)[:, None]
    ref_step, ref_after = m.decode_step(
        params, nxt, 6, [{k: v.clone() for k, v in c.items()}
                         for c in ref_caches])
    full = m.forward(params, {"tokens": toks})
    for point in range(len(m.decoupling_points())):
        boundary, head = m.prefill_head(params, {"tokens": toks}, L, point)
        logits, tail = m.prefill_tail(params, boundary, L, point)
        assert torch.equal(logits, ref_logits)
        b, head = m.decode_head(params, nxt, 6, head, point, L)
        step, tail = m.decode_tail(params, b, 6, tail, point, L)
        assert torch.equal(step, ref_step)
        lo = point + 1
        for key in ("k", "v"):
            assert torch.equal(head[0][key], ref_after[0][key][:lo])
            if tail:
                assert torch.equal(tail[0][key], ref_after[0][key][lo:])
        mid = m.run_segment(params, m.run_head(params, {"tokens": toks}, 0),
                            0, point)
        assert torch.equal(m.run_tail(params, mid, point), full)


def test_batched_rows_at_own_positions_equal_batch_one():
    """One batched decode whose rows sit at different positions gives each
    row the logits of decoding it alone at the same row count."""
    _, _, m, params = _models("qwen3-8b")
    rows = 4
    prompts = [_tokens(m.cfg, 1, n, seed=10 + n) for n in (3, 6, 4, 5)]
    caches = m.init_caches(rows, CACHE_LEN, "cpu")
    last = torch.zeros((rows, 1), dtype=torch.int64)
    pos = torch.zeros(rows, dtype=torch.int64)
    solo = []
    for r, p in enumerate(prompts):
        lg, one = m.prefill(params, {"tokens": torch.from_numpy(p)},
                            CACHE_LEN)
        for buf, new in zip(caches, one):
            for k in buf:
                buf[k][:, r] = new[k][:, 0]
        last[r, 0] = lg[0, -1].argmax()
        pos[r] = p.shape[1]
        alone = m.init_caches(rows, CACHE_LEN, "cpu")
        for buf, new in zip(alone, one):
            for k in buf:
                buf[k][:, 0] = new[k][:, 0]
        solo.append((alone, last[r].clone(), int(pos[r])))
    live = torch.tensor([True, True, False, True])
    logits, _ = m.decode_step(params, last, pos, caches, live)
    for r in (0, 1, 3):
        alone, tok, p = solo[r]
        t = torch.zeros((rows, 1), dtype=torch.int64)
        t[0] = tok
        lg, _ = m.decode_step(params, t, torch.full((rows,), p), alone)
        assert torch.equal(logits[r], lg[0])
    # The row that was not live kept its cache rows.
    fresh = m.init_caches(rows, CACHE_LEN, "cpu")
    lg, one = m.prefill(params, {"tokens": torch.from_numpy(prompts[2])},
                        CACHE_LEN)
    assert torch.equal(caches[0]["k"][:, 2], one[0]["k"][:, 0])
    assert not fresh[0]["k"].any()


def test_unported_families_raise():
    from repro_torch.config import ModelConfig
    from repro_torch.models import blocks

    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(ModelConfig(arch_id="x", family="moe", num_layers=2,
                                d_model=64, num_heads=4, num_kv_heads=4,
                                d_ff=128, vocab_size=64))
    for kind in "emlsAEc":
        with pytest.raises(NotImplementedError, match="queue 1"):
            blocks.block_spec(kind, get_config("olmo-1b").reduced())
