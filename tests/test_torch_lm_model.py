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
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

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
    """Every family of the reference builds now, vlm and audio included,
    with every block kind, and the meshed cloud serves: a fleet built with
    ``cloud_mesh`` (a one-rank host mesh) answers its requests, and
    ``aot_tail_report`` returns its report (``launch/step_analysis.py``).
    The fleet's token streams and the three-tier streaming terms are
    ported and no longer raise."""
    import types

    from repro_torch.config import JaladConfig, ModelConfig
    from repro_torch.core.tri_planner import TriPlanSpace
    from repro_torch.models import blocks
    from repro_torch.serving import fleet

    for arch in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        m = build_model(get_config(arch))
        assert m.is_lm and m.has_extras
        assert build_model(get_config(arch).reduced()).param_count() > 0
    m = build_model(ModelConfig(arch_id="x", family="vlm", num_layers=2,
                                d_model=64, num_heads=4, num_kv_heads=4,
                                d_ff=128, vocab_size=64))
    assert "vision_proj" in m.specs
    for kind in "Ec":
        assert blocks.block_spec(kind, get_config("olmo-1b").reduced())
    # The recurrent kinds, the shared attention block and the MoE block
    # are ported.
    for kind in "mlsA":
        assert blocks.block_spec(kind, get_config("zamba2-2.7b").reduced())
    spec = blocks.block_spec("e", get_config("grok-1-314b").reduced())
    assert set(spec["mlp"]) == {"router", "w_gate", "w_up", "w_down"}
    import torch.distributed as dist

    from repro_torch.config.types import EDGE_TK1, EDGE_TX2
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import meshed

    started = not dist.is_initialized()
    try:
        cfg = get_config("granite-34b").reduced()
        srv, _ = fleet.build_fleet_server(
            cfg, JaladConfig(bits_choices=(4, 8), codec_choices=("bitpack",),
                             accuracy_drop_budget=0.5),
            [EDGE_TX2, EDGE_TK1], calib_batches=1, calib_batch_size=2,
            seq_len=8, device="cpu", cloud_mesh=make_host_mesh(device="cpu"),
            cloud_collective_s=1e-4)
        done = srv.serve([fleet.FleetRequest(
            uid=u, device_id=u % 2, batch=make_batch(cfg, 1, 8, seed=u),
            bandwidth=3e5) for u in range(4)])
        assert srv.engine.cloud_mesh.collective_s_per_point == 1e-4
        assert srv.mesh_worker.fused_calls >= 1
        assert [tuple(r.logits.shape) for r in done] == \
            [(1, 8, cfg.vocab_size)] * 4
        assert all(bool(torch.isfinite(r.logits).all()) for r in done)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    # The ahead-of-time tail report is ported: the reference's five keys.
    rep = meshed.aot_tail_report(srv.engine.model, 0)
    assert list(rep) == ["n_devices", "flops_per_device",
                         "argument_bytes_per_device", "temp_bytes_per_device",
                         "output_bytes_per_device"]
    assert rep["n_devices"] == 1
    assert rep["flops_per_device"] > 0
    assert rep["argument_bytes_per_device"] > 0
    # The streaming hooks run: an empty fleet has no stream to step.
    idle = types.SimpleNamespace(stream_sessions=[], cloud_groups=[])
    assert fleet.FleetServer.step_streams(idle) == 0
    assert fleet.FleetServer.run_streams(idle) == 0
    with pytest.raises(ValueError, match="DecoupledPlan"):
        fleet.FleetServer.attach_stream(idle, object())
    with pytest.raises(ValueError, match="tokens_per_batch"):
        TriPlanSpace.with_streaming(None, 64, 0.0)
