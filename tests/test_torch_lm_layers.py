"""Parity of the port's decoder layers with the reference's, on the CPU.

The same numpy inputs (from a seed) go through each JAX function and its
counterpart in ``repro_torch.models.layers``.

Tolerances: the layers are float32 arithmetic in both packages, but
XLA and PyTorch evaluate ``(ms + eps) ** -0.5``, ``exp``, ``cos`` / ``sin``
and the matrix products in other orders or with other approximations, so
the outputs agree to a few ulps of their scale: ``ATOL`` on O(1) values.
Integer and copy paths are held exactly: the int8 KV codes and scales bit
for bit against the *compiled* reference (XLA turns its ``/ 127.0`` into a
multiplication by the float32 reciprocal under ``jit``), and cache writes
at per-row positions equal the reference's scalar-position writes row by
row.
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
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro.models.layers import rope as jrope  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.layers import attention as attn  # noqa: E402
from repro_torch.models.layers import mlp  # noqa: E402
from repro_torch.models.layers import norms  # noqa: E402
from repro_torch.models.layers import rope  # noqa: E402

ATOL = 2e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric"])
def test_norms(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64, scale=3.0) + 1.5
    params = {}
    if kind != "nonparametric":
        params["scale"] = _rand(rng, 64) + 1.0
    if kind == "layernorm":
        params["bias"] = _rand(rng, 64)
    ref = jnorms.apply_norm(kind, {k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(x))
    out = norms.apply_norm(kind, {k: torch.from_numpy(v) for k, v in
                                  params.items()}, torch.from_numpy(x))
    _close(out, ref)
    assert set(norms.norm_spec(kind, 64, "float32")) == set(
        jnorms.norm_spec(kind, 64, "float32"))


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    np.testing.assert_allclose(
        rope.rope_frequencies(64, theta).numpy(),
        np.asarray(jrope.rope_frequencies(64, theta)), rtol=1e-6)
    x = _rand(rng, 3, 4, 2, 64)
    # Each row at its own offset, as slots of one batched decode are.
    pos = (np.arange(4)[None] + np.array([[0], [17], [90]])).astype(np.int32)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(out, ref)


def test_mlps():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 3, 32)
    sw = {"w_gate": _rand(rng, 32, 48, scale=0.2),
          "w_up": _rand(rng, 32, 48, scale=0.2),
          "w_down": _rand(rng, 48, 32, scale=0.2)}
    ge = {"w_in": _rand(rng, 32, 48, scale=0.2), "b_in": _rand(rng, 48),
          "w_out": _rand(rng, 48, 32, scale=0.2), "b_out": _rand(rng, 32)}

    def both(tree):
        return ({k: jnp.asarray(v) for k, v in tree.items()},
                {k: torch.from_numpy(v) for k, v in tree.items()})

    jsw, tsw = both(sw)
    _close(mlp.apply_swiglu(tsw, torch.from_numpy(x)),
           jmlp.apply_swiglu(jsw, jnp.asarray(x)))
    jge, tge = both(ge)
    _close(mlp.apply_gelu_mlp(tge, torch.from_numpy(x)),
           jmlp.apply_gelu_mlp(jge, jnp.asarray(x)))


def _qkv(rng, b, s, h, kv, hd, sk=None):
    sk = s if sk is None else sk
    return (_rand(rng, b, s, h, hd), _rand(rng, b, sk, kv, hd),
            _rand(rng, b, sk, kv, hd))


@pytest.mark.parametrize("causal,window,kv", [(True, 0, 2), (True, 5, 1),
                                              (False, 0, 4)])
def test_full_and_chunked_attention(causal, window, kv):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 16, 4, kv, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = jattn.full_attention(jq, jk, jv, causal=causal, window=window)
    _close(attn.full_attention(tq, tk, tv, causal=causal, window=window), ref)
    # Several query and key chunks: the online softmax across blocks.
    cref = jattn.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                   q_chunk=4, kv_chunk=8)
    _close(attn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                  q_chunk=4, kv_chunk=8), cref)
    # prefill_attention with the dense threshold lowered, so it chunks.
    pref = jattn.prefill_attention(jq, jk, jv, causal=causal, window=window,
                                   dense_threshold=8)
    _close(attn.prefill_attention(tq, tk, tv, causal=causal, window=window,
                                  dense_threshold=8), pref)


def test_project_qkv_with_qk_norm():
    """qwen3's per-head q/k RMSNorm before RoPE, GQA heads."""
    jcfg = jget_config("qwen3-8b").reduced()
    cfg = get_config("qwen3-8b").reduced()
    rng = np.random.default_rng(4)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = {"wq": _rand(rng, d, h, hd, scale=0.05),
         "wk": _rand(rng, d, kv, hd, scale=0.05),
         "wv": _rand(rng, d, kv, hd, scale=0.05),
         "wo": _rand(rng, h, hd, d, scale=0.05),
         "q_norm": _rand(rng, hd) + 1.0, "k_norm": _rand(rng, hd) + 1.0}
    x = _rand(rng, 2, 6, d)
    pos = np.broadcast_to(np.arange(6)[None], (2, 6)).astype(np.int32)
    ref = jattn.project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jnp.asarray(pos), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out = attn.project_qkv(tp, torch.from_numpy(x), torch.from_numpy(pos),
                           cfg)
    for o, r in zip(out, ref):
        _close(o, r, atol=1e-4)
    o = _rand(rng, 2, 6, h, hd)
    _close(attn.attn_output(tp, torch.from_numpy(o)),
           jattn.attn_output({"wo": jnp.asarray(p["wo"])}, jnp.asarray(o)),
           atol=1e-4)


def test_decode_attention_per_row_lengths():
    """One batched call with a valid length a row equals the reference's
    scalar-length call on each row."""
    rng = np.random.default_rng(5)
    q = _rand(rng, 3, 1, 4, 32)
    kc, vc = _rand(rng, 3, 12, 2, 32), _rand(rng, 3, 12, 2, 32)
    lengths = np.array([1, 7, 12], np.int32)
    out = attn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(lengths))
    for b in range(3):
        ref = jattn.decode_attention(jnp.asarray(q[b:b + 1]),
                                     jnp.asarray(kc[b:b + 1]),
                                     jnp.asarray(vc[b:b + 1]),
                                     jnp.int32(lengths[b]))
        _close(out[b:b + 1], ref)


@pytest.mark.parametrize("scale", [1.0, 40.0, 1e-9])
def test_int8_kv_codes_bit_exact_to_compiled_reference(scale):
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 16, 4, 64, scale=scale)
    x[0, 0, 0] = 0.0                        # an all-zero row: the 1e-8 floor
    jq, js = jax.jit(jattn.quantize_kv_row)(jnp.asarray(x))
    tq, ts = attn.quantize_kv_row(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    back = attn.dequantize_kv(tq, ts, torch.float32)
    jback = jax.jit(jattn.dequantize_kv, static_argnums=2)(jq, js,
                                                           jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_cache_writes_at_per_row_positions():
    """Per-row positions (a ring of 6: position 7 lands in slot 1) equal the
    reference's scalar-position write on each row; a row whose ``live``
    flag is off keeps its cache row."""
    rng = np.random.default_rng(7)
    kc, vc = _rand(rng, 3, 6, 2, 8), _rand(rng, 3, 6, 2, 8)
    sc = _rand(rng, 3, 6, 2)
    kn, vn, sn = _rand(rng, 3, 1, 2, 8), _rand(rng, 3, 1, 2, 8), \
        _rand(rng, 3, 1, 2)
    pos = np.array([0, 4, 7])
    live = np.array([True, False, True])
    tk, tv = attn.cache_update(torch.from_numpy(kc.copy()),
                               torch.from_numpy(vc.copy()),
                               torch.from_numpy(kn), torch.from_numpy(vn),
                               torch.from_numpy(pos), torch.from_numpy(live))
    ts = attn.scale_update(torch.from_numpy(sc.copy()), torch.from_numpy(sn),
                           torch.from_numpy(pos), torch.from_numpy(live))
    for b in range(3):
        if live[b]:
            jk, jv = jattn.cache_update(kc[b:b + 1], vc[b:b + 1],
                                        kn[b:b + 1], vn[b:b + 1],
                                        jnp.int32(pos[b]))
            js = jattn.scale_update(sc[b:b + 1], sn[b:b + 1],
                                    jnp.int32(pos[b]))
        else:
            jk, jv, js = kc[b:b + 1], vc[b:b + 1], sc[b:b + 1]
        np.testing.assert_array_equal(tk[b:b + 1].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv[b:b + 1].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts[b:b + 1].numpy(), np.asarray(js))


def _kv8_step(cache, q, k_new, v_new, pos, live):
    """The tail's int8 KV decode step as the block composed it before the
    wrapper: quantize the step's rows, write codes and scales, dequantize
    the whole cache, attend over each row's first pos + 1 slots."""
    qk, ks_new = attn.quantize_kv_row(k_new)
    qv, vs_new = attn.quantize_kv_row(v_new)
    k_c, v_c = attn.cache_update(cache["k"], cache["v"], qk, qv, pos, live)
    ks_c = attn.scale_update(cache["ks"], ks_new, pos, live)
    vs_c = attn.scale_update(cache["vs"], vs_new, pos, live)
    return attn.decode_attention(q, attn.dequantize_kv(k_c, ks_c, q.dtype),
                                 attn.dequantize_kv(v_c, vs_c, q.dtype),
                                 pos + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv,group,hd", [(3, 1, 128), (2, 4, 64),
                                         (1, 48, 80)])
def test_kv8_decode_cpu_route_is_the_composition(kv, group, hd, dtype):
    """``kernels.attention.ops.kv8_decode`` on CPU tensors: codes, scales,
    the whole cache and the output bit for bit the composition's, over a
    ring of 12 slots (position 17 wraps to slot 5), rows at positions 0,
    5, 11 and 17, the second row's ``live`` flag off. In float32, each
    row against the reference's scalar-position step: codes and scales bit
    for bit against the compiled reference, the cache rows equal, the
    output within ATOL."""
    from repro_torch.kernels.attention import ops as aops

    rng = np.random.default_rng(8)
    b, s_c, h = 4, 12, kv * group
    dt = getattr(torch, dtype)
    cache = {"k": rng.integers(-127, 128, (b, s_c, kv, hd)).astype(np.int8),
             "v": rng.integers(-127, 128, (b, s_c, kv, hd)).astype(np.int8),
             "ks": _rand(rng, b, s_c, kv, scale=0.01) ** 2 + 1e-3,
             "vs": _rand(rng, b, s_c, kv, scale=0.01) ** 2 + 1e-3}
    q, k_new, v_new = (_rand(rng, b, 1, h, hd), _rand(rng, b, 1, kv, hd, scale=3.0),
                       _rand(rng, b, 1, kv, hd))
    pos = np.array([0, 5, 11, 17])
    live = np.array([True, False, True, True])

    def run(fn):
        c = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        out = fn(c, *(torch.from_numpy(t).to(dt) for t in (q, k_new, v_new)),
                 torch.from_numpy(pos), torch.from_numpy(live))
        return out, c

    out, got = run(lambda c, *a: aops.kv8_decode(a[0], a[1], a[2], c, *a[3:]))
    want_out, want = run(lambda c, *a: _kv8_step(c, *a))
    assert out.dtype == dt
    assert torch.equal(out.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32),
                       want_out.view(torch.int16 if dtype == "bfloat16"
                                     else torch.int32))
    for key in cache:
        assert torch.equal(got[key], want[key]), key
    if dtype != "float32":
        return
    jquant = jax.jit(jattn.quantize_kv_row)
    for r in range(b):
        jk, jv = cache["k"][r:r + 1], cache["v"][r:r + 1]
        jks, jvs = cache["ks"][r:r + 1], cache["vs"][r:r + 1]
        if live[r]:
            qk, sk = jquant(jnp.asarray(k_new[r:r + 1]))
            qv, sv = jquant(jnp.asarray(v_new[r:r + 1]))
            jk, jv = jattn.cache_update(jk, jv, qk, qv, jnp.int32(pos[r]))
            jks = jattn.scale_update(jks, sk, jnp.int32(pos[r]))
            jvs = jattn.scale_update(jvs, sv, jnp.int32(pos[r]))
        for key, ref in (("k", jk), ("v", jv)):
            np.testing.assert_array_equal(got[key][r:r + 1].numpy(),
                                          np.asarray(ref))
        for key, ref in (("ks", jks), ("vs", jvs)):
            np.testing.assert_array_equal(
                got[key][r:r + 1].numpy().view(np.int32),
                np.asarray(ref).view(np.int32))
        ref = jattn.decode_attention(
            jnp.asarray(q[r:r + 1]), jattn.dequantize_kv(jk, jks, jnp.float32),
            jattn.dequantize_kv(jv, jvs, jnp.float32), jnp.int32(pos[r] + 1))
        _close(out[r:r + 1], ref)
