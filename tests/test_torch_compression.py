"""Parity of the port's compression shim (``core/compression.py``), the
paper's channel removal (``core/channel_removal.py``) and the entropy size
helpers (``core/entropy.py``) with the reference, and the reference's own
behavioural tests (``tests/test_compression_channel.py``) run against the
port.

Tolerances: none for bytes, sizes, ranges, decoded floats (bit for bit)
and the policy's state (logits, rewards, masks: bit for bit from the same
generator and the same ``evaluate``). The Shannon estimates are held
within ``ENTROPY_ULPS`` float32 ulps of the eager reference, whose division
``counts / n`` the port repeats tensor by tensor; and within as many ulps at
the scale of one bit a symbol (``n / 8`` bytes for the size) of the
*jitted* reference, where XLA multiplies by ``f32(1 / n)`` instead: ``p``
then moves by an ulp, and near ``p = 1``, where ``log2(p)`` is tiny,
``log2`` turns that ulp into an absolute error of ~1e-7 bits, which is
hundreds of ulps of a near-zero entropy. ``test_torch_cuda.py`` holds the
card runs against the CPU runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel_removal as jcr  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import entropy as jent  # noqa: E402
from repro_torch.core import channel_removal as tcr  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import entropy as tent  # noqa: E402

BITS = (2, 4, 8)
SHAPES = ((4, 6, 6), (8, 16), (3, 5, 7), (0,))
ENTROPY_ULPS = 16


def _features(shape, seed=0, cut=0.4):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[np.abs(x) < cut] = 0.0            # feature-map-like sparsity
    return x


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _both(shape, bits):
    x = _features(shape, seed=sum(shape) + bits)
    return (x, jcomp.compress(jnp.asarray(x), bits),
            tcomp.compress(torch.from_numpy(x), bits))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_compress_matches_reference(shape, bits):
    _, want, got = _both(shape, bits)
    assert got.payload == want.payload
    assert got.shape == want.shape == shape
    assert _bits(got.x_min) == _bits(want.x_min)
    assert _bits(got.x_max) == _bits(want.x_max)
    assert got.bits == want.bits == bits
    assert got.nbytes == want.nbytes == len(want.payload) + 9


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_decompress_matches_reference(shape, bits):
    _, want, got = _both(shape, bits)
    codes = tcomp.decompress_codes(got)
    np.testing.assert_array_equal(codes, jcomp.decompress_codes(want))
    assert codes.shape == shape
    for dtype in (np.float32, np.float64):
        back = tcomp.decompress(got, dtype)
        ref = jcomp.decompress(want, dtype)
        assert back.dtype == ref.dtype and back.shape == ref.shape
        assert back.tobytes() == ref.tobytes()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_transfer_size_matches_reference(shape, bits):
    x, want, got = _both(shape, bits)
    size = tcomp.transfer_size_bytes(torch.from_numpy(x), bits)
    assert size == jcomp.transfer_size_bytes(jnp.asarray(x), bits)
    assert abs(size - got.nbytes) <= 64


def _codes(seed):
    """Integer codes of several alphabets and shapes of distribution."""
    rng = np.random.default_rng(seed)
    nsym = int((2, 4, 16, 256, 4096, 65536)[seed % 6])
    n = int(rng.integers(1, 20_000))
    kind = seed % 3
    if kind == 0:
        codes = rng.integers(0, nsym, n)
    elif kind == 1:
        codes = rng.zipf(1.3, n) % nsym
    else:           # one dominant symbol: p near 1 (see the module note)
        codes = np.minimum(np.abs(rng.standard_normal(n) * nsym / 8),
                           nsym - 1).astype(np.int64)
    return codes, nsym


@pytest.mark.parametrize("seed", range(6))
def test_huffman_size_bytes_matches_reference(seed):
    codes, nsym = _codes(seed)
    size = tent.huffman_size_bytes(codes, nsym)
    assert size == jent.huffman_size_bytes(codes, nsym)
    assert size == len(tent.huffman_encode(codes, nsym))


def _ulps(a, b, scale=0.0):
    """|a - b| in float32 ulps of max(|b|, scale)."""
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) / float(
        np.spacing(np.float32(max(abs(float(b)), scale))))


_JIT_BITS = jax.jit(jent.entropy_bits_per_symbol, static_argnums=1)
_JIT_SIZE = jax.jit(jent.entropy_size_bytes, static_argnums=1)


@pytest.mark.parametrize("seed", range(12))
def test_entropy_estimates_match_reference(seed):
    codes, nsym = _codes(seed)
    ct = torch.from_numpy(codes)
    h = tent.entropy_bits_per_symbol(ct, nsym)
    size = tent.entropy_size_bytes(ct, nsym)
    assert h.dtype == size.dtype == torch.float32 and h.shape == ()
    jc = jnp.asarray(codes)
    assert _ulps(h, jent.entropy_bits_per_symbol(jc, nsym)) <= ENTROPY_ULPS
    assert _ulps(size, jent.entropy_size_bytes(jc, nsym)) <= ENTROPY_ULPS
    assert _ulps(h, _JIT_BITS(jc, nsym), 1.0) <= ENTROPY_ULPS
    assert _ulps(size, _JIT_SIZE(jc, nsym), codes.size / 8) <= ENTROPY_ULPS
    # Shannon bound <= Huffman <= Shannon + 1 bit a symbol (+ 1 rounding
    # byte), as the reference's entropy tests hold it.
    exact = tent.huffman_size_bytes(codes, nsym)
    assert float(size) <= exact + 1
    assert exact <= float(size) + codes.size / 8 + 1


def _noise_channels(mask):
    """Channels 0..3 matter, the rest are noise (the reference's test)."""
    return float(np.sum(1 - mask[:4]) * 0.05)


def _table_evaluate(num_channels):
    """A fixed drop for each removed channel, drawn once."""
    cost = np.random.default_rng(7).random(num_channels) * 0.02
    return lambda mask: float(cost[~mask].sum())


POLICY_CASES = {
    "noise 8": dict(num_channels=8, removal_budget=0.5, steps=300,
                    evaluate=_noise_channels),
    "stem 64": dict(num_channels=64, removal_budget=0.25, steps=200,
                    evaluate=_table_evaluate(64)),
    "seeded 16": dict(num_channels=16, removal_budget=0.25, steps=150,
                      evaluate=_table_evaluate(16), seed=5),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_reference(case):
    spec = dict(POLICY_CASES[case])
    steps, evaluate = spec.pop("steps"), spec.pop("evaluate")
    seed = spec.pop("seed", None)
    trained = []
    for mod in (jcr, tcr):
        kw = dict(spec)
        if seed is not None:
            kw["rng"] = np.random.default_rng(seed)
        trained.append(mod.train_channel_policy(
            mod.ChannelRemovalPolicy(**kw), evaluate, steps=steps))
    want, got = trained
    assert got.logits.tobytes() == want.logits.tobytes()
    assert got.keep_probs().tobytes() == want.keep_probs().tobytes()
    assert got.reward_history == want.reward_history
    assert got._baseline == want._baseline
    np.testing.assert_array_equal(got.deterministic_mask(),
                                  want.deterministic_mask())
    # Both generators are left in the same state.
    assert got.rng.random() == want.rng.random()


@pytest.mark.parametrize("axis", (1, -1))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_apply_channel_mask_matches_reference(axis, dtype):
    x = np.random.default_rng(11).standard_normal((2, 6, 5, 6)).astype(
        np.float32)
    x[0, 0, 0, :] = -0.0
    x[1, 1, 1, :] = 0.0
    mask = np.array([True, False, True, True, False, False])
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jcr.apply_channel_mask(jx, mask, axis=axis).astype(
        jnp.float32))
    got = tcr.apply_channel_mask(tx, mask, axis=axis)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # By bits: a removed negative element is -0.0 in both.
    assert got.float().numpy().view(np.int32).tobytes() == \
        want.view(np.int32).tobytes()
    assert (got.float().numpy().view(np.int32) == np.int32(-2**31)).any()


# The reference's behavioural tests, against the port.


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("bits", BITS)
def test_compress_roundtrip_bounded(seed, bits):
    x = _features((4, 6, 6), seed=1000 + seed)
    blob = tcomp.compress(torch.from_numpy(x), bits)
    back = tcomp.decompress(blob)
    step = (x.max() - x.min()) / ((1 << bits) - 1)
    assert np.abs(back - x).max() <= step / 2 + 1e-6
    assert blob.shape == x.shape


def test_transfer_size_matches_blob():
    x = _features((8, 16), seed=3, cut=0.5)
    blob = tcomp.compress(torch.from_numpy(x), 8)
    est = tcomp.transfer_size_bytes(torch.from_numpy(x), 8)
    assert abs(est - blob.nbytes) <= 64


def test_sparse_features_compress_10x_vs_float():
    """Paper Fig. 3: compression reduces feature maps to 1/10-1/100."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((32, 28, 28)), 0).astype(np.float32)
    x[x < 1.0] = 0.0          # post-ReLU-like, very sparse
    blob = tcomp.compress(torch.from_numpy(x), 4)
    assert blob.nbytes < x.nbytes / 10


def test_channel_mask_application():
    x = torch.ones((2, 3, 4))
    mask = np.array([1.0, 0.0, 1.0, 0.0])
    y = tcr.apply_channel_mask(x, mask, axis=-1)
    assert float(y[..., 1].sum()) == 0.0
    assert float(y[..., 0].sum()) == 6.0


def test_policy_learns_to_drop_useless_channels():
    """Bandit reward: channels 0..3 matter, 4..7 are noise. The trained
    policy must keep the useful ones with higher probability."""
    policy = tcr.ChannelRemovalPolicy(num_channels=8, removal_budget=0.5)
    trained = tcr.train_channel_policy(policy, _noise_channels, steps=300)
    probs = trained.keep_probs()
    assert probs[:4].mean() > probs[4:].mean() + 0.1


@pytest.mark.parametrize("budget", (0.25, 0.5))
def test_deterministic_mask_respects_budget(budget):
    policy = tcr.ChannelRemovalPolicy(num_channels=16, removal_budget=budget)
    policy.logits[:] = -6.0   # policy wants to drop everything
    mask = policy.deterministic_mask()
    # budget caps removals at its share regardless of the policy's appetite
    assert mask.sum() == 16 - int(budget * 16)
