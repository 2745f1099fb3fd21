"""Signed zeros in the range headers: the port against the reference.

XLA takes a minimum in the order in which ``-0.0 < +0.0`` and a maximum in
the same order, so ``jnp.min`` of a sample holding both zeros is ``-0.0``
and ``jnp.max`` is ``+0.0``, whichever comes first. The port's ranges must
equal the reference's bit for bit: every codec's blob ``x_min`` /
``x_max`` compared by bytes, and the plain versions of K1 (per-sample), K4
(per-channel) and K6a (the range of the whole input, and the chain's)
compared by bits with ``jnp.min`` / ``jnp.max``. Payloads and decodes do
not depend on the sign (``x - (-0.0)`` and ``x - (+0.0)`` give the same
codes), so only the headers could differ. ``test_torch_cuda.py`` holds the
CUDA kernels' ranges against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.codec import get_codec as jget  # noqa: E402
from repro_torch.codec import get_codec as tget  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402

# Both zeros at the minimum or at the maximum, in both orders.
PATTERNS = {
    "min +0 first": [0.0, -0.0, 1.0, 2.0],
    "min -0 first": [-0.0, 0.0, 1.0, 2.0],
    "max +0 first": [-1.0, -2.0, 0.0, -0.0],
    "max -0 first": [-1.0, -2.0, -0.0, 0.0],
}


def _tiled(pattern, n):
    return np.resize(np.array(PATTERNS[pattern], np.float32), n)


def _boundary(codec, pattern):
    """A boundary tensor in which every sample (bitpack, huffman) or
    every channel (perchannel, NCHW, channel axis 1) holds the pattern in
    its element order."""
    if codec == "perchannel":
        n, c, h, w = 2, 3, 4, 8
        rows = np.stack([_tiled(pattern, n * h * w)] * c)      # (C, L)
        return np.ascontiguousarray(
            rows.reshape(c, n, h, w).transpose(1, 0, 2, 3))
    return _tiled(pattern, 4 * 8 * 8).reshape(4, 8, 8)


def _bytes(v):
    return np.asarray(v, np.float32).tobytes()


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("codec", ("bitpack", "huffman", "perchannel"))
def test_blob_ranges_match_reference_by_bytes(codec, pattern, bits):
    x = _boundary(codec, pattern)
    jblob = jget(codec).encode(jnp.asarray(x), bits)
    tblob = tget(codec).encode(torch.from_numpy(x), bits)
    assert _bytes(tblob.x_min) == _bytes(jblob.x_min)
    assert _bytes(tblob.x_max) == _bytes(jblob.x_max)
    assert tblob.payload == jblob.payload
    # The batched edge encode (one K1 / K3 / K4 call for the stack).
    xs = [x, x[::-1].copy()]
    jblobs = jget(codec).encode_batch([jnp.asarray(a) for a in xs], bits)
    tblobs = tget(codec).encode_batch([torch.from_numpy(a) for a in xs],
                                      bits)
    for tb, jb in zip(tblobs, jblobs):
        assert _bytes(tb.x_min) == _bytes(jb.x_min)
        assert _bytes(tb.x_max) == _bytes(jb.x_max)


def _bits(t):
    return np.asarray(t, np.float32).view(np.int32)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_kernel_ranges_match_jnp_by_bits(pattern):
    rng = np.random.default_rng(len(pattern))
    # K1: three samples, each the pattern from another starting point.
    xb = np.stack([np.roll(_tiled(pattern, 301), s) for s in (0, 1, 2)])
    _, mn, mx = qref.fused_encode_ref(torch.from_numpy(xb), 8)
    np.testing.assert_array_equal(_bits(mn), _bits(jnp.min(xb, axis=1)))
    np.testing.assert_array_equal(_bits(mx), _bits(jnp.max(xb, axis=1)))
    # K4: two samples of (3, 4, 8), channel axis 0: every (sample,
    # channel) holds 32 elements of the pattern.
    x4 = _boundary("perchannel", pattern)
    _, mn, mx = qref.pc_encode_ref(torch.from_numpy(x4), 8, 0)
    np.testing.assert_array_equal(_bits(mn), _bits(jnp.min(x4, axis=(2, 3))))
    np.testing.assert_array_equal(_bits(mx), _bits(jnp.max(x4, axis=(2, 3))))
    # K6a: in chunks of 1,024 elements, chunk 1 holds no zero and chunks 0
    # and 2 hold one zero each, in the pattern's order, so the two zeros
    # lie far apart.
    unit = 1024
    flat = _tiled(pattern, 5 * unit + 37)
    flat[unit:2 * unit] = rng.uniform(3, 4, unit).astype(np.float32)
    zeros = [z for z in PATTERNS[pattern] if z == 0]
    for chunk, z in ((0, zeros[0]), (2, zeros[1])):
        part = flat[chunk * unit:(chunk + 1) * unit]
        part[part == 0] = z
    mn, mx = qref.minmax_blocks_ref(torch.from_numpy(flat))
    assert _bits(mn) == _bits(jnp.min(flat))
    assert _bits(mx) == _bits(jnp.max(flat))
    for bits in (4, 8):
        _, mn, mx = qops.quantize_pack_threelaunch(torch.from_numpy(flat),
                                                   bits)
        assert _bits(mn) == _bits(jnp.min(flat))
        assert _bits(mx) == _bits(jnp.max(flat))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_quantize_ranges_match_jnp_by_bits(pattern):
    x = _boundary("perchannel", pattern)
    q = tq.quantize(torch.from_numpy(x), 8)
    assert _bits(q.x_min) == _bits(jnp.min(x))
    assert _bits(q.x_max) == _bits(jnp.max(x))
    qc = tq.quantize(torch.from_numpy(x), 8, axis=1)
    np.testing.assert_array_equal(_bits(qc.x_min),
                                  _bits(jnp.min(x, axis=(0, 2, 3))))
    np.testing.assert_array_equal(_bits(qc.x_max),
                                  _bits(jnp.max(x, axis=(0, 2, 3))))


def test_ordered_reductions_keep_nonzero_ranges_and_nan():
    x = torch.tensor([[3.0, -0.0, 0.0], [0.0, 0.0, 0.0], [-0.0, -0.0, -0.0],
                      [1.0, float("nan"), 2.0]])
    mn, mx = tq.ordered_amin(x, 1), tq.ordered_amax(x, 1)
    assert _bits(mn[:3]).tolist() == _bits([-0.0, 0.0, -0.0]).tolist()
    assert _bits(mx[:3]).tolist() == _bits([3.0, 0.0, -0.0]).tolist()
    assert bool(torch.isnan(mn[3])) and bool(torch.isnan(mx[3]))
    # ordered_aminmax (one aminmax) gives the same bits, per row and whole.
    for dim, want in ((1, (mn, mx)), (None, (tq.ordered_amin(x[:3]),
                                            tq.ordered_amax(x[:3])))):
        got = tq.ordered_aminmax(x if dim else x[:3], dim)
        for g, w in zip(got, want):
            assert _bits(g).tolist() == _bits(w).tolist()
