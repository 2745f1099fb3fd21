"""Parity of the port's three-launch encode chain (K6a range, K6b quantize,
K6c nibble pack) with the reference's ``quantize_pack_threelaunch``
(Pallas, interpret mode), with each of the reference's three launches, and
with the port's own fused encode K1.

On the CPU the wrappers run their plain PyTorch versions. Tolerance: none.
The chain's wire codes, trimmed to the wire length, must be the
reference's bytes, and ``(codes, mn, mx)`` must equal ``quantize_pack``
exactly, for odd and even sizes at every width; ranges are compared by
bits (``-0.0`` is not ``+0.0``). ``test_torch_cuda.py``
holds the CUDA kernels against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quantize import ops as jops  # noqa: E402
from repro.kernels.quantize import quantize as jk  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402

BITS = (2, 3, 4, 8, 12, 16)
SIZES = (1, 2, 129, 300, 4551)


def _features(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0            # feature-map-like sparsity
    return x


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_chain_matches_reference_and_fused_encode(n, bits):
    x = _features(n, seed=n + bits)
    jc, jmn, jmx = jops.quantize_pack_threelaunch(jnp.asarray(x), bits,
                                                  interpret=True)
    xt = torch.from_numpy(x)
    codes, mn, mx = qops.quantize_pack_threelaunch(xt, bits)
    wire = qref.wire_len(n, bits)
    assert codes.shape == (wire,) and codes.dtype == qref.code_dtype(bits)
    want = np.asarray(jc).reshape(-1)[:wire]
    assert codes.numpy().tobytes() == want.tobytes()
    assert np.float32(mn) == np.float32(jmn)
    assert np.float32(mx) == np.float32(jmx)
    fused = qops.quantize_pack(xt, bits)
    for got, ref in zip((codes, mn, mx), fused):
        assert torch.equal(got, ref)
    # bfloat16 input: the same chain as K1's on the same values.
    xh = xt.to(torch.bfloat16)
    for got, ref in zip(qops.quantize_pack_threelaunch(xh, bits),
                        qops.quantize_pack(xh, bits)):
        assert torch.equal(got, ref)


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _reference_launches(x, bits):
    """The reference's K6a and K6b launches on ``x`` (float32 or bfloat16
    numpy), each trimmed of its tile padding: ``(mn, mx, codes)``."""
    x2d, n = jops._to_tiles(jnp.asarray(x), 16, bits)
    jmn, jmx = jk.minmax_blocks(x2d, 16, interpret=True)
    jcodes = jk.quantize_blocks(x2d, jmn, jmx, bits, 16, interpret=True)
    return jmn, jmx, np.asarray(jcodes).reshape(-1)[:n], jcodes


@pytest.mark.parametrize("bits", (4, 8, 12))
def test_each_kernel_matches_its_reference_launch(bits):
    """K6a's range by bits, K6b's codes (on the same range) and K6c's
    bytes, each against the reference's own launch (trimmed of its tile
    padding)."""
    x = _features(3000, seed=bits)
    jmn, jmx, jcodes, jcodes2d = _reference_launches(x, bits)
    mn, mx = qops.minmax_blocks(torch.from_numpy(x))
    assert mn.shape == mx.shape == () and mn.dtype == torch.float32
    assert _bits(mn) == _bits(jmn) and _bits(mx) == _bits(jmx)
    codes = qops.quantize_blocks(torch.from_numpy(x), mn, mx, bits)
    assert codes.dtype == qref.code_dtype(bits)
    assert codes.numpy().tobytes() == jcodes.tobytes()
    if bits <= 4:
        jpacked = jk.pack4_blocks(jcodes2d, 16, interpret=True)
        packed = qops.pack4_blocks(codes)
        assert packed.numpy().tobytes() == \
            np.asarray(jpacked).reshape(-1)[:(3000 + 1) // 2].tobytes()


def test_partials_cover_contiguous_chunks():
    """K6a folds every element, whichever block holds it: on ``arange``
    the range is (0, n - 1), for more elements than one round of the
    card's blocks covers."""
    n = 5 * 1024 * 1056 + 7
    mn, mx = qops.minmax_blocks(torch.arange(n, dtype=torch.float32))
    assert float(mn) == 0 and float(mx) == n - 1
    assert _bits(mn) == 0                      # +0.0: no -0.0 in arange


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("first", ("-0 first", "+0 first"))
def test_fold_keeps_signed_zeros_across_blocks(dtype, first):
    """Zeros only: one sign in the first chunk of 1,024 elements, the other
    in a chunk far from it. The range is (-0.0, +0.0) by bits, as the
    reference's fold gives it, and the chain's codes are all 0 (mx > mn
    fails)."""
    neg, pos = np.float32(-0.0), np.float32(0.0)
    a, b = (neg, pos) if first == "-0 first" else (pos, neg)
    x = np.full(5 * 1024 + 3, a, np.float32)
    x[3 * 1024:4 * 1024] = b
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jmn, jmx, jcodes, _ = _reference_launches(jx, 8)
    mn, mx = qops.minmax_blocks(xt)
    assert _bits(mn) == _bits(jmn) == _bits(neg)
    assert _bits(mx) == _bits(jmx) == _bits(pos)
    for bits in (4, 8):
        codes, cmn, cmx = qops.quantize_pack_threelaunch(xt, bits)
        assert not codes.any()
        assert _bits(cmn) == _bits(neg) and _bits(cmx) == _bits(pos)
    assert qops.quantize_blocks(xt, mn, mx, 8).numpy().tobytes() == \
        jcodes.tobytes()


# A range whose scale 255 / (mx - mn) rounds to another float32 than 255 *
# f32(1 / (mx - mn)), and elements that this moves across a rounding edge.
DIV_MN, DIV_MX = -1089509231, 1083404242
DIV_EDGES = (-1091559343, -1092239325, -1092919308, -1093599290)


def test_quantize_scale_divides_as_the_reference():
    """K6b takes its scale by IEEE division, tensor by tensor: at ``mx ==
    mn`` every code is 0, and on a range where a reciprocal multiply would
    round the scale differently, the codes are still the reference's."""
    same = np.full(300, 1.5, np.float32)
    jmn, jmx, jcodes, _ = _reference_launches(same, 8)
    mn, mx = qops.minmax_blocks(torch.from_numpy(same))
    codes = qops.quantize_blocks(torch.from_numpy(same), mn, mx, 8)
    assert codes.numpy().tobytes() == jcodes.tobytes() == bytes(300)
    bounds = np.array([DIV_MN, DIV_MX], np.int32).view(np.float32)
    edges = np.array(DIV_EDGES, np.int32).view(np.float32)
    fill = np.random.default_rng(1).uniform(*bounds, 500).astype(np.float32)
    x = np.concatenate([bounds, edges, fill])
    f32 = np.float32
    div = f32(255) / (bounds[1] - bounds[0])
    recip = f32(255) * (f32(1) / (bounds[1] - bounds[0]))
    assert div != recip
    assert (np.round((edges - bounds[0]) * div)
            != np.round((edges - bounds[0]) * recip)).all()
    jmn, jmx, jcodes, _ = _reference_launches(x, 8)
    mn, mx = qops.minmax_blocks(torch.from_numpy(x))
    assert _bits(mn) == _bits(bounds[0]) and _bits(mx) == _bits(bounds[1])
    codes = qops.quantize_blocks(torch.from_numpy(x), mn, mx, 8)
    assert codes.numpy().tobytes() == jcodes.tobytes()
    jchain, _, _ = jops.quantize_pack_threelaunch(jnp.asarray(x), 8,
                                                  interpret=True)
    assert codes.numpy().tobytes() == \
        np.asarray(jchain).reshape(-1)[:x.size].tobytes()


def test_odd_count_pack_repeats_first_code_and_empty_input():
    codes = torch.tensor([9, 1, 2, 3, 4], dtype=torch.uint8)
    assert qops.pack4_blocks(codes).tolist() == [25, 50, 148]
    for bits in (4, 8):
        got = qops.quantize_pack_threelaunch(torch.zeros((0, 3)), bits)
        want = qops.quantize_pack(torch.zeros((0, 3)), bits)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        qops.quantize_pack_threelaunch(torch.ones(4), 17)


def test_counts_only_card_launches():
    with qops.count_launches() as box:
        qops.quantize_pack_threelaunch(torch.ones(10), 4)
    assert box.counts["minmax_blocks"] == box.counts["quantize_blocks"] == \
        box.counts["pack4_blocks"] == 0
