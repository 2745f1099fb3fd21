"""Parity of the port's three-launch encode chain (K6a range partials, K6b
quantize, K6c nibble pack) with the reference's
``quantize_pack_threelaunch`` (Pallas, interpret mode) and with the port's
own fused encode K1.

On the CPU the wrappers run their plain PyTorch versions. Tolerance: none.
The chain's wire codes, trimmed to the wire length, must be the
reference's bytes, and ``(codes, mn, mx)`` must equal ``quantize_pack``
exactly, for odd and even sizes at every width. ``test_torch_cuda.py``
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
from repro_torch.core import quantization as tq  # noqa: E402
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


@pytest.mark.parametrize("bits", (4, 8, 12))
def test_each_kernel_matches_its_reference_launch(bits):
    """K6a's folded partials, K6b's codes and K6c's bytes, each against
    the reference's own launch (trimmed of its tile padding)."""
    x = _features(3000, seed=bits)
    x2d, n = jops._to_tiles(jnp.asarray(x), 16, bits)
    jmn, jmx = jk.minmax_blocks(x2d, 16, interpret=True)
    pmin, pmax = qops.minmax_blocks(torch.from_numpy(x))
    mn, mx = torch.amin(pmin), torch.amax(pmax)
    assert np.float32(mn) == np.float32(jmn)
    assert np.float32(mx) == np.float32(jmx)
    jcodes = jk.quantize_blocks(x2d, jmn, jmx, bits, 16, interpret=True)
    codes = qops.quantize_blocks(torch.from_numpy(x), mn,
                                 tq.affine_scale(mn, mx, bits), bits)
    assert codes.numpy().tobytes() == \
        np.asarray(jcodes).reshape(-1)[:n].tobytes()
    if bits <= 4:
        jpacked = jk.pack4_blocks(jcodes, 16, interpret=True)
        packed = qops.pack4_blocks(codes)
        assert packed.numpy().tobytes() == \
            np.asarray(jpacked).reshape(-1)[:(n + 1) // 2].tobytes()


def test_partials_cover_contiguous_chunks():
    n = 5 * 1024 * 1056 + 7               # more than one unit per block
    chunk = qref.minmax_chunk(n)
    parts = -(-n // chunk)
    assert chunk % qref.MINMAX_CHUNK_UNIT == 0
    assert parts <= qref.MINMAX_MAX_PARTS and (parts - 1) * chunk < n
    x = torch.arange(n, dtype=torch.float32)
    pmin, pmax = qops.minmax_blocks(x)
    assert pmin.shape == (parts,)
    assert torch.equal(pmin, torch.arange(parts, dtype=torch.float32)
                       * chunk)
    assert float(pmax[-1]) == n - 1 and float(pmax[0]) == chunk - 1
    assert qref.minmax_chunk(1) == qref.MINMAX_CHUNK_UNIT


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
