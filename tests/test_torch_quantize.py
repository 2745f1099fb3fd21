"""Parity of the port's quantize kernels K1 (encode) and K2 (decode) with
the reference Pallas kernels (run in interpret mode on the CPU).

On the CPU the port's wrappers run their plain PyTorch versions; they must
give the reference's wire bytes exactly (including the odd-count padding
nibble, which repeats element 0) and its jitted decode bit for bit (one
rounding of ``codes * step + mn``). ``test_torch_cuda.py`` holds the
CUDA kernels against the plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.codec import bitpack as jbitpack  # noqa: E402
from repro.kernels.quantize import ops as jops  # noqa: E402
from repro.kernels.quantize import quantize as jk  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402

BITS = (2, 3, 4, 5, 6, 8, 12, 16)
SHAPES = [(3, 5, 7), (1,), (2,), (129,), (4, 33, 16)]


def _features(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0            # feature-map-like sparsity
    return x


def _wire(codes: torch.Tensor, bits: int) -> bytes:
    a = codes.numpy()
    return a.tobytes() if bits <= 8 else a.astype("<u2").tobytes()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_bytes_match_reference(shape, bits):
    x = _features(shape, seed=len(shape) + bits)
    n = x.size
    jc, jmn, jmx = jops.quantize_pack(jnp.asarray(x), bits, interpret=True)
    want = jbitpack._frame(np.asarray(jc).reshape(-1), n, bits)
    codes, mn, mx = qops.quantize_pack(torch.from_numpy(x), bits)
    assert _wire(codes, bits) == want
    assert np.float32(mn) == np.float32(jmn)
    assert np.float32(mx) == np.float32(jmx)


def test_odd_count_pads_last_nibble_with_first_code():
    x = np.array([5, 0, 1, 2, 3], np.float32)
    codes, _, _ = qops.quantize_pack(torch.from_numpy(x), 4)
    assert codes.tolist() == [15, 99, 249]        # 249 = 9 | 15 << 4


def test_empty_encode_and_decode():
    x = torch.zeros((0, 4))
    codes, mn, mx = qops.quantize_pack(x, 8)
    jc, jmn, jmx = jops.quantize_pack(jnp.zeros((0, 4)), 8, interpret=True)
    assert codes.numel() == 0
    assert float(mn) == float(jmn) == 0.0 and float(mx) == float(jmx) == 0.0
    out = qops.dequantize_wire(codes, mn, mx, 8, (0, 4))
    assert tuple(out.shape) == (0, 4)


@pytest.mark.parametrize("bits", (2, 4, 8, 16))
def test_batch_encode_matches_reference_and_single(bits):
    xb = np.stack([_features((6, 11), seed=s) for s in range(3)])
    jc, jmn, jmx = jops.quantize_pack_batch(jnp.asarray(xb), bits,
                                            interpret=True)
    codes, mn, mx = qops.quantize_pack_batch(torch.from_numpy(xb), bits)
    jflat = np.asarray(jc).reshape(3, -1)
    for b in range(3):
        assert _wire(codes[b], bits) == jbitpack._frame(jflat[b], 66, bits)
        one, _, _ = qops.quantize_pack(torch.from_numpy(xb[b]), bits)
        assert torch.equal(codes[b], one)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))


def test_blocked_stack_past_whole_tile_rows():
    """A stack past WHOLE_TILE_ROWS makes the reference take its blocked
    (per-sample SMEM carry) encode; the bytes must not change."""
    n = 300_001
    xb = np.stack([_features((n,), seed=s) for s in range(2)])
    rows = jops._tile_rows(n, jk.DEFAULT_BLOCK_M, 8)
    assert 2 * rows > jk.WHOLE_TILE_ROWS
    jc, jmn, _ = jops.quantize_pack_batch(jnp.asarray(xb), 8, interpret=True)
    codes, mn, _ = qops.quantize_pack_batch(torch.from_numpy(xb), 8)
    jflat = np.asarray(jc).reshape(2, -1)
    for b in range(2):
        assert _wire(codes[b], 8) == jbitpack._frame(jflat[b], n, 8)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jmn))


def test_bf16_input_encodes_like_reference():
    x = _features((5, 40), seed=4)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for bits in (4, 8, 12):
        jc, _, _ = jops.quantize_pack(xj, bits, interpret=True)
        codes, _, _ = qops.quantize_pack(xt, bits)
        assert _wire(codes, bits) == jbitpack._frame(
            np.asarray(jc).reshape(-1), x.size, bits)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("out", ("float32", "bfloat16"))
def test_wire_decode_bit_exact(bits, out):
    x = _features((7, 9, 5), seed=bits)
    shape = x.shape
    jdt = jnp.float32 if out == "float32" else jnp.bfloat16
    tdt = torch.float32 if out == "float32" else torch.bfloat16
    codes, mn, mx = qops.quantize_pack(torch.from_numpy(x), bits)
    wire = codes.numpy()
    want = jops.dequantize_wire(jnp.asarray(wire), np.float32(mn),
                                np.float32(mx), bits, shape,
                                interpret=True, out_dtype=jdt)
    got = qops.dequantize_wire(codes, mn, mx, bits, shape, tdt)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("bits", BITS)
def test_codes_decode_bit_exact_batched(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, size=(3, 77))
    mn = rng.standard_normal(3).astype(np.float32)
    mx = mn + np.abs(rng.standard_normal(3)).astype(np.float32) * 5
    want = jops.dequantize_codes_batch(jnp.asarray(codes), mn, mx, bits,
                                       (7, 11), interpret=True)
    got = qops.dequantize_codes_batch(torch.from_numpy(codes), mn, mx, bits,
                                      (7, 11))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = jops.dequantize_codes(jnp.asarray(codes[1]), mn[1], mx[1], bits,
                                (7, 11), interpret=True)
    got1 = qops.dequantize_codes(torch.from_numpy(codes[1]), mn[1], mx[1],
                                 bits, (7, 11))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(one))


def test_single_rounding_dequant_differs_from_eager_double_rounding():
    """The decode rounds once; an eager ``q * step + mn`` (two roundings)
    differs on a sizable share of codes."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 256, 20_000).astype(np.float32))
    mn = torch.tensor(-1.2345678, dtype=torch.float32)
    step = torch.tensor(0.0123456789, dtype=torch.float32)
    fused = tq.fma_f32(q, step, mn)
    exact = (q.double() * step.double() + mn.double()).float()
    np.testing.assert_array_equal(fused.numpy(), exact.numpy())
    assert (fused != q * step + mn).any()


def test_quantize_dequantize_matches_jitted_reference():
    import jax

    from repro.core import quantization as jq

    x = _features((4, 8, 6, 6), seed=9)
    for bits in (2, 5, 8, 16):
        want = jax.jit(jq.quantize_dequantize, static_argnums=1)(
            jnp.asarray(x), bits)
        got = tq.quantize_dequantize(torch.from_numpy(x), bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jv = jq.quantize(jnp.asarray(x), bits).values
        np.testing.assert_array_equal(
            tq.quantize(torch.from_numpy(x), bits).values.numpy(),
            np.asarray(jv))


def test_launch_counters_do_not_move_on_the_cpu():
    with qops.count_launches() as box:
        qops.quantize_pack(torch.randn(10), 8)
    assert box.counts["fused_encode"] == 0
