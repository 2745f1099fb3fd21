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
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

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


@pytest.mark.parametrize("bits", range(1, 17))
def test_dequant_recip_matches_jitted_step(bits):
    """The decode kernels get the step as ``(mx - mn) * dequant_recip``:
    bit-identical to the reference's jitted ``(mx - mn) / levels`` on
    wide, empty and negative ranges."""
    import jax

    rng = np.random.default_rng(100 + bits)
    mn = (rng.standard_normal(256) * 10).astype(np.float32)
    mx = (mn + np.abs(rng.standard_normal(256)) * 7).astype(np.float32)
    mx[:16] = mn[:16]
    mn[16:64] = -np.abs(mn[16:64]) - 1
    mx[16:64] = mn[16:64] + np.abs(mn[16:64]) * rng.uniform(0, 1, 48)
    levels = float((1 << bits) - 1)
    want = np.asarray(jax.jit(lambda a, b: jnp.where(
        levels > 0, (b - a) / levels, 0.0).astype(jnp.float32))(mn, mx))
    tmn, tmx = torch.from_numpy(mn), torch.from_numpy(mx)
    got = (tmx - tmn) * tq.dequant_recip(bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(
        tq.dequant_step(tmn, tmx, bits).numpy().view(np.int32),
        want.view(np.int32))


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


# K1's launch plan (a pure function of the shape; the card's resident block
# count is an argument, 132 being one block a stage on each H100 SM).
PLAN_SHAPES = [(1, 1, False), (1, 63, False), (1, 4000, False),
               (3, 4551, True), (1, 401_408, False), (1, 802_816, False),
               (4, 802_816, False), (4, 802_816, True),
               (1, 3_211_264, False), (4, 4_194_304, False),
               (200, 100_000, False)]


@pytest.mark.parametrize("case", PLAN_SHAPES, ids=str)
def test_fused_encode_plan_shares_and_stage(case):
    bsz, n, bf16 = case
    esize = 2 if bf16 else 4
    plan = qops.fused_encode_plan(bsz, n, bf16, 132)
    variants = [(plan.variant, plan.blocks)]
    for forced in qops.FE_VARIANTS:
        try:
            p = qops.fused_encode_plan(bsz, n, bf16, 132, forced)
        except ValueError:
            continue
        variants.append((p.variant, p.blocks))
        assert p.smem_bytes == p.stage_elems * esize
        assert p.stage_elems % 8 == 0
        assert p.smem_bytes <= qops.FE_STAGE_BYTES
        if forced == "grid":
            assert bsz * p.blocks <= 132
    for variant, blocks in variants:
        # Every sample gets at least one block; the shares cover [0, n)
        # without overlap, each non-empty, and start on even elements (no
        # nibble-packed byte is split between blocks).
        assert blocks >= 1
        shares = qops.fused_encode_shares(n, blocks)
        assert len(shares) == blocks
        assert shares[0][0] == 0 and shares[-1][1] == n
        for (a0, a1), (b0, _) in zip(shares, shares[1:]):
            assert a1 == b0
        assert all(e1 > e0 and e0 % 2 == 0 for e0, e1 in shares)


def test_fused_encode_plan_picks_variants_at_the_stated_sizes():
    solo_max = qops.FE_SOLO_MAX
    assert qops.fused_encode_plan(1, solo_max, False, 132).variant == "solo"
    above = qops.fused_encode_plan(1, solo_max + 1, False, 132)
    assert above.variant == "grid" and above.blocks == min(
        132, (solo_max + 1) // qops.FE_SHARE_UNIT)
    # The served stem_pool boundary and the pipeline's micro-batch: every
    # resident block, split evenly, staged whole.
    one = qops.fused_encode_plan(1, 802_816, False, 132)
    four = qops.fused_encode_plan(4, 802_816, False, 132)
    assert (one.variant, one.blocks) == ("grid", 132)
    assert (four.variant, four.blocks) == ("grid", 33)
    assert four.stage_elems >= 802_816 // 33
    # More samples than resident blocks: one block a sample.
    assert qops.fused_encode_plan(133, 10 ** 6, False, 132).variant == "solo"
    # Past what the card stages: the same grid, each block's stage full.
    big = qops.fused_encode_plan(4, 4_194_304, False, 132)
    assert big.variant == "grid"
    assert big.smem_bytes == qops.FE_STAGE_BYTES
    assert 4 * 4_194_304 * 4 > 132 * qops.FE_STAGE_BYTES


def test_fused_encode_plan_rejects_forced_variants_that_cannot_hold():
    with pytest.raises(ValueError):      # more samples than resident blocks
        qops.fused_encode_plan(133, 10 ** 5, False, 132, "grid")
    with pytest.raises(ValueError):      # in bfloat16 too
        qops.fused_encode_plan(4, 10 ** 5, True, 3, "grid")
    with pytest.raises(ValueError):      # a card that holds no block
        qops.fused_encode_plan(1, 10 ** 5, False, 0, "grid")
    with pytest.raises(ValueError):
        qops.fused_encode_plan(1, 100, False, 132, "warp")
    # One block a sample holds any stack.
    assert qops.fused_encode_plan(133, 10 ** 5, False, 132,
                                  "solo").blocks == 1
