"""Parity of the port's per-channel codec with the reference: kernels K4
(encode) and K5 (decode), the ``perchannel`` codec, and the per-channel
axis of ``core/quantization.py``.

On the CPU the port's wrappers run their plain PyTorch versions. Their
words and ranges must equal the reference's Pallas kernels (interpret
mode) trimmed to ``perchannel_words``, their decode the jitted reference
decode bit for bit, and codec blobs must cross between the packages both
ways. ``test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codec import WireBlob as JBlob  # noqa: E402
from repro.codec import get_codec as jget  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.kernels.quantize import ops as jops  # noqa: E402
from repro_torch.codec import WireBlob as TBlob  # noqa: E402
from repro_torch.codec import get_codec as tget  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402

BITS = (2, 3, 5, 8, 12, 16)
CASES = [((2, 5, 4, 4), 1), ((2, 3, 7), 2), ((4, 10), 1)]


def _features(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[x < 0] = 0.0                      # post-ReLU boundary
    return x


def _ref_encode(x, bits, axis):
    words, mn, mx = jops.perchannel_encode(jnp.asarray(x), bits, axis,
                                           interpret=True)
    n_words = jops.perchannel_words(x.size // x.shape[axis], bits)
    return np.asarray(words)[:, :n_words], np.asarray(mn), np.asarray(mx)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape,axis", CASES)
def test_encode_words_and_ranges_match_reference(shape, axis, bits):
    x = _features(shape, seed=bits + len(shape))
    jw, jmn, jmx = _ref_encode(x, bits, axis)
    words, mn, mx = qops.perchannel_encode(torch.from_numpy(x), bits, axis)
    assert words.shape[-1] == qops.perchannel_words(
        x.size // shape[axis], bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jw)
    np.testing.assert_array_equal(mn.numpy(), jmn)
    np.testing.assert_array_equal(mx.numpy(), jmx)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("out", ("float32", "bfloat16"))
def test_decode_bit_exact_with_jitted_reference(bits, out):
    shape, axis = (2, 5, 4, 4), 1
    x = _features(shape, seed=7 * bits)
    jdt = jnp.float32 if out == "float32" else jnp.bfloat16
    tdt = torch.float32 if out == "float32" else torch.bfloat16
    jw, jmn, jmx = _ref_encode(x, bits, axis)
    want = jops.perchannel_decode(jnp.asarray(jw), jmn, jmx, bits, shape,
                                  axis, out_dtype=jdt, interpret=True)
    words = torch.from_numpy(jw.view(np.int32).copy())
    got = qops.perchannel_decode(words, jmn, jmx, bits, shape, axis, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("bits", (3, 5, 16))
def test_batched_stack_matches_single(bits):
    shape, axis = (3, 6, 5), 2
    xs = [torch.from_numpy(_features(shape, seed=40 + i)) for i in range(4)]
    wb, mnb, mxb = qops.perchannel_encode_stack(xs, bits, axis)
    outb = qops.perchannel_decode_batch(wb, mnb, mxb, bits, shape, axis)
    jwb, _, _ = jops.perchannel_encode_batch(
        jnp.stack([jnp.asarray(x.numpy()) for x in xs]), bits, axis,
        interpret=True)
    np.testing.assert_array_equal(
        wb.numpy().view(np.uint32), np.asarray(jwb)[:, :, :wb.shape[-1]])
    for i, x in enumerate(xs):
        w1, mn1, mx1 = qops.perchannel_encode(x, bits, axis)
        assert torch.equal(wb[i], w1) and torch.equal(mnb[i], mn1)
        assert torch.equal(mxb[i], mx1)
        one = qops.perchannel_decode(w1, mn1, mx1, bits, shape, axis)
        assert torch.equal(outb[i], one)


def _fields(blob):
    return (blob.codec, blob.payload, tuple(blob.shape), blob.bits,
            np.asarray(blob.x_min, np.float32).tobytes(),
            np.asarray(blob.x_max, np.float32).tobytes(), blob.axis)


def _as(cls, blob):
    return cls(blob.codec, blob.payload, tuple(blob.shape), blob.bits,
               np.asarray(blob.x_min, np.float32),
               np.asarray(blob.x_max, np.float32), blob.axis)


@pytest.mark.parametrize("bits", (2, 3, 6, 8, 12))
@pytest.mark.parametrize("shape", [(2, 6, 7, 5), (3, 40), (5, 4, 9)])
def test_codec_blobs_identical_and_cross_both_ways(shape, bits):
    x = _features(shape, seed=bits)
    jc, tc = jget("perchannel"), tget("perchannel")
    jblob = jc.encode(jnp.asarray(x), bits)
    tblob = tc.encode(torch.from_numpy(x), bits)
    assert _fields(tblob) == _fields(jblob)
    assert tblob.nbytes == jblob.nbytes == tc.wire_size_bytes(shape, bits)
    want = np.asarray(jc.decode(jblob))
    got = tc.decode(_as(TBlob, jblob), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    back = np.asarray(jc.decode(_as(JBlob, tblob)))
    np.testing.assert_array_equal(back, tc.decode(tblob, device="cpu"))


def test_codec_batched_empty_and_bf16():
    jc, tc = jget("perchannel"), tget("perchannel")
    xs = [_features((2, 4, 3, 3), seed=s) for s in range(3)]
    tblobs = tc.encode_batch([torch.from_numpy(x) for x in xs], 5)
    jblobs = jc.encode_batch([jnp.asarray(x) for x in xs], 5)
    assert [_fields(b) for b in tblobs] == [_fields(b) for b in jblobs]
    outs = tc.decode_batch(tblobs, device="cpu")
    for blob, out in zip(jblobs, outs):
        np.testing.assert_array_equal(out.numpy(), np.asarray(jc.decode(blob)))
    bf = tc.decode(tblobs[0], out_dtype=torch.bfloat16, device="cpu")
    want = jc.decode(jblobs[0], out_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(),
                                  np.asarray(want, np.float32))
    empty = tc.encode(torch.zeros((0, 3)), 8)
    jempty = jc.encode(jnp.zeros((0, 3)), 8)
    assert _fields(empty) == _fields(jempty)
    assert tuple(tc.decode(empty, device="cpu").shape) == (0, 3)


@pytest.mark.parametrize("shape", [(2, 8, 6, 6), (4, 1000), (0, 5), (3,)])
def test_sizes_and_simulate_match(shape):
    bits = (2, 3, 4, 5, 8, 16)
    jc, tc = jget("perchannel"), tget("perchannel")
    for b in bits:
        assert tc.wire_size_bytes(shape, b) == jc.wire_size_bytes(shape, b)
    if 0 in shape:
        return
    x = _features(shape, seed=11)
    assert tc.transfer_size_batch(torch.from_numpy(x), bits) == \
        jc.transfer_size_batch(jnp.asarray(x), bits)
    want = jax.jit(lambda a: jc.simulate_batch(a, bits))(jnp.asarray(x))
    got = tc.simulate_batch(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", (1, 3, 5, 6, 8, 16))
def test_pack_bits_and_unpack_bits_match(bits):
    for n in (1, 7, 64, 101):
        codes = np.random.default_rng(n).integers(0, 1 << bits, n)
        want = jq.pack_bits(jnp.asarray(codes), bits)
        got = tq.pack_bits(torch.from_numpy(codes), bits)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
        np.testing.assert_array_equal(
            tq.unpack_bits(got, bits, n).numpy(),
            np.asarray(jq.unpack_bits(want, bits, n)))
        assert tq.packed_size_bytes(n, bits) == jq.packed_size_bytes(n, bits)
    with pytest.raises(ValueError):
        tq.pack_bits(torch.zeros(3, dtype=torch.int64), 17)


@pytest.mark.parametrize("axis", (None, 0, 1, 3))
def test_quantize_dequantize_matches_jitted_reference(axis):
    x = _features((3, 6, 5, 4), seed=9)
    for bits in (2, 5, 8, 16):
        want = jax.jit(jq.quantize_dequantize, static_argnums=(1, 2))(
            jnp.asarray(x), bits, axis)
        got = tq.quantize_dequantize(torch.from_numpy(x), bits, axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jqz = jq.quantize(jnp.asarray(x), bits, axis)
        tqz = tq.quantize(torch.from_numpy(x), bits, axis)
        np.testing.assert_array_equal(tqz.values.numpy(),
                                      np.asarray(jqz.values))
        np.testing.assert_array_equal(tqz.x_min.numpy(),
                                      np.asarray(jqz.x_min))


def test_quantization_mse_matches():
    x = _features((4, 8, 6, 6), seed=3)
    for bits in (2, 4, 8):
        want = float(jq.quantization_mse(jnp.asarray(x), bits))
        got = float(tq.quantization_mse(torch.from_numpy(x), bits))
        # Float32 means summed in another order: a few ulps apart.
        assert got == pytest.approx(want, rel=1e-5)


def test_launch_counters_do_not_move_on_the_cpu():
    with qops.count_launches() as box:
        words, mn, mx = qops.perchannel_encode(torch.randn(2, 3, 4), 4, 0)
        qops.perchannel_decode(words, mn, mx, 4, (2, 3, 4), 0)
    assert box.counts["pc_encode"] == box.counts["pc_decode"] == 0


# (B, C, channel length) of K4's launches: the stem, res5, gap and fc
# boundaries of ResNet-50 at batch 4 (one sample, and a micro-batch of 4),
# the odd shape, runs on either side of the staged variant's limit, and a
# channel too long for it.
PLAN_CASES = [(1, 64, 50_176), (4, 64, 50_176), (1, 2048, 196), (1, 2048, 4),
              (1, 1000, 4), (1, 3, 1517), (2, 3, 7), (1, 5, 1), (8, 3, 1),
              (1, 2, 8 * qops.PC_SHARE_MAX_FLOATS),
              (1, 2, 8 * qops.PC_SHARE_MAX_FLOATS + 1), (1, 2, 1 << 22)]
_SM_SHARED = 233_472          # bytes of shared memory an H100 SM holds
_BLOCK_SHARED = 232_448       # the most one block may take


@pytest.mark.parametrize("bits", (1, 2, 3, 5, 8, 16))
def test_pc_encode_plan_splits_each_channel_into_word_shares(bits):
    """K4's host arithmetic: every word of a channel lies in exactly one
    block's share, each share starts on a word (``32 // bits`` elements),
    and a block's tile fits its shared memory, two blocks to an SM when
    staged."""
    per_word = 32 // bits
    for bsz, c, length in PLAN_CASES:
        n_words = qops.perchannel_words(length, bits)
        plan = qops.pc_encode_plan(bsz, c, length, bits)
        assert 1 <= plan.cluster <= min(qops.PC_MAX_CLUSTER, n_words)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
        shares = qops.pc_shares(n_words, plan.cluster)
        assert shares[0][0] == 0 and shares[-1][1] == n_words
        for (_, w1), (w0, _) in zip(shares, shares[1:]):
            assert w1 == w0
        assert all(w1 > w0 for w0, w1 in shares)
        assert all(w0 * per_word < length for w0, _ in shares)
        longest = max(w1 - w0 for w0, w1 in shares)
        assert plan.staged == (-(-n_words // (qops.PC_SHARE_MAX_FLOATS
                                              // per_word))
                               <= qops.PC_MAX_CLUSTER)
        tile = longest if plan.staged else plan.tile_words
        assert plan.tile_words >= (longest if plan.staged else 1)
        # The tile, its 32-float lead and 3 floats past its end, one spare
        # float every 32.
        assert plan.smem_bytes >= 4 * ((tile * per_word + 35) * 33 // 32)
        assert plan.smem_bytes <= _BLOCK_SHARED
        if plan.staged:
            assert tile * per_word <= qops.PC_SHARE_MAX_FLOATS
            assert 2 * (plan.smem_bytes + 1024) <= _SM_SHARED
        else:
            assert plan.tile_words * per_word <= qops.PC_STREAM_TILE
    # Clusters fill the card where B * C is small, one block where C is
    # large.
    assert qops.pc_encode_plan(1, 64, 50_176, bits).cluster == 8
    for bsz, c, length in [(1, 2048, 196), (1, 2048, 4), (1, 1000, 4)]:
        assert qops.pc_encode_plan(bsz, c, length, bits).cluster == 1


def test_pc_encode_plan_forced_variants_and_clusters():
    limit = 8 * qops.PC_SHARE_MAX_FLOATS
    assert qops.pc_encode_plan(1, 2, limit, 8, staged=False).cluster == 8
    with pytest.raises(ValueError):
        qops.pc_encode_plan(1, 2, limit + 1, 8, staged=True)
    with pytest.raises(ValueError):
        qops.pc_encode_plan(1, 2, limit, 8, staged=True, cluster=7)
    with pytest.raises(ValueError):
        qops.pc_encode_plan(1, 2, 9, 8, cluster=4)      # 3 words
    for cluster in range(1, 9):
        plan = qops.pc_encode_plan(1, 2, 1000, 3, cluster=cluster)
        assert plan.cluster == cluster and plan.staged
