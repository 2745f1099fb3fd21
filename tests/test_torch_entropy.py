"""Parity of the port's Huffman coding (host numpy half, device batched
encode, kernel K3's plain version) with the reference.

Payloads must be byte-identical to the reference's device encode and to
its host encoder ``ent.huffman_encode``; the same batches must take the
host route in both packages when ``PACK_MAX_CODE_BITS`` is lowered.
``test_torch_cuda.py`` holds the CUDA kernel K3 against its plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import entropy as jent  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.kernels.entropy import ops as jeops  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.core import entropy as tent  # noqa: E402
from repro_torch.kernels.entropy import ops as teops  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402


def _features(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    x[np.abs(x) < 0.8] = 0.0           # post-ReLU-like sparsity
    return x.astype(np.float32)


def _host_reference(x, bits):
    qz = jq.quantize(jnp.asarray(x), bits)
    return jent.huffman_encode(np.asarray(qz.values), 1 << bits)


def _fib_values(n_sym=24):
    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    vals = np.repeat(np.arange(len(fib)), fib).astype(np.float32)
    np.random.default_rng(3).shuffle(vals)
    return vals


@pytest.mark.parametrize("seed", range(4))
def test_host_codec_matches_reference(seed):
    rng = np.random.default_rng(seed)
    nsym = int(rng.choice([2, 16, 256, 4096]))
    codes = rng.zipf(1.3, size=3000) % nsym
    freqs = np.bincount(codes, minlength=nsym).astype(np.int64)
    np.testing.assert_array_equal(tent._code_lengths(freqs),
                                  jent._code_lengths(freqs))
    payload = tent.huffman_encode(codes, nsym)
    assert payload == jent.huffman_encode(codes, nsym)
    np.testing.assert_array_equal(tent.huffman_decode(payload), codes)
    np.testing.assert_array_equal(jent.huffman_decode(payload), codes)
    assert tent.huffman_size_from_counts(freqs) == \
        jent.huffman_size_from_counts(freqs) == len(payload)


def test_host_codec_degenerate_trees():
    one = np.full(700, 5)
    assert tent.huffman_encode(one, 8) == jent.huffman_encode(one, 8)
    fib = _fib_values().astype(np.int64)
    payload = tent.huffman_encode(fib, 64)
    assert payload == jent.huffman_encode(fib, 64)
    np.testing.assert_array_equal(tent.huffman_decode(payload), fib)
    assert tent.huffman_encode(np.zeros(0, np.int64), 4) == \
        jent.huffman_encode(np.zeros(0, np.int64), 4)


@pytest.mark.parametrize("bits", (3, 5, 8, 12, 16))
def test_device_batch_matches_reference_device_and_host(bits):
    xb = np.stack([_features((2, 7, 11), seed=s) for s in range(3)])
    jpay, jmn, jmx = jeops.huffman_encode_batch_device(jnp.asarray(xb), bits)
    tpay, tmn, tmx = teops.huffman_encode_batch_device(torch.from_numpy(xb),
                                                       bits)
    assert tpay == jpay
    for b in range(3):
        assert tpay[b] == _host_reference(xb[b], bits)
    np.testing.assert_array_equal(tmn, np.asarray(jmn))
    np.testing.assert_array_equal(tmx, np.asarray(jmx))


def test_long_stream_matches_reference():
    """A stream over many of the CUDA kernel's 4096-element chunks and,
    with ``block_m=64``, over several reference grid blocks."""
    xb = np.stack([np.random.default_rng(s).standard_normal(40_000)
                   .astype(np.float32) for s in range(2)])
    jpay, _, _ = jeops.huffman_encode_batch_device(jnp.asarray(xb), 8,
                                                   block_m=64)
    tpay, _, _ = teops.huffman_encode_batch_device(torch.from_numpy(xb), 8)
    assert tpay == jpay
    assert tpay[1] == _host_reference(xb[1], 8)


def test_one_symbol_tree():
    xb = np.full((2, 37), 3.25, np.float32)
    tpay, _, _ = teops.huffman_encode_batch_device(torch.from_numpy(xb), 4)
    jpay, _, _ = jeops.huffman_encode_batch_device(jnp.asarray(xb), 4)
    assert tpay == jpay
    assert (tent.huffman_decode(tpay[0]) == 0).all()


def test_fibonacci_skew_tree():
    vals = _fib_values()
    xb = np.stack([vals, vals[::-1].copy()])
    codes = np.asarray(jq.quantize(jnp.asarray(xb[0]), 8).values)
    assert int(tent._code_lengths(np.bincount(codes, minlength=256)).max()) \
        > 13
    tpay, _, _ = teops.huffman_encode_batch_device(torch.from_numpy(xb), 8)
    jpay, _, _ = jeops.huffman_encode_batch_device(jnp.asarray(xb), 8)
    assert tpay == jpay
    assert tpay[1] == _host_reference(xb[1], 8)


def test_host_route_matches_reference_when_cap_lowered(monkeypatch):
    monkeypatch.setattr(jeops, "PACK_MAX_CODE_BITS", 10)
    monkeypatch.setattr(teops, "PACK_MAX_CODE_BITS", 10)
    vals = _fib_values()
    short = _features((3, 50), seed=1)
    for batch in (vals[None], np.stack([short[0], short[1]]),
                  np.stack([vals, vals[::-1].copy()])):
        jout = jeops.huffman_encode_batch_device(jnp.asarray(batch), 8)
        tout = teops.huffman_encode_batch_device(torch.from_numpy(batch), 8)
        assert (jout is None) == (tout is None)
    with qops.count_launches() as box:
        blob = get_codec("huffman").encode(torch.from_numpy(vals), 8)
    assert box.counts["huffman_host_route"] == 1
    assert blob.payload == _host_reference(vals, 8)


def test_pack_plain_version_spills_across_words():
    """Codes that straddle u32 words land in both, MSB first."""
    x = torch.tensor([[0.0, 1.0, 2.0, 3.0, 3.0]])
    mn = torch.tensor([0.0])
    scale = torch.tensor([1.0])
    code = torch.tensor([[0x3FFFFFFF, 0x1, 0x7, 0xFFFFFFFF - (1 << 32)]],
                        dtype=torch.int64).to(torch.int32)
    length = torch.tensor([[30, 3, 4, 32]], dtype=torch.uint8)
    words = teops.huffman_pack_ref(x, mn, scale, code, length, 2, 4)
    stream = "".join(["1" * 30, "001", "0111", "1" * 32, "1" * 32])
    bits = stream + "0" * (128 - len(stream))
    want = [int(bits[i:i + 32], 2) for i in range(0, 128, 32)]
    assert words.numpy().view(np.uint32).tolist() == [want]
