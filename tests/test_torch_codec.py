"""Cross-package parity of the boundary codecs.

A blob encoded by the reference decodes in the port (bit-identical to the
reference's own decode) and a blob encoded by the port decodes in the
reference, for the per-tensor codecs (``perchannel`` has its own file,
``test_torch_perchannel.py``). The calibration hooks (``simulate``,
``transfer_size_batch``) agree on identical boundary tensors.
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
from repro_torch.codec import WireBlob as TBlob  # noqa: E402
from repro_torch.codec import get_codec as tget  # noqa: E402
from repro_torch.codec import list_codecs  # noqa: E402

CODECS = ("huffman", "bitpack")


def _features(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[x < 0] = 0.0                      # post-ReLU boundary
    return x


def _fields(blob):
    """A blob's fields, the range header by bytes (``-0.0 != +0.0``)."""
    return (blob.codec, blob.payload, tuple(blob.shape), blob.bits,
            np.float32(blob.x_min).tobytes(),
            np.float32(blob.x_max).tobytes())


def _as(cls, blob):
    return cls(blob.codec, blob.payload, tuple(blob.shape), blob.bits,
               np.float32(blob.x_min), np.float32(blob.x_max))


def test_registry_has_the_ported_codecs_only():
    assert list_codecs() == ["bitpack", "huffman", "perchannel"]
    assert tget("perchannel").value_key == "channel"
    with pytest.raises(KeyError):
        tget("png")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("bits", (2, 4, 5, 8, 12, 16))
def test_blobs_cross_both_ways(codec, bits):
    x = _features((2, 6, 7, 5), seed=bits)
    jc, tc = jget(codec), tget(codec)
    jblob = jc.encode(jnp.asarray(x), bits)
    tblob = tc.encode(torch.from_numpy(x), bits)
    assert _fields(tblob) == _fields(jblob)
    assert tblob.nbytes == jblob.nbytes
    want = np.asarray(jc.decode(jblob))
    got = tc.decode(_as(TBlob, jblob), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    back = np.asarray(jc.decode(_as(JBlob, tblob)))
    np.testing.assert_array_equal(back, tc.decode(tblob, device="cpu"))


@pytest.mark.parametrize("codec", CODECS)
def test_bf16_decode_matches(codec):
    x = _features((3, 40), seed=2)
    jc, tc = jget(codec), tget(codec)
    blob = jc.encode(jnp.asarray(x), 8)
    want = np.asarray(jc.decode(blob, out_dtype=jnp.bfloat16), np.float32)
    got = tc.decode(_as(TBlob, blob), out_dtype=torch.bfloat16,
                    device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("codec", CODECS)
def test_odd_empty_and_batched(codec):
    jc, tc = jget(codec), tget(codec)
    odd = _features((3, 5, 7), seed=5)
    for bits in (3, 4):
        assert _fields(tc.encode(torch.from_numpy(odd), bits)) == \
            _fields(jc.encode(jnp.asarray(odd), bits))
    empty = tc.encode(torch.zeros((0, 3)), 8)
    assert empty.payload == b"" and empty.num_elements == 0
    assert tuple(tc.decode(empty, device="cpu").shape) == (0, 3)
    xs = [_features((4, 9), seed=s) for s in range(3)]
    tblobs = tc.encode_batch([torch.from_numpy(x) for x in xs], 6)
    jblobs = jc.encode_batch([jnp.asarray(x) for x in xs], 6)
    assert [_fields(b) for b in tblobs] == [_fields(b) for b in jblobs]
    outs = tc.decode_batch(tblobs, device="cpu")
    for blob, out in zip(tblobs, outs):
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(jc.decode(_as(JBlob, blob))))


@pytest.mark.parametrize("codec", CODECS)
def test_calibration_hooks_match_on_identical_boundaries(codec):
    x = _features((2, 8, 6, 6), seed=11)
    bits = (2, 4, 8, 16)
    jc, tc = jget(codec), tget(codec)
    assert tc.transfer_size_batch(torch.from_numpy(x), bits) == \
        jc.transfer_size_batch(jnp.asarray(x), bits)
    for b in bits:
        assert tc.transfer_size_bytes(torch.from_numpy(x), b) == \
            tc.encode(torch.from_numpy(x), b).nbytes
        assert tc.wire_size_bytes(x.shape, b) == jc.wire_size_bytes(x.shape,
                                                                    b)
    want = jax.jit(lambda a: jc.simulate_batch(a, bits))(jnp.asarray(x))
    got = tc.simulate_batch(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_defaults_to_the_card():
    blob = tget("bitpack").encode(torch.from_numpy(_features((4,))), 8)
    if torch.cuda.is_available():
        assert tget("bitpack").decode(blob).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tget("bitpack").decode(blob)
