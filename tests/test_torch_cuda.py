"""The port's CUDA kernels K1, K2 and K3 against their plain PyTorch
versions, on the card. Every test here carries ``requires_cuda`` and skips
without a card. The file imports neither JAX nor the reference package
(the plain versions are pinned to the reference by the other
``test_torch_*`` files), so it also runs where only PyTorch is installed:

  python -m pytest -q -p no:cacheprovider --noconftest -m requires_cuda \
      tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.core import entropy as ent  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels.entropy import ops as eops  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import ref as qref  # noqa: E402

pytestmark = pytest.mark.requires_cuda

BITS = (2, 3, 4, 5, 6, 8, 12, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _features(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0
    return x


@pytest.mark.parametrize("bits", BITS)
def test_encode_decode_match_plain(cuda, bits):
    for shape in [(1, 1), (1, 4551), (3, 70_001), (2, 1 << 20)]:
        xb = torch.relu(torch.randn(shape, device=cuda))
        n = shape[1]
        with qops.count_launches() as box:
            codes, mn, mx = qops.fused_encode(xb, bits)
        assert box.counts["fused_encode"] == 2
        pc, pmn, pmx = qref.fused_encode_ref(xb, bits)
        assert torch.equal(codes, pc)
        assert torch.equal(mn, pmn) and torch.equal(mx, pmx)
        step = tq.dequant_step(mn, mx, bits)
        layouts = [(codes, bits <= 4)]
        if bits <= 4:
            q = torch.stack([codes & 15, codes >> 4], -1).reshape(shape[0],
                                                                  -1)
            layouts.append((q[:, :n].contiguous(), False))
        for cc, packed in layouts:
            for dt, view in ((torch.float32, torch.int32),
                             (torch.bfloat16, torch.int16)):
                got = qops.fused_decode(cc, mn, mx, bits, n, packed, dt)
                want = qref.fused_decode_ref(cc, mn, step, n, packed, dt)
                assert torch.equal(got.view(view), want.view(view))
        xh = xb.to(torch.bfloat16)
        assert torch.equal(qops.fused_encode(xh, bits)[0],
                           qref.fused_encode_ref(xh, bits)[0])
    torch.cuda.synchronize()


def test_codec_round_trip_matches_cpu(cuda):
    x = _features((4, 64, 14, 14), seed=1)
    for bits in (2, 4, 8, 16):
        codes, mn, mx = qops.quantize_pack(torch.from_numpy(x).to(cuda),
                                           bits)
        ccpu, mcpu, xcpu = qops.quantize_pack(torch.from_numpy(x), bits)
        assert torch.equal(codes.cpu(), ccpu)
        out = qops.dequantize_wire(codes, mn, mx, bits, x.shape)
        ocpu = qops.dequantize_wire(ccpu, mcpu, xcpu, bits, x.shape)
        assert torch.equal(out.cpu(), ocpu)


def test_wrappers_reject_wrong_code_dtype(cuda):
    codes = torch.zeros((1, 8), dtype=torch.uint8, device=cuda)
    mn = torch.zeros(1, device=cuda)
    with pytest.raises(ValueError):
        qops.fused_decode(codes, mn, mn, 12, 8, False)


@pytest.mark.parametrize("bits", (2, 4, 8, 12, 16))
def test_pack_matches_plain(cuda, bits):
    for shape in [(1, 1), (3, 4097), (2, 300_001)]:
        xb = torch.relu(torch.randn(shape, device=cuda))
        hist, mn, _, scale = eops._hist_ranges(xb, bits)
        tables = [eops._sample_table(h, 1 << bits)
                  for h in hist.cpu().numpy()]
        w_words = eops._w_words(max(t[3] for t in tables))
        clut = torch.from_numpy(
            np.stack([t[0] for t in tables]).view(np.int32)).to(cuda)
        llut = torch.from_numpy(np.stack([t[1] for t in tables])).to(cuda)
        with qops.count_launches() as box:
            words = eops.huffman_pack(xb, mn, scale, clut, llut, bits,
                                      w_words)
        assert box.counts["huffman_pack"] == 3
        want = eops.huffman_pack_ref(xb, mn, scale, clut, llut, bits,
                                     w_words)
        assert torch.equal(words, want)
    torch.cuda.synchronize()


def test_huffman_payloads_match_cpu_and_host_encoder(cuda):
    codec = get_codec("huffman")
    xs = [torch.from_numpy(_features((4, 16, 9, 9), seed=s))
          for s in range(3)]
    for bits in (4, 8, 12):
        blobs = codec.encode_batch([x.to(cuda) for x in xs], bits)
        for x, blob in zip(xs, blobs):
            host = ent.huffman_encode(tq.quantize(x, bits).values.numpy(),
                                      1 << bits)
            assert blob.payload == codec.encode(x, bits).payload == host
            back = codec.decode(blob, device=cuda)
            assert torch.equal(back.cpu(),
                               codec.decode(blob, device="cpu"))
