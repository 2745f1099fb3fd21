"""The port's CUDA kernels K1-K7 against their plain PyTorch versions, on
the card, the batched cloud step that the fleet server runs, channel
removal's mask and ``compress`` against their CPU runs, the parameter
draw on the card (``models/init.py``), and the vlm and audio families
(reduced, float32) card against CPU, with K1-K5 on their boundaries. Every
test here carries ``requires_cuda`` and skips without a card. The file
imports neither JAX nor the reference package
(the plain versions are pinned to the reference by the other
``test_torch_*`` files), so it also runs where only PyTorch is installed:

  python -m pytest -q -p no:cacheprovider --noconftest -m requires_cuda \
      tests/test_torch_cuda.py
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

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


def _same_bits(a, b):
    """Equal float32 tensors bit for bit (``torch.equal`` takes -0.0 for
    +0.0)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


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
        assert box.counts["fused_encode"] == 1
        pc, pmn, pmx = qref.fused_encode_ref(xb, bits)
        assert torch.equal(codes, pc)
        assert _same_bits(mn, pmn) and _same_bits(mx, pmx)
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


FE_BITS = (2, 3, 4, 5, 8, 16)


def _encode_matches_plain(xb, bits, variant=None):
    """K1 (``variant`` forced, or picked) against the plain version: codes
    byte-identical, ranges bit-identical, one launch."""
    with qops.count_launches() as box:
        got = qops._fused_encode_cuda(xb, bits, variant)
    assert box.counts["fused_encode"] == 1
    want = qref.fused_encode_ref(xb, bits)
    assert torch.equal(got[0], want[0]), (tuple(xb.shape), bits, variant)
    assert _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])
    return got


@pytest.mark.parametrize("bits", FE_BITS)
def test_fused_encode_variants_match_plain(cuda, bits):
    """Each variant forced, in float32 and bfloat16, at odd n (rows of a
    B-stack that start off every 16-byte boundary, a last byte that
    repeats element 0), and B-stacks equal to single calls."""
    gen = torch.Generator(device=cuda).manual_seed(bits)
    for bsz, n in [(1, 4551), (3, 70_001), (2, 401_409)]:
        x = torch.randn((bsz, n), device=cuda, generator=gen)
        x = torch.relu(x) - 0.25 * (x < -1)
        for xb in (x, x.to(torch.bfloat16)):
            bf16 = xb.dtype == torch.bfloat16
            resident = qops.fused_encode_resident(cuda, bf16, bits)
            for variant in qops.FE_VARIANTS:
                plan = qops.fused_encode_plan(bsz, n, bf16, resident,
                                              variant)
                assert plan.variant == variant
                codes, mn, mx = _encode_matches_plain(xb, bits, variant)
                for b in range(bsz):
                    one = _encode_matches_plain(xb[b:b + 1], bits, variant)
                    assert torch.equal(one[0][0], codes[b])
                    assert _same_bits(one[1], mn[b:b + 1])
    torch.cuda.synchronize()


def test_fused_encode_past_the_staged_capacity_matches_plain(cuda):
    """A (4, 4,194,304) float32 stack: 64 MiB, more than the card stages,
    so every block reads part of its share a second time."""
    xb = torch.relu(torch.randn((4, 4_194_304), device=cuda))
    plan = qops.fused_encode_plan(4, 4_194_304, False,
                                  qops.fused_encode_resident(cuda, False, 8))
    assert plan.variant == "grid"
    assert plan.stage_elems < 4_194_304 // plan.blocks
    for bits in (4, 8, 16):
        _encode_matches_plain(xb, bits)
    torch.cuda.synchronize()


@pytest.mark.parametrize("zeros", ("+0 first", "-0 first"))
def test_fused_encode_signed_zero_ranges_match_plain(cuda, zeros):
    """Samples whose minimum or maximum is a zero of both signs: the
    ranges equal the plain version's (the reference's) bit for bit in
    every variant, whatever order the blocks fold in."""
    z = [0.0, -0.0] if zeros == "+0 first" else [-0.0, 0.0]
    for bsz, n in [(1, 4551), (2, 70_001), (1, 802_816)]:
        rows = []
        for b in range(bsz):
            pattern = z + [1.0, 2.0] if b % 2 == 0 else [-1.0, -2.0] + z
            rows.append(np.resize(np.array(pattern, np.float32), n))
        xb = torch.from_numpy(np.stack(rows)).to(cuda)
        for variant in qops.FE_VARIANTS:
            for bits in (4, 8):
                _, mn, mx = _encode_matches_plain(xb, bits, variant)
                want = np.array([-0.0 if b % 2 == 0 else -2.0
                                 for b in range(bsz)], np.float32)
                assert np.array_equal(mn.cpu().numpy().view(np.int32),
                                      want.view(np.int32))
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


DECODE_BITS = (1, 2, 3, 4, 5, 8, 12, 16)


def _ranges(rng, bsz, cuda):
    """(bsz,) float32 ranges on the card, the last one empty when bsz > 1."""
    mn = rng.standard_normal(bsz).astype(np.float32)
    mx = (mn + np.abs(rng.standard_normal(bsz)) * 4).astype(np.float32)
    if bsz > 1:
        mx[-1] = mn[-1]
    return torch.from_numpy(mn).to(cuda), torch.from_numpy(mx).to(cuda)


@pytest.mark.parametrize("bits", DECODE_BITS)
def test_fused_decode_vectors_and_edges_match_plain(cuda, bits):
    """K2's vector body, its scalar head and tail, and codes that are not
    16-byte aligned where the output is (odd n packed, longer rows), in
    one launch, bit-identical to the plain version."""
    rng = np.random.default_rng(bits)
    for bsz in (1, 3):
        for n in (1, 15, 4096, 4097):
            mn, mx = _ranges(rng, bsz, cuda)
            step = tq.dequant_step(mn, mx, bits)
            q = rng.integers(0, 1 << bits, size=(bsz, n))
            layouts = [(q, False)]
            if bits <= 4:
                qq = np.concatenate([q, q[:, :1]], 1) if n % 2 else q
                layouts.append((qq[:, 0::2] | (qq[:, 1::2] << 4), True))
            for codes, packed in layouts:
                dtype = torch.uint8 if packed else qref.code_dtype(bits)
                for extra in (0, 5):
                    cc = torch.from_numpy(np.pad(codes, ((0, 0), (0, extra)))
                                          .astype(np.int32)).to(cuda)
                    cc = cc.to(dtype)
                    for dt, view in ((torch.float32, torch.int32),
                                     (torch.bfloat16, torch.int16)):
                        with qops.count_launches() as box:
                            got = qops.fused_decode(cc, mn, mx, bits, n,
                                                    packed, dt)
                        assert box.counts["fused_decode"] == 1
                        want = qref.fused_decode_ref(cc, mn, step, n, packed,
                                                     dt)
                        assert torch.equal(got.view(view), want.view(view))
    torch.cuda.synchronize()


# Per-channel shapes with ``inner`` below, at and above K5's tiled-variant
# threshold, runs that are not a multiple of four long, and runs longer
# than one tile.
PC_DECODE_CASES = [((2, 5, 4, 7), 1), ((9, 31), 0), ((4, 64), 1),
                   ((2, 7, 33), 1), ((2, 4, 63), 1), ((2, 3, 64), 1),
                   ((1, 3, 37, 41), 1), ((3, 2, 1100), 1), ((1, 2, 5000), 1)]


@pytest.mark.parametrize("bits", DECODE_BITS)
def test_pc_decode_variants_match_plain(cuda, bits):
    """K5 in one launch, and each of its variants forced, bit-identical to
    the plain version in float32 and bfloat16."""
    for bsz in (1, 3):
        for shape, axis in PC_DECODE_CASES:
            x = torch.relu(torch.randn((bsz,) + shape, device=cuda))
            x.select(axis + 1, 0).fill_(0.5)     # an empty range
            words, mn, mx = qref.pc_encode_ref(x, bits, axis)
            inner = qref.channel_dims(shape, axis)[2]
            for dt, view in ((torch.float32, torch.int32),
                             (torch.bfloat16, torch.int16)):
                want = qref.pc_decode_ref(words, mn, mx, bits, shape, axis,
                                          dt).view(view)
                with qops.count_launches() as box:
                    got = qops.pc_decode(words, mn, mx, bits, shape, axis, dt)
                assert box.counts["pc_decode"] == 1
                assert torch.equal(got.view(view), want)
                for tiled in (False, True):
                    forced = qops._pc_decode_cuda(words, mn, mx, bits, shape,
                                                  axis, dt, tiled)
                    assert torch.equal(forced.view(view), want), (
                        shape, inner, tiled, dt)
    torch.cuda.synchronize()


def _device_kernels(fn, reps=4, tries=5):
    """Device kernels a call of ``fn`` runs: name -> launches a call, over
    ``reps`` calls. A profiler session that lost calls' events (counts not
    whole multiples of ``reps``) is taken again; the last one's counts are
    rounded."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        names = Counter(e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        if names and (all(v % reps == 0 for v in names.values())
                      or attempt == tries - 1):
            return {k: max(1, round(v / reps)) for k, v in names.items()}
    return {}


def test_decodes_run_one_device_kernel_a_call(cuda):
    xb = torch.relu(torch.randn((3, 4551), device=cuda))
    codes, mn, mx = qops.fused_encode(xb, 4)
    # K1 too: one kernel and no memset, in every variant.
    x1 = torch.relu(torch.randn((1, 802_816), device=cuda))
    for variant in qops.FE_VARIANTS:
        kernels = _device_kernels(lambda: qops._fused_encode_cuda(
            x1, 8, variant))
        assert list(kernels.values()) == [1], (variant, kernels)
        assert "fused_encode" in next(iter(kernels))
    kernels = _device_kernels(lambda: qops.fused_decode(codes, mn, mx, 4,
                                                        4551, True))
    assert list(kernels.values()) == [1], kernels
    assert "dequant" in next(iter(kernels))
    for shape in ((4, 3, 37, 41), (4, 123)):
        xs = torch.relu(torch.randn((3,) + shape, device=cuda))
        words, mn, mx = qops.pc_encode(xs, 8, 1)
        kernels = _device_kernels(lambda: qops.pc_decode(words, mn, mx, 8,
                                                         shape, 1))
        assert list(kernels.values()) == [1], (shape, kernels)
        assert "pc_decode" in next(iter(kernels))


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
        assert box.counts["huffman_pack"] == 1
        want = eops.huffman_pack_ref(xb, mn, scale, clut, llut, bits,
                                     w_words)
        assert torch.equal(words, want)
    torch.cuda.synchronize()


def _pack_both(xb, mn, scale, clut, llut, bits, w_words):
    with qops.count_launches() as box:
        words = eops.huffman_pack(xb, mn, scale, clut, llut, bits, w_words)
    assert box.counts["huffman_pack"] == 1
    want = eops.huffman_pack_ref(xb, mn, scale, clut, llut, bits, w_words)
    return words, want


def _canonical_tables(xb, bits):
    """The encode's own tables of a (B, n) stack, as the codec builds
    them: (mn, scale, code tables, length tables, w_words, totals)."""
    hist, mn, _, scale = eops._hist_ranges(xb, bits)
    tables = [eops._sample_table(h, 1 << bits) for h in hist.cpu().numpy()]
    assert all(t is not None for t in tables)
    dev = xb.device
    clut = torch.from_numpy(np.stack([t[0] for t in tables]).view(np.int32))
    llut = torch.from_numpy(np.stack([t[1] for t in tables]))
    totals = [t[3] for t in tables]
    return (mn, scale, clut.to(dev), llut.to(dev),
            eops._w_words(max(totals)), totals)


def _synthetic_tables(bsz, bits, lengths, seed, dev):
    """(B, 2^bits) tables of the given code lengths (any, not canonical:
    K3 only places each code's low ``length`` bits), random codes."""
    rng = np.random.default_rng(seed)
    lens = np.broadcast_to(lengths, (bsz, 1 << bits)).astype(np.uint8)
    codes = rng.integers(0, 1 << 32, size=lens.shape, dtype=np.uint64)
    codes &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    clut = torch.from_numpy(codes.astype(np.uint32).view(np.int32))
    return clut.to(dev), torch.from_numpy(lens.copy()).to(dev)


# K3's edge cases: (label, B, n, bits, dtype). The stress stack has more
# tiles (4 x 1,024) than the card holds blocks at once.
PACK_EDGE_CASES = [("two symbols", 1, 70_001, 2, torch.float32),
                   ("under one tile", 1, 1000, 8, torch.float32),
                   ("one tile", 2, 4096, 8, torch.float32),
                   ("unequal totals", 4, 50_000, 8, torch.float32),
                   ("bf16", 3, 70_001, 8, torch.bfloat16),
                   ("bf16 odd", 2, 4551, 4, torch.bfloat16),
                   ("stress", 4, 4_194_304, 8, torch.float32)]


@pytest.mark.parametrize("case", PACK_EDGE_CASES, ids=lambda c: c[0])
def test_pack_edge_cases_match_plain(cuda, case):
    label, bsz, n, bits, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(bsz * n + bits)
    x = torch.relu(torch.randn((bsz, n), device=cuda, generator=gen))
    if label == "two symbols":
        x = (x > 0).float()
    if label == "unequal totals":
        x = x * torch.arange(1, bsz + 1, device=cuda)[:, None]
        x[0, n // 2:] = 0.0
    xb = x.to(dtype)
    mn, scale, clut, llut, w_words, totals = _canonical_tables(xb, bits)
    if label == "two symbols":
        assert int(llut.max()) == 1
    if label == "unequal totals":
        assert len(set(totals)) == bsz
    words, want = _pack_both(xb, mn, scale, clut, llut, bits, w_words)
    assert torch.equal(words, want), label
    if bsz > 1:
        # A stack's rows equal single calls, trimmed to each stream.
        for b in range(bsz):
            one = eops.huffman_pack(xb[b:b + 1], mn[b:b + 1],
                                    scale[b:b + 1], clut[b:b + 1],
                                    llut[b:b + 1], bits,
                                    eops._w_words(totals[b]))
            k = -(-totals[b] // 32)
            assert torch.equal(one[0, :k], words[b, :k]), (label, b)
    torch.cuda.synchronize()


@pytest.mark.parametrize("lengths", ("all 32", "1 to 32", "all 8", "all 1"))
def test_pack_synthetic_code_lengths_match_plain(cuda, lengths):
    """Codes of every length up to 32 bits, tiles whose bit counts are
    multiples of 32 (all 8 bits: every tile starts on a word), and a whole
    tile of 32-bit codes (4,096 words)."""
    bits = 8
    rng = np.random.default_rng(5)
    lens = {"all 32": np.full(256, 32), "1 to 32": rng.integers(1, 33, 256),
            "all 8": np.full(256, 8), "all 1": np.ones(256)}[lengths]
    for bsz, n in [(1, 4096 * 3), (2, 70_001), (3, 4551)]:
        xb = torch.relu(torch.randn((bsz, n), device=cuda))
        _, mn, _, scale = eops._hist_ranges(xb, bits)
        clut, llut = _synthetic_tables(bsz, bits, lens, bsz, cuda)
        w_words = eops._w_words(32 * n)
        words, want = _pack_both(xb, mn, scale, clut, llut, bits, w_words)
        assert torch.equal(words, want), (lengths, bsz, n)
    torch.cuda.synchronize()


def test_pack_and_pc_encode_run_one_device_kernel_a_call(cuda):
    """K3: one kernel and the one memset it names (the look-back
    scratch); K4: one kernel, whichever variant."""
    xb = torch.relu(torch.randn((2, 70_001), device=cuda))
    mn, scale, clut, llut, w_words, _ = _canonical_tables(xb, 8)
    ops = _device_kernels(lambda: eops.huffman_pack(xb, mn, scale, clut,
                                                    llut, 8, w_words))
    kernels = {k: v for k, v in ops.items() if not k.startswith("Memset")}
    assert list(kernels.values()) == [1], ops
    assert "huffman_pack" in next(iter(kernels))
    assert sum(ops.values()) - 1 == 1, ops
    x = torch.relu(torch.randn((1, 2, 8 * qops.PC_SHARE_MAX_FLOATS),
                               device=cuda))
    for staged in (True, False):
        ops = _device_kernels(lambda: qops._pc_encode_cuda(x, 8, 0, staged))
        assert list(ops.values()) == [1], (staged, ops)
        assert "pc_encode" in next(iter(ops))


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


PC_CASES = [((4, 64, 112, 112), 1), ((4, 2048, 7, 7), 1), ((4, 2048), 1),
            ((1, 3, 37, 41), 1), ((2, 3, 7), 2), ((5, 1), 0)]


@pytest.mark.parametrize("bits", (1, 2, 3, 4, 5, 6, 8, 12, 16))
def test_perchannel_encode_decode_match_plain(cuda, bits):
    for shape, axis in PC_CASES:
        xb = torch.relu(torch.randn((2,) + shape, device=cuda))
        with qops.count_launches() as box:
            words, mn, mx = qops.pc_encode(xb, bits, axis)
        assert box.counts["pc_encode"] == 1
        pw, pmn, pmx = qref.pc_encode_ref(xb, bits, axis)
        assert torch.equal(words, pw)
        assert torch.equal(mn, pmn) and torch.equal(mx, pmx)
        for dt, view in ((torch.float32, torch.int32),
                         (torch.bfloat16, torch.int16)):
            with qops.count_launches() as box:
                got = qops.pc_decode(words, mn, mx, bits, shape, axis, dt)
            assert box.counts["pc_decode"] == 1
            want = qref.pc_decode_ref(words, mn, mx, bits, shape, axis, dt)
            assert torch.equal(got.view(view), want.view(view))
        one, mn1, _ = qops.perchannel_encode(xb[1], bits, axis)
        assert torch.equal(one, words[1]) and torch.equal(mn1, mn[1])
    torch.cuda.synchronize()


# Channel lengths that are not multiples of cluster x (32 // bits), with
# 16-byte loads (inner % 4 == 0) and without.
PC_CLUSTER_SHAPES = [((3, 4, 1001), 1), ((2, 2, 4100), 1), ((2, 5, 17), 1)]


@pytest.mark.parametrize("bits", (2, 3, 5, 16))
def test_pc_encode_clusters_and_variants_match_plain(cuda, bits):
    """K4 forced to every cluster size from 1 to 8, in both variants."""
    for shape, axis in PC_CLUSTER_SHAPES:
        xb = torch.relu(torch.randn((2,) + shape, device=cuda))
        xb[1, :, 0] = 0.25                      # an empty range
        pw, pmn, pmx = qref.pc_encode_ref(xb, bits, axis)
        outer, c, inner = qref.channel_dims(shape, axis)
        n_words = qops.perchannel_words(outer * inner, bits)
        for cluster in range(1, min(qops.PC_MAX_CLUSTER, n_words) + 1):
            for staged in (True, False):
                words, mn, mx = qops._pc_encode_cuda(xb, bits, axis, staged,
                                                     cluster)
                assert torch.equal(words, pw), (shape, cluster, staged)
                assert torch.equal(mn, pmn) and torch.equal(mx, pmx)
    # Runs of several streaming tiles: one the host stages, one too long to
    # stage.
    for length in (3 * qops.PC_STREAM_TILE + 7,
                   8 * qops.PC_SHARE_MAX_FLOATS + 9):
        xb = torch.relu(torch.randn((1, 2, length), device=cuda))
        pw, pmn, pmx = qref.pc_encode_ref(xb, bits, 0)
        for got in (qops.pc_encode(xb, bits, 0),
                    qops._pc_encode_cuda(xb, bits, 0, False)):
            assert torch.equal(got[0], pw) and torch.equal(got[1], pmn)
            assert torch.equal(got[2], pmx)
    torch.cuda.synchronize()


def test_perchannel_codec_matches_cpu(cuda):
    codec = get_codec("perchannel")
    xs = [torch.from_numpy(_features((4, 16, 9, 9), seed=s))
          for s in range(3)]
    for bits in (3, 8, 12):
        blobs = codec.encode_batch([x.to(cuda) for x in xs], bits)
        for x, blob in zip(xs, blobs):
            cpu = codec.encode(x, bits)
            assert blob.payload == cpu.payload
            assert np.array_equal(blob.x_min, cpu.x_min)
            back = codec.decode_batch([blob, blob], device=cuda)[0]
            assert torch.equal(back.cpu(), codec.decode(cpu, device="cpu"))


def _k6_inputs(cuda):
    """K6's inputs, each in float32 and bfloat16: the sizes of the main
    path and either side of K6a's one-block limit, one that starts off
    every 16-byte boundary (a view one element in), and zeros only, one
    sign near the start and the other everywhere else (range (-0.0,
    +0.0))."""
    solo = qops.K6A_SOLO_BYTES // 4
    xs = [torch.relu(torch.randn(n, device=cuda))
          for n in (1, 4551, solo, solo + 1, 70_001, 4 * 64 * 112 * 112)]
    zeros = torch.zeros(4 * 64 * 112 * 112, device=cuda)
    zeros[5] = -0.0
    xs += [zeros, -zeros]
    out = [t for x in xs for t in (x, x.to(torch.bfloat16))]
    x = torch.relu(torch.randn(70_002, device=cuda))
    return out + [x[1:], x.to(torch.bfloat16)[1:]]


@pytest.mark.parametrize("bits", (2, 3, 4, 8, 12, 16))
def test_threelaunch_kernels_match_plain_and_fused_encode(cuda, bits):
    for xx in _k6_inputs(cuda):
        with qops.count_launches() as box:
            mn, mx = qops.minmax_blocks(xx)
        assert box.counts["minmax_blocks"] == 1
        assert mn.shape == mx.shape == ()
        rmn, rmx = qref.minmax_blocks_ref(xx)
        assert _same_bits(mn, rmn) and _same_bits(mx, rmx)
        amn, amx = tq.ordered_aminmax(xx.float())
        assert _same_bits(mn, amn) and _same_bits(mx, amx)
        codes = qops.quantize_blocks(xx, mn, mx, bits)
        assert torch.equal(codes, qref.quantize_blocks_ref(xx, mn, mx, bits))
        if bits <= 4:
            assert torch.equal(qops.pack4_blocks(codes),
                               qref.pack4_blocks_ref(codes))
        with qops.count_launches() as box:
            chain = qops.quantize_pack_threelaunch(xx, bits)
        assert sum(box.counts.values()) == (3 if bits <= 4 else 2)
        fused = qops.quantize_pack(xx, bits)
        assert torch.equal(chain[0], fused[0])
        assert _same_bits(chain[1], fused[1])
        assert _same_bits(chain[2], fused[2])
    torch.cuda.synchronize()


def test_threelaunch_chain_runs_only_its_kernels(cuda):
    """The chain's device work is its kernels, K6a, K6b and K6c at <= 4
    bits, one launch each a call, and nothing else: no memset, no PyTorch
    operation between them."""
    x = torch.relu(torch.randn((4, 64, 112, 112), device=cuda))
    for bits, names in ((8, ("minmax", "quantize")),
                        (4, ("minmax", "quantize", "pack4"))):
        ops = _device_kernels(lambda: qops.quantize_pack_threelaunch(x,
                                                                     bits))
        assert list(ops.values()) == [1] * len(names), (bits, ops)
        for name in names:
            assert any(name in k for k in ops), (bits, name, ops)


def test_pack4_blocks_offsets_counts_and_wide_codes_match_plain(cuda):
    """K6c on codes that start 0-15 bytes off a 16-byte boundary (views into
    one buffer: the byte-wise branch), at odd and even counts, below 16, at
    one more than a multiple of 16 and at the stem's count; and on codes of
    16 and above, whose bytes are the plain version's ``lo | hi << 4``
    truncated to 8 bits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    stem = 4 * 64 * 112 * 112
    buf = torch.randint(0, 256, (stem + 16,), dtype=torch.uint8,
                        device=cuda, generator=gen)
    counts = (1, 2, 7, 15, 16, 17, 33, 4096, 4097, 70_001, stem)
    for src in (buf & 15, buf):
        for off in range(16):
            for n in counts:
                codes = src[off:off + n]
                with qops.count_launches() as box:
                    got = qops.pack4_blocks(codes)
                assert box.counts["pack4_blocks"] == 1
                assert torch.equal(got, qref.pack4_blocks_ref(codes)), (
                    int(src.max()), off, n)
    torch.cuda.synchronize()


def test_channel_mask_and_compress_match_cpu(cuda):
    """``apply_channel_mask`` on the card equals its CPU run bit for bit
    (signed zeros included) in float32 and bfloat16; ``compress`` of the
    masked boundary launches K3 once and gives the CPU run's payload,
    range and transfer size."""
    from repro_torch.core import channel_removal as cr
    from repro_torch.core import compression as comp

    x = torch.from_numpy(_features((4, 64, 56, 56), seed=9)) - 0.1
    x[0, 3] = -0.0
    mask = np.random.default_rng(0).random(64) > 0.25
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        got = cr.apply_channel_mask(xc.to(cuda), mask, axis=1)
        want = cr.apply_channel_mask(xc, mask, axis=1)
        assert got.device.type == "cuda" and got.dtype == dtype
        assert torch.equal(got.cpu().float().view(torch.int32),
                           want.float().view(torch.int32))
    masked = cr.apply_channel_mask(x, mask, axis=1)
    for bits in (2, 4, 8):
        with qops.count_launches() as box:
            c = comp.compress(masked.to(cuda), bits)
        assert box.counts["huffman_pack"] == 1
        cpu = comp.compress(masked, bits)
        assert c.payload == cpu.payload and c.shape == cpu.shape
        assert np.float32(c.x_min).tobytes() == np.float32(cpu.x_min).tobytes()
        assert np.float32(c.x_max).tobytes() == np.float32(cpu.x_max).tobytes()
        size = comp.transfer_size_bytes(masked.to(cuda), bits)
        assert size == comp.transfer_size_bytes(masked, bits)
        assert abs(size - c.nbytes) <= 64


@pytest.mark.parametrize("codec", ("bitpack", "huffman", "perchannel"))
def test_cloud_step_batch_matches_cloud_step(cuda, codec):
    from repro_torch.config import get_config
    from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import build_model

    model = build_model(get_config("resnet50").reduced())
    params = model.init(0, cuda)
    runner = DecoupledRunner(model, params,
                             DecoupledPlan(4, 4, 0.0, 0.0, 0.0, codec))
    blobs = [runner.edge_step(make_batch(model.cfg, bsz, 64, seed=i))[0]
             for i, bsz in enumerate((2, 2, 2))]
    name = "pc_decode" if codec == "perchannel" else "fused_decode"
    with qops.count_launches() as box:
        outs = runner.cloud_step_batch(blobs)
    assert box.counts[name] == 1
    fused = runner.cloud_step_batch(blobs, fuse_tail=True)
    for blob, out, f in zip(blobs, outs, fused):
        want = runner.cloud_step(blob)
        assert torch.equal(out, want)
        scale = float(want.abs().max())
        assert float((f - want).abs().max()) <= 1e-4 * scale
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# models/init.py: the draw on the card
# ---------------------------------------------------------------------------


def test_device_draw_is_seeded_shaped_and_chunked(cuda, monkeypatch):
    """draw="device" on the card: the specs' shapes, dtypes and device;
    the same bits for a seed (two draws), other bits for another seed;
    the initializer's scale; and the card's peak memory over the draw of
    a bf16 leaf of 2^27 elements (256 MiB) with chunks of 2^24 stays
    within the leaf plus ONE float32 chunk (64 MiB), not the leaf's 512
    MiB of float32."""
    from repro_torch.models import init as init_lib
    from repro_torch.models.init import materialize, spec

    chunk = 1 << 24
    monkeypatch.setattr(init_lib, "DEVICE_CHUNK", chunk)
    specs = {"w": spec((8, 4096, 4096), ("e", "d", "f"), "bfloat16"),
             "r": spec((4096, 8), ("d", "e"), "float32", scale=0.1),
             "n": spec((4096,), ("d",), "bfloat16", init="ones")}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = materialize(specs, 0, cuda, draw="device")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    leaves = sum(v.numel() * v.element_size() for v in a.values())
    assert peak <= leaves + chunk * 4 + (1 << 20), (peak, leaves)
    b = materialize(specs, 0, cuda, draw="device")
    c = materialize(specs, 1, cuda, draw="device")
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape and a[k].device.type == "cuda"
        assert str(a[k].dtype) == f"torch.{s.dtype}"
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["w"], c["w"])
    assert (a["n"] == 1).all()
    std = 1.0 / np.sqrt(8 * 4096)              # the fan-in rule
    w = a["w"][0].float()
    assert float(w.abs().max()) <= 2 * std * 1.01
    assert 0.8 * std < float(w.std()) < 0.95 * std    # N(0,1) cut at 2


def test_model_init_draws_on_the_card(cuda):
    """Model.init(draw="device") gives the CPU draw's tree (shapes and
    dtypes) on the card, deterministic for a seed, with other values than
    the CPU draw (which stays the default)."""
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    m = build_model(get_config("grok-1-314b").reduced())
    dev = m.init(0, cuda, draw="device")
    again = m.init(0, cuda, draw="device")
    host = m.init(0, cuda)
    w = dev["segments"][0]["mlp"]["w_gate"]
    assert torch.equal(w, again["segments"][0]["mlp"]["w_gate"])
    assert w.shape == host["segments"][0]["mlp"]["w_gate"].shape
    assert not torch.equal(w, host["segments"][0]["mlp"]["w_gate"])


# ---------------------------------------------------------------------------
# The vlm and audio families: reduced models, card against CPU
# ---------------------------------------------------------------------------

MM_ARCHS = ("qwen2-vl-7b", "seamless-m4t-large-v2")
# float32 with TF32 off: the card's matrix products sum in other orders
# than the CPU's, ~1e-6 of the logits' scale.
MM_RTOL = 1e-5


def _mm_model(arch, cuda):
    """The reduced model, its weights from seed 0 on the CPU and a copy on
    the card, and a ``make_batch`` prompt of 32 (vlm: 16 stub vision rows
    + 16 tokens; audio: 32 tokens and 8 stub frames)."""
    from repro_torch.config import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_to

    m = build_model(get_config(arch).reduced())
    cpu_p = m.init(0, "cpu")
    return m, cpu_p, params_to(cpu_p, cuda), make_batch(m.cfg, 2, 32, seed=1)


def _rel(a, b):
    return float((a.cpu().float() - b.float()).abs().max()
                 / b.float().abs().max())


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_multimodal_forward_and_decode_match_cpu(cuda, arch):
    """Prefill (the encoder, the vision prefix and M-RoPE ids built on the
    card) and one decode step from its caches."""
    from repro_torch.models.api import batch_to

    m, cpu_p, card_p, batch = _mm_model(arch, cuda)
    with torch.no_grad():
        lh, ch = m.prefill(cpu_p, batch_to(batch, "cpu"), 48)
        lc, cc = m.prefill(card_p, batch_to(batch, cuda), 48)
        assert lc.device.type == "cuda" and lc.shape == lh.shape
        assert _rel(lc, lh) <= MM_RTOL
        tok = lh[:, -1:].argmax(-1)
        pos = batch["tokens"].shape[1]
        sh, _ = m.decode_step(cpu_p, tok, pos, ch)
        sc, _ = m.decode_step(card_p, tok.to(cuda), pos, cc)
        assert _rel(sc, sh) <= MM_RTOL
        x, extras = m.run_head(card_p, batch_to(batch, cuda), 0)
        assert torch.equal(m.run_tail(card_p, x, 0, extras),
                           m.forward(card_p, batch_to(batch, cuda)))


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_codecs_on_multimodal_boundaries_match_cpu(cuda, arch):
    """K1-K5 through the three codecs on the (2, 32, 256) boundary of the
    reduced model: the card's blobs (payload and ranges) equal the CPU's
    plain versions byte for byte, the decodes bit for bit, each call one
    launch of the codec's kernels."""
    from repro_torch.models.api import batch_to

    m, _, card_p, batch = _mm_model(arch, cuda)
    with torch.no_grad():
        x, _ = m.run_head(card_p, batch_to(batch, cuda), 0)
    assert tuple(x.shape) == (2, 32, 256)
    kernels = {"bitpack": ("fused_encode", "fused_decode"),
               "huffman": ("huffman_pack", "fused_decode"),
               "perchannel": ("pc_encode", "pc_decode")}
    for name, (enc, dec) in kernels.items():
        codec = get_codec(name)
        for bits in (2, 4, 8):
            with qops.count_launches() as box:
                blob = codec.encode(x, bits)
                back = codec.decode(blob, device=cuda)
            assert box.counts[enc] == 1 and box.counts[dec] == 1
            cpu = codec.encode(x.cpu(), bits)
            assert blob.payload == cpu.payload
            assert np.asarray(blob.x_min).tobytes() == np.asarray(
                cpu.x_min).tobytes()
            assert np.asarray(blob.x_max).tobytes() == np.asarray(
                cpu.x_max).tobytes()
            want = codec.decode(cpu, device="cpu")
            assert torch.equal(back.cpu().view(torch.int32),
                               want.view(torch.int32))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K7a / K7b: the int8 KV cache's decode step
# ---------------------------------------------------------------------------

def _chat_lengths(rows):
    """Valid slots of the stream's rows (bench/traffic/closed_chat.py's
    grid of 32 prompts of 128-1,792 tokens, each row halfway through its
    32-256 output tokens), repeated to ``rows``."""
    from bench.traffic.closed_chat import log_uniform_grid

    prompts = log_uniform_grid(128, 1792, 32)
    outputs = log_uniform_grid(32, 256, 32)
    return np.resize(prompts + outputs[::-1] // 2, rows)


# (rows, S_c, heads, kv heads, head dim, dtype): the stream's shapes, GQA,
# granite's MQA (48 query heads a kv head), zamba2's 80 and seamless's 64
# head dims, the reduced models' float32, and head dims whose rows take 8,
# 4, 2 and 1 codes a load.
KV8_CASES = [
    (32, 2048, 16, 16, 128, torch.bfloat16),
    (5, 600, 32, 8, 128, torch.bfloat16),
    (3, 300, 48, 1, 128, torch.bfloat16),
    (4, 520, 32, 32, 80, torch.bfloat16),
    (3, 257, 16, 16, 64, torch.bfloat16),
    (3, 48, 4, 4, 64, torch.float32),
    (3, 48, 4, 1, 64, torch.float32),
    (4, 90, 12, 4, 24, torch.bfloat16),
    (3, 70, 10, 2, 36, torch.float32),
    (3, 33, 5, 5, 10, torch.bfloat16),
    (2, 300, 7, 1, 7, torch.float32),
    (2, 64, 6, 2, 256, torch.bfloat16),
]


def _kv8_inputs(case, cuda, seed=0):
    """Random codes and scales in the cache, the step's q / k / v rows,
    each row's position (ragged; the stream case on the chat grid; past
    S_c where a ring buffer wraps) and a live mask with rows off."""
    b, s_c, h, kv, hd, dt = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    cache = {
        "k": torch.randint(-127, 128, (b, s_c, kv, hd), generator=g,
                           dtype=torch.int8),
        "v": torch.randint(-127, 128, (b, s_c, kv, hd), generator=g,
                           dtype=torch.int8),
        "ks": torch.rand((b, s_c, kv), generator=g) * 0.05 + 1e-3,
        "vs": torch.rand((b, s_c, kv), generator=g) * 0.05 + 1e-3}
    q = torch.randn((b, 1, h, hd), generator=g).to(dt)
    k_new = (torch.randn((b, 1, kv, hd), generator=g) * 3).to(dt)
    v_new = torch.randn((b, 1, kv, hd), generator=g).to(dt)
    if b == 32 and s_c == 2048:
        pos = _chat_lengths(b) - 1
    else:
        pos = torch.randint(0, 2 * s_c, (b,), generator=g).numpy()
        pos[0], pos[-1] = 0, s_c - 1
    live = np.ones(b, bool)
    live[1::3] = False
    to = dict(device=cuda)
    return ({k: t.to(**to) for k, t in cache.items()}, q.to(**to),
            k_new.to(**to), v_new.to(**to),
            torch.as_tensor(pos, dtype=torch.int64, device=cuda),
            torch.as_tensor(live, device=cuda))


def _kv8_exact(q, cache, pos):
    """Float64 attention over the int8 cache's exact values: each row's
    first min(pos + 1, S_c) slots."""
    qd = q.double()[:, 0]
    b, h, hd = qd.shape
    kv = cache["k"].shape[2]
    kd = cache["k"].double() * cache["ks"].double()[..., None]
    vd = cache["v"].double() * cache["vs"].double()[..., None]
    qg = qd.reshape(b, kv, h // kv, hd)
    s = torch.einsum("bhgk,bshk->bhgs", qg, kd) * hd ** -0.5
    s_c = kd.shape[1]
    valid = torch.arange(s_c, device=q.device)[None] < torch.clamp(
        pos + 1, max=s_c)[:, None]
    s = torch.where(valid[:, None, None], s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, -1)
    return torch.einsum("bhgs,bshk->bhgk", p, vd).reshape(b, 1, h, hd)


def _clone(cache):
    return {k: t.clone() for k, t in cache.items()}


@pytest.mark.parametrize("case", KV8_CASES,
                         ids=lambda c: "x".join(map(str, c[:5])))
def test_kv8_decode_matches_plain(cuda, case):
    """K7a's codes and scales, so the whole cache, equal the plain
    version's bit for bit. K7b's output is no less precise than the plain
    version's: both against float64 attention over the cache's exact
    values, the kernel's largest error over the output's scale at most
    the plain version's plus 2^-9 (bf16; 1e-6 float32). The plain route
    rounds each dequantized value, each score and each probability to bf16
    (relative 2^-9 each), the kernel only its output; its own error is at
    most 2^-8 of the scale in bf16 (one rounding of the output plus float32
    sums) and 1e-5 in float32."""
    from repro_torch.kernels.attention import ops as aops

    cache, q, k_new, v_new, pos, live = _kv8_inputs(case, cuda)
    plain_cache, kern_cache = _clone(cache), _clone(cache)
    want = aops.kv8_decode_plain(q, k_new, v_new, plain_cache, pos, live)
    got = aops.kv8_decode(q, k_new, v_new, kern_cache, pos, live)
    torch.cuda.synchronize()
    for key in ("k", "v"):
        assert torch.equal(kern_cache[key], plain_cache[key]), key
    for key in ("ks", "vs"):
        assert _same_bits(kern_cache[key], plain_cache[key]), key
    assert got.dtype == q.dtype and got.shape == q.shape
    exact = _kv8_exact(q, plain_cache, pos)
    scale = float(exact.abs().max())
    err_k = float((got.double() - exact).abs().max()) / scale
    err_p = float((want.double() - exact).abs().max()) / scale
    bf16 = q.dtype == torch.bfloat16
    assert err_k <= (2 ** -8 if bf16 else 1e-5), (err_k, err_p)
    assert err_k <= err_p + (2 ** -9 if bf16 else 1e-6), (err_k, err_p)


def test_kv8_decode_counts_its_launches(cuda):
    """One ``kv8_append`` and one ``kv8_attend`` a call; the attend is two
    device kernels (the splits and their combine), the append one."""
    from repro_torch.kernels.attention import ops as aops

    cache, q, k_new, v_new, pos, live = _kv8_inputs(KV8_CASES[0], cuda)
    with qops.count_launches() as box:
        aops.kv8_decode(q, k_new, v_new, cache, pos, live)
        aops.kv8_decode(q, k_new, v_new, cache, pos, None)
    assert {k: v for k, v in box.counts.items() if v} == {
        "kv8_append": 2, "kv8_attend": 2}
    kernels = _device_kernels(
        lambda: aops.kv8_decode(q, k_new, v_new, cache, pos, live))
    assert sorted(kernels.values()) == [1, 1, 1], kernels


@pytest.mark.parametrize("case", [KV8_CASES[0], KV8_CASES[2], KV8_CASES[5]],
                         ids=lambda c: "x".join(map(str, c[:5])))
def test_kv8_decode_is_batch_invariant(cuda, case):
    """A row's output and cache rows are bitwise the same whatever the
    other rows hold and however long they are."""
    from repro_torch.kernels.attention import ops as aops

    cache, q, k_new, v_new, pos, live = _kv8_inputs(case, cuda)
    other = _kv8_inputs(case, cuda, seed=1)
    row = 0 if case[0] == 32 else case[0] - 1
    mixed = _clone(other[0])
    for key in cache:
        mixed[key][row] = cache[key][row]
    q2, k2, v2 = other[1].clone(), other[2].clone(), other[3].clone()
    for t, src in ((q2, q), (k2, k_new), (v2, v_new)):
        t[row] = src[row]
    pos2 = torch.flip(pos, [0]).clone()
    pos2[row] = pos[row]
    live2 = live.clone()
    live2[:] = True
    live2[row] = live[row]
    a = aops.kv8_decode(q, k_new, v_new, cache, pos, live)
    b = aops.kv8_decode(q2, k2, v2, mixed, pos2, live2)
    torch.cuda.synchronize()
    assert torch.equal(a[row].view(torch.int8), b[row].view(torch.int8))
    for key in cache:
        assert torch.equal(cache[key][row].view(torch.int8),
                           mixed[key][row].view(torch.int8)), key


def test_kv8_decode_rejects_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.attention import ops as aops

    cache, q, k_new, v_new, pos, live = _kv8_inputs(KV8_CASES[5], cuda)
    bad = [
        (q.half(), k_new.half(), v_new.half(), cache, pos, live),
        (q, k_new, v_new, dict(cache, k=cache["k"].transpose(1, 2)), pos,
         live),
        (q, k_new, v_new, dict(cache, ks=cache["ks"].double()), pos, live),
        (q, k_new, v_new, cache, pos.int(), live),
        (q, k_new, v_new, cache, pos, live.int()),
        (q.transpose(0, 1), k_new, v_new, cache, pos, live),
    ]
    for args in bad:
        with pytest.raises(ValueError, match="kv8_decode"):
            aops.kv8_decode(*args)
