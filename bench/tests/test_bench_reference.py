"""The plain references and counts against the port's plain (CPU) path at
reduced sizes: the same weights, float32."""
import numpy as np
import pytest
import torch

from bench.counts import codec as codec_counts
from bench.reference import olmo, quant, resnet
from bench.weights import draw, same_layout

torch.set_num_threads(2)
api = pytest.importorskip("repro_torch.models.api")
from repro_torch.config import get_config  # noqa: E402
from repro_torch.config.types import ShapeConfig  # noqa: E402

RESNET = {"image_size": 32, "num_classes": 10, "stem_width": 64,
          "stem_kernel": 7, "stages": [3, 4, 6, 3],
          "widths": [64, 128, 256, 512], "expansion": 4}
OLMO = {"num_layers": 3, "d_model": 128, "num_heads": 2, "num_kv_heads": 2,
        "d_ff": 256, "vocab_size": 300, "rope_theta": 10000.0}


def port_resnet(cfg=RESNET):
    return api.build_model(get_config("resnet50").replace(
        image_size=cfg["image_size"], num_classes=cfg["num_classes"]))


def port_olmo(dtype="float32", cfg=OLMO):
    return api.build_model(get_config("olmo-1b").replace(
        dtype=dtype, param_dtype=dtype, **cfg))


def test_resnet_matches_the_port():
    model = port_resnet()
    params = draw(resnet.layout(RESNET), 7, "cpu", torch.float32)
    assert same_layout(params, model.abstract_params())
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    want = model.forward(params, {"images": x})
    got = resnet.forward(RESNET, params, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(
        want.abs().max()))
    for point in (1, 7, 17):
        head = model.run_head(params, {"images": x}, point)
        torch.testing.assert_close(resnet.forward(RESNET, params, x, 0,
                                                  point + 1), head)
        assert tuple(head.shape) == resnet.boundary_shape(RESNET, point, 2)
        tail = model.run_tail(params, head, point)
        torch.testing.assert_close(resnet.forward(RESNET, params, head,
                                                  point + 1), tail)


def test_resnet_flops_are_the_ports():
    full = dict(RESNET, image_size=224, num_classes=1000)
    assert resnet.flops_per_image(full) == port_resnet(full).model_flops(1)


def test_olmo_matches_the_port():
    model = port_olmo()
    params = draw(olmo.layout(OLMO), 3, "cpu", torch.float32)
    assert same_layout(params, model.abstract_params())
    toks = torch.randint(0, 300, (1, 24), generator=torch.Generator()
                         .manual_seed(2))
    want = model.forward(params, {"tokens": toks})[0]
    got = olmo.forward(OLMO, params, toks[0])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(
        want.abs().max()))


@pytest.mark.parametrize("s", [16, 300])
def test_decoder_flops_are_the_ports(s):
    model = port_olmo(cfg=dict(OLMO, num_layers=16))
    shape = ShapeConfig(name="p", seq_len=s, global_batch=1, mode="prefill")
    assert olmo.prefill_flops(dict(OLMO, num_layers=16), s) == \
        model.analytic_step_flops(shape)
    dshape = ShapeConfig(name="d", seq_len=s, global_batch=1, mode="decode")
    assert olmo.decode_flops(dict(OLMO, num_layers=16),
                             model.cache_len_for(s)) == \
        model.analytic_step_flops(dshape)


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("shape,codec", [((2, 8, 5, 5), "bitpack"),
                                         ((2, 8, 5, 5), "perchannel"),
                                         ((3, 40), "perchannel")])
def test_wire_values_and_bytes_are_the_ports(bits, shape, codec):
    from repro_torch.codec import get_codec

    x = torch.randn(shape, generator=torch.Generator().manual_seed(bits))
    c = get_codec(codec)
    blob = c.encode(x, bits)
    got = c.decode(blob, out_dtype=torch.float32, device="cpu")
    want = quant.codec_qdq(x, bits, codec)
    step = float(x.max() - x.min()) / ((1 << bits) - 1)
    assert float((got - want).abs().max()) <= 1e-6 * max(step, 1.0)
    assert len(blob.payload) == codec_counts.payload_bytes(codec, shape, bits)
    assert 8 * np.size(blob.x_min) == codec_counts.header_bytes(codec, shape)


def test_int8_rows_are_the_ports():
    from repro_torch.models.layers import attention

    x = torch.randn(4, 7, 2, 16, generator=torch.Generator().manual_seed(0))
    q, s = attention.quantize_kv_row(x)
    want = attention.dequantize_kv(q, s, torch.float32)
    torch.testing.assert_close(quant.int8_row_qdq(x), want, rtol=0,
                               atol=1e-6)


def test_served_stream_path_matches_the_session():
    """The reference's served path (a cut, 8-bit boundary rows, int8 tail
    KV) against the port's token stream in float32: every served token is
    the reference's best, within rounding."""
    from repro_torch.config import ServeConfig
    from repro_torch.core.decoupler import DecoupledPlan, DecoupledRunner
    from repro_torch.serving.scheduler import GenRequest

    model = port_olmo()
    params = draw(olmo.layout(OLMO), 4, "cpu", torch.float32,
                  embed_std=0.02)
    plan = DecoupledPlan(1, 8, 0.0, 0.0, 0.0, "bitpack")
    sess = DecoupledRunner(model, params, plan).stream_session(
        ServeConfig(max_batch=2, max_seq_len=40), cloud_kv_bits=8)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(uid=i, tokens=rng.integers(1, 300, size=n)
                       .astype(np.int32), max_new_tokens=12)
            for i, n in enumerate((9, 17))]
    for r in reqs:
        sess.submit(r)
    sess.run()
    for r in reqs:
        seq = torch.as_tensor(np.concatenate([r.tokens, r.out_tokens[:-1]]))
        lg = olmo.forward(OLMO, params, seq, point=1, prompt=len(r.tokens),
                          bits=8, int8_kv=True)[len(r.tokens) - 1:]
        got = lg.gather(1, torch.as_tensor(r.out_tokens)[:, None])[:, 0]
        gap = (lg.max(-1).values - got) / lg.std(-1)
        assert float(gap.max()) < 1e-3


@pytest.mark.parametrize("codec", ["bitpack", "perchannel"])
@pytest.mark.parametrize("bits", [2, 8])
def test_wire_bounds_take_both_sides_of_an_edge_alone(bits, codec):
    """A code at a rounding edge may fall on either side in a sound
    program; a code away from an edge, or moved by more than one step,
    may not."""
    gen = torch.Generator().manual_seed(bits)
    x = torch.randn(16, 40, generator=gen)
    i = int(x[:, 0].argsort()[8])          # neither the least nor the most
    dims = None if codec == "bitpack" else (0,)
    mn = x.amin() if dims is None else x.amin(dim=0, keepdim=True)
    mx = x.amax() if dims is None else x.amax(dim=0, keepdim=True)
    levels = (1 << bits) - 1
    # Element (i, 0) one ulp below the edge between codes 0 and 1.
    edge = (mn + 0.5 * (mx - mn) / levels).reshape(-1)[0]
    x[i, 0] = torch.nextafter(edge, edge - 1)
    lo, hi = quant.codec_qdq_bounds(x, bits, codec, 1e-4)
    mid = quant.codec_qdq(x, bits, codec)
    assert bool((lo <= mid).all() and (mid <= hi).all())
    step = (mx - mn).reshape(-1)[0] / levels
    assert float(hi[i, 0] - lo[i, 0]) == pytest.approx(float(step), rel=1e-5)
    # Others fall within 1e-4 of an edge by chance alone: a few at most.
    assert bool(hi[i, 0] != lo[i, 0]) and int((hi != lo).sum()) <= 4
    strict_lo, strict_hi = quant.codec_qdq_bounds(x, bits, codec, 0.0)
    torch.testing.assert_close(strict_lo, mid, rtol=0, atol=0)
    moved = mid.clone()
    moved[(i + 1) % 16, 1] += step
    assert float((moved - hi).max()) > 0.5 * float(step)
