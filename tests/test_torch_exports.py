"""The port's public names against the reference's: every subpackage's
``__all__`` is the reference's (the one exception: the reference's TPU
profile ``TPU_V5E*`` in ``config``, where the port has the H100's
``H100*``), and the helpers the reference's benchmarks call
(``kernels.quantize`` ``dequantize_unpack`` and
``quantize_dequantize_kernel``, ``PredictorTables.drops`` / ``sizes``)
give the reference's values on the CPU: the decodes bit for bit against
the jitted reference (interpret mode), the tables' views equal."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import predictor as jpredictor  # noqa: E402
from repro.kernels.quantize import ops as jops  # noqa: E402
from repro_torch.core import predictor as tpredictor  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402

SUBPACKAGES = ["checkpoint", "codec", "config", "data", "kernels.entropy",
               "kernels.quantize", "models", "optim", "serving", "sharding",
               "training", "utils"]
# The one stated exception: the accelerator profile of each package.
PROFILE = {"repro": "TPU_V5E", "repro_torch": "H100"}
BITS = (2, 4, 5, 8, 16)
SHAPE = (3, 5, 7)


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_match_reference(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    assert len(set(port.__all__)) == len(port.__all__)
    want = {n for n in ref.__all__ if not n.startswith(PROFILE["repro"])}
    got = {n for n in port.__all__ if not n.startswith(PROFILE["repro_torch"])}
    assert got == want
    for n in port.__all__:
        assert getattr(port, n) is not None
    if name == "config":
        assert {n for n in port.__all__ if n.startswith("H100")} == {
            "H100", "H100_HBM_BW", "H100_HBM_BYTES", "H100_NVLINK_BW"}


def _features(seed):
    x = np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0
    return x


@pytest.mark.parametrize("out", ("float32", "bfloat16"))
@pytest.mark.parametrize("bits", BITS)
def test_dequantize_unpack_inverts_quantize_pack(bits, out):
    x = _features(bits)
    jdt = jnp.float32 if out == "float32" else jnp.bfloat16
    tdt = torch.float32 if out == "float32" else torch.bfloat16
    jc, jmn, jmx = jops.quantize_pack(jnp.asarray(x), bits, interpret=True)
    want = jops.dequantize_unpack(jc, jmn, jmx, bits, SHAPE, interpret=True,
                                  out_dtype=jdt)
    codes, mn, mx = qops.quantize_pack(torch.from_numpy(x), bits)
    with qops.count_launches() as box:
        got = qops.dequantize_unpack(codes, mn, mx, bits, SHAPE,
                                     out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert box.counts["fused_decode"] == 0         # the CPU's plain version


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("bits", BITS)
def test_quantize_dequantize_kernel_matches_reference(bits, dtype):
    x = _features(10 + bits)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jops.quantize_dequantize_kernel(jnp.asarray(x, jdt), bits,
                                           interpret=True)
    got = qops.quantize_dequantize_kernel(torch.from_numpy(x).to(tdt), bits)
    assert got.dtype == tdt and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_predictor_table_views_match_reference():
    rng = np.random.default_rng(3)
    kw = dict(points=["a", "b", "c"], bits_choices=[2, 4],
              codecs=["huffman", "bitpack", "perchannel"],
              acc_drop=rng.random((3, 2, 3)),
              size_bytes=rng.random((3, 2, 3)) * 1e4, base_accuracy=0.5)
    port = tpredictor.PredictorTables(**kw)
    ref = jpredictor.PredictorTables(**kw)
    for codec in (None, "huffman", "bitpack", "perchannel"):
        np.testing.assert_array_equal(port.drops(codec), ref.drops(codec))
        np.testing.assert_array_equal(port.sizes(codec), ref.sizes(codec))
    assert port.drops("bitpack").shape == (3, 2)
    with pytest.raises(ValueError):
        port.sizes("png")
