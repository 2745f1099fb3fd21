"""Parity of the port's CNN testbed with the reference models.

With the reference's parameters bridged into the port, ``run_head`` and
``run_tail`` agree at every decoupling point of reduced VGG16 and
ResNet-50. Tolerance: both sides are float32 on the CPU, but XLA and
PyTorch sum the convolutions in different orders (~1e-7 relative per
layer), so outputs are compared within 2e-5 of each tensor's largest
magnitude. Layer names, FMACs and boundary sizes match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models.api import batch_to, build_model  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.cnn import _same_pad  # noqa: E402

from conftest import reduced_model  # noqa: E402

RTOL = 2e-5


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("arch", ("vgg16", "resnet50"))
def test_heads_and_tails_match_at_every_point(arch):
    jmodel, jparams = reduced_model(arch)
    cfg = get_config(arch).reduced()
    assert repr(cfg) == repr(jmodel.cfg)   # the table cache key uses it
    model = build_model(cfg)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    names = model.decoupling_points()
    assert names == jmodel.decoupling_points()
    assert model.per_point_fmacs(4) == jmodel.per_point_fmacs(4)
    assert model.boundary_bytes(4) == jmodel.boundary_bytes(4)

    batch = make_batch(cfg, 2, 64, seed=3)
    jbatch = jmake_batch(jmodel.cfg, 2, 64, seed=3)
    np.testing.assert_array_equal(batch["images"], jbatch["images"])
    tb = batch_to(batch, "cpu")
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}

    pts = list(range(len(names)))
    jheads = jmodel.run_heads(jparams, jb, pts)
    with torch.no_grad():
        theads = model.run_heads(params, tb, pts)
        _close(model.forward(params, tb), jmodel.forward(jparams, jb))
        for p, (jh, _), (th, _) in zip(pts, jheads, theads):
            _close(th, jh)
            _close(model.run_head(params, tb, p), jh)
            # The tail from the reference's own boundary, so each point's
            # comparison starts from identical inputs.
            _close(model.run_tail(params, torch.from_numpy(np.array(jh)),
                                  p),
                   jmodel.run_tail(jparams, jh, p))


def test_same_padding_of_the_stem_is_asymmetric():
    assert _same_pad(224, 7, 2) == (2, 3)
    assert _same_pad(32, 7, 2) == (2, 3)
    assert _same_pad(56, 3, 1) == (1, 1)
    assert _same_pad(56, 1, 2) == (0, 0)


def test_param_specs_match_reference_shapes():
    from repro.models.api import build_model as jbuild
    from repro.config import get_config as jget_config

    for arch in ("vgg16", "vgg19", "resnet50", "resnet101"):
        jm = jbuild(jget_config(arch))
        tm = build_model(get_config(arch))
        jshapes = jax.tree.map(lambda s: s.shape, jm.specs,
                               is_leaf=lambda s: hasattr(s, "logical"))
        tshapes = {k: {n: s.shape for n, s in v.items()}
                   for k, v in tm.specs.items()}
        assert tshapes == jshapes
        assert tm.param_count() == jm.param_count()


def test_port_init_is_seeded_and_fan_in_scaled():
    model = build_model(get_config("resnet50").reduced())
    a = model.init(0, "cpu")
    b = model.init(0, "cpu")
    c = model.init(1, "cpu")
    w = a["stem"]["w"]
    assert torch.equal(w, b["stem"]["w"]) and not torch.equal(w, c["stem"]["w"])
    std = 1.0 / np.sqrt(np.prod(w.shape[:-1]))
    assert float(w.abs().max()) <= 2 * std + 1e-12
    assert float(a["stem"]["b"].abs().max()) == 0.0
