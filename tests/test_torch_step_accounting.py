"""Parity of the port's step accounting with the reference's: the input
shapes (``ShapeConfig`` / ``INPUT_SHAPES``), ``Model.cache_len_for``,
``enc_len_for``, ``input_specs``, ``batch_logical_axes``,
``cache_logical_axes``, ``model_flops`` and ``analytic_step_flops``, for
every registered arch at full size (no parameter is drawn: the reference
builds its specs with ``jax.eval_shape``, the port on ``meta``) and every
input shape. The FLOP counts are float arithmetic in the same order, so
they must agree bit for bit.

One difference is by design and named where it is checked: a shared
``'A'`` segment's decode cache has a leading layer axis of 1 in the port
(its ``init_caches`` stacks every segment), where the reference's entry is
unstacked; its logical axes carry ``"layers"`` in front accordingly.

The reference's own behavioural tests of ``tests/test_flops_memory.py``
(the 6ND band, the MoE and decode ratios) run as cases against the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import list_archs as jlist_archs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro_torch.config import INPUT_SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_path  # noqa: E402

# The reference's archs: the port-only ones have nothing to match.
ARCHS = jlist_archs()


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _axes_leaves(tree, path=()):
    """(path, axes tuple) pairs in jax's flatten order (dict keys sorted),
    an axes tuple being a leaf."""
    if _is_axes(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _axes_leaves(tree[k], path + (k,))]
    return [leaf for i, v in enumerate(tree)
            for leaf in _axes_leaves(v, path + (i,))]


def _shared_segments(cfg):
    """Indices of the shared 'A' segments of the decode caches."""
    return {i for i, seg in enumerate(tf.segment_plan(cfg)) if seg.shared}


@pytest.fixture(scope="module")
def models():
    return {a: (build_model(get_config(a)), jbuild_model(jget_config(a)))
            for a in ARCHS}


def test_input_shapes_field_for_field():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, js in J_SHAPES.items():
        ps = INPUT_SHAPES[name]
        assert isinstance(ps, ShapeConfig)
        assert (ps.name, ps.seq_len, ps.global_batch, ps.mode) == \
            (js.name, js.seq_len, js.global_batch, js.mode)
    assert [f.name for f in __import__("dataclasses").fields(ShapeConfig)] \
        == ["name", "seq_len", "global_batch", "mode"]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_axes_match_reference(models, arch):
    """``cache_len_for`` / ``enc_len_for``, ``input_specs`` leaf for leaf
    (shape and dtype, jax's flatten order), ``batch_logical_axes`` and
    ``cache_logical_axes`` for all four shapes."""
    pm, jm = models[arch]
    cfg = pm.cfg
    shared = _shared_segments(cfg) if pm.is_lm else set()
    for name, shape in INPUT_SHAPES.items():
        js = J_SHAPES[name]
        assert pm.cache_len_for(shape.seq_len) == \
            jm.cache_len_for(js.seq_len)
        assert pm.enc_len_for(shape.seq_len) == jm.enc_len_for(js.seq_len)
        jspecs = jm.input_specs(js)
        pspecs = pm.input_specs(shape)
        jl = jax.tree_util.tree_flatten_with_path(jspecs)[0]
        pl = tree_flatten_with_path(pspecs)
        assert len(jl) == len(pl), (name, len(jl), len(pl))
        for (jp, ja), (pp, pa) in zip(jl, pl):
            assert pa.device.type == "meta"
            assert str(pa.dtype).split(".")[-1] == str(ja.dtype), (jp, pp)
            want = tuple(ja.shape)
            if pp[:2] and pp[0] == ("key", "caches") and \
                    pp[1][1] in shared:
                want = (1,) + want     # the port's stacked shared cache
            assert tuple(pa.shape) == want, (name, jp, pp)
        jax_axes = _axes_leaves(jm.batch_logical_axes(js))
        p_axes = _axes_leaves(pm.batch_logical_axes(shape))
        assert len(jax_axes) == len(p_axes) == len(pl)
        for (jp, ja), (pp, pa) in zip(jax_axes, p_axes):
            if pp[:2] and pp[0] == "caches" and pp[1] in shared:
                ja = ("layers",) + ja
            assert (jp, ja) == (pp, pa)
    if pm.is_lm:
        jc = _axes_leaves(jtf.cache_logical_axes(jget_config(arch)))
        pc = _axes_leaves(tf.cache_logical_axes(cfg))
        assert [(p, ("layers",) + a if p[0] in shared else a)
                for p, a in jc] == pc


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_bitwise(models, arch):
    """``model_flops`` and ``analytic_step_flops`` (every shape, train
    with and without ``block_remat``) equal the reference's as floats."""
    pm, jm = models[arch]
    for name, shape in INPUT_SHAPES.items():
        js = J_SHAPES[name]
        for remat in (False, True):
            pf = pm.analytic_step_flops(shape, block_remat=remat)
            jf = jm.analytic_step_flops(js, block_remat=remat)
            assert isinstance(pf, float)
            assert pf.hex() == float(jf).hex(), (name, remat, pf, jf)
        for tokens in (shape.global_batch,
                       shape.global_batch * shape.seq_len):
            assert pm.model_flops(tokens).hex() == \
                float(jm.model_flops(tokens)).hex()
    assert pm.active_param_count() == jm.active_param_count()


# ---- the reference's tests/test_flops_memory.py, against the port --------


def test_dense_train_flops_close_to_6nd():
    model = build_model(get_config("yi-6b"))
    shape = INPUT_SHAPES["train_4k"]
    tokens = shape.global_batch * shape.seq_len
    analytic = model.analytic_step_flops(shape)
    six_nd = 6.0 * model.param_count() * tokens
    # analytic includes attention quadratic + logits; 6ND includes embeds.
    assert 0.8 * six_nd < analytic < 1.6 * six_nd


def test_moe_flops_use_active_params():
    model = build_model(get_config("llama4-maverick-400b-a17b"))
    assert model.active_param_count() < 0.2 * model.param_count()
    shape = INPUT_SHAPES["train_4k"]
    analytic = model.analytic_step_flops(shape)
    six_nd_total = (6.0 * model.param_count() * shape.global_batch
                    * shape.seq_len)
    assert analytic < 0.5 * six_nd_total     # far below dense-equivalent


def test_decode_flops_tiny_vs_prefill():
    model = build_model(get_config("qwen3-8b"))
    dec = model.analytic_step_flops(INPUT_SHAPES["decode_32k"])
    pre = model.analytic_step_flops(INPUT_SHAPES["prefill_32k"])
    assert dec < pre / 100


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-6b", "qwen3-8b",
                                  "granite-34b"])
def test_remat_adds_one_forward(arch):
    """Per-block remat recomputes the forward once: 4/3 of the train
    count, and the prefill count is the forward alone."""
    model = build_model(get_config(arch))
    shape = INPUT_SHAPES["train_4k"]
    plain = model.analytic_step_flops(shape)
    remat = model.analytic_step_flops(shape, block_remat=True)
    assert remat == pytest.approx(plain * 4.0 / 3.0, rel=1e-12)
    fwd = model.analytic_step_flops(ShapeConfig("fwd", shape.seq_len,
                                                shape.global_batch,
                                                "prefill"))
    assert plain == pytest.approx(3.0 * fwd, rel=1e-12)
    assert np.isfinite(plain) and plain > 0
