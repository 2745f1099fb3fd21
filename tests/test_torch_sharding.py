"""Parity of the port's sharding rules (``sharding/rules.py``,
``sharding/activation.py``), ``MeshConfig`` and the abstract parameter
trees with the reference's.

``resolve_spec`` must give the reference's spec for every parameter leaf
of every registered config on every mesh of ``MESHES``: the reference
reads only a mesh's ``axis_names`` and ``devices.shape``, so it gets a
stand-in whose devices are an empty object array of the mesh's shape, and
the port the ``MeshConfig`` of the same axes. Specs are compared as one
entry a tensor dim (the reference trims trailing replicated dims and
writes a single axis bare). None of this needs a process group.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Several test workers share the host: cap this worker's intra-op
# threads, or the OpenMP pools of all of them spin against each other.
torch.set_num_threads(2)

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import list_archs as jlist_archs  # noqa: E402
from repro.config import types as jtypes  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.config import (  # noqa: E402
    MULTI_POD_MESH,
    SINGLE_POD_MESH,
    MeshConfig,
    get_config,
)
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.activation import constrain, on_batch_shard  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 2), ("data", "model"))]


def _ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, object))


def _ref_entries(pspec, ndim):
    """A reference PartitionSpec as one entry a dim: None or a tuple."""
    out = [None if a is None else (a,) if isinstance(a, str) else tuple(a)
           for a in tuple(pspec)]
    return tuple(out + [None] * (ndim - len(out)))


def _pairs(port, ref, path=""):
    """(path, port ParamSpec, reference ParamSpec) for every leaf."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, port, ref


@pytest.mark.parametrize("arch", jlist_archs())
def test_resolve_spec_matches_reference_on_every_leaf(arch):
    port = build_model(get_config(arch)).specs
    ref = jbuild_model(jget_config(arch)).specs
    leaves = list(_pairs(port, ref))
    assert leaves
    for shape, names in MESHES:
        jmesh = _ref_mesh(shape, names)
        mesh = MeshConfig(shape, names)
        for path, p, r in leaves:
            assert (p.shape, p.logical) == (tuple(r.shape), tuple(r.logical))
            want = _ref_entries(jrules.resolve_spec(r.shape, r.logical, jmesh),
                                len(p.shape))
            got = rules.resolve_spec(p.shape, p.logical, mesh)
            assert got == want, (path, shape, got, want)
            # The same answer from a plain {axis: size} mapping.
            assert rules.resolve_spec(p.shape, p.logical,
                                      dict(zip(names, shape))) == got


def test_rule_table_is_the_reference_s():
    assert rules.DEFAULT_RULES == jrules.DEFAULT_RULES
    assert rules.PRIORITY == jrules.PRIORITY


def test_placements_on_multi_axis_dims():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 4, "model": 2}
    # A dim split over ("data", "model") shards on both mesh dims, in mesh
    # order; a batch over ("pod", "data") likewise.
    assert rules.placements(((("data", "model")), None), mesh) == [
        Replicate(), Shard(0), Shard(0)]
    assert rules.placements((("pod", "data"), None, ("model",)), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert rules.placements((None, None), mesh) == [Replicate()] * 3
    # A mesh axis of size 1 stays replicated: its one shard is the tensor.
    one = {"data": 1, "model": 2}
    assert rules.placements((("data", "model"),), one) == [
        Replicate(), Shard(0)]
    # Axes out of the mesh's order cannot be written as placements.
    with pytest.raises(ValueError, match="order"):
        rules.placements((("model", "data"),), mesh)
    # Resolved end to end: the (FSDP + TP) ffn weight of a (2, 4) mesh.
    spec = rules.resolve_spec((64, 256), ("embed", "ffn"),
                              MeshConfig((2, 4), ("data", "model")))
    assert spec == (None, ("data", "model"))
    assert rules.placements(spec, {"data": 2, "model": 4}) == [Shard(1),
                                                               Shard(1)]


def test_shardings_for_specs_walks_the_tree():
    from torch.distributed.tensor import Replicate, Shard

    model = build_model(get_config("granite-34b").reduced())
    mesh = {"data": 2, "model": 2}
    tree = rules.shardings_for_specs(model.abstract_params(),
                                     model.param_logical_axes(), mesh)
    for path, p, pl in _pairs(model.specs, tree):
        want = rules.placements(rules.resolve_spec(p.shape, p.logical, mesh),
                                mesh)
        assert pl == want, path
    assert tree["embed"] == [Shard(0), Shard(0)]     # vocab on both
    assert tree["final_norm"]["scale"] == [Replicate(), Replicate()]


def test_constrain_is_the_identity_on_a_plain_tensor():
    x = torch.ones(4, 3, 8)
    assert constrain(x, ("batch", "seq", "embed")) is x
    assert constrain(x, (None, None, None)) is x
    seen = []

    def fn(params, v):
        seen.append(params)
        return v * params["w"]

    w = torch.full((8,), 2.0)
    assert torch.equal(on_batch_shard(fn, {"w": w}, x), x * 2.0)
    assert seen[0]["w"] is w


def test_mesh_config_fields():
    for port, ref in ((SINGLE_POD_MESH, jtypes.SINGLE_POD_MESH),
                      (MULTI_POD_MESH, jtypes.MULTI_POD_MESH),
                      (MeshConfig(), jtypes.MeshConfig())):
        assert (port.shape, port.axis_names, port.num_devices) == \
            (ref.shape, ref.axis_names, ref.num_devices)
    assert SINGLE_POD_MESH.num_devices == 256
    assert MULTI_POD_MESH.num_devices == 512
    assert rules.mesh_axes(MULTI_POD_MESH) == {"pod": 2, "data": 16,
                                               "model": 16}


@pytest.mark.parametrize("arch", ["granite-34b", "resnet50", "qwen2-vl-7b"])
def test_abstract_params_and_logical_axes(arch):
    import jax

    model = build_model(get_config(arch).reduced())
    ref = jbuild_model(jget_config(arch).reduced())
    abstract = model.abstract_params()
    logical = model.param_logical_axes()
    jabs = ref.abstract_params()
    jlog = ref.param_logical_axes()
    for path, p, r in _pairs(abstract, jabs):
        assert p.device.type == "meta", path
        assert tuple(p.shape) == tuple(r.shape), path
        assert str(p.dtype).split(".")[1] == str(r.dtype), path
    jleaves = jax.tree.leaves(jlog, is_leaf=lambda t: isinstance(t, tuple))
    assert rules_leaves(logical) == [tuple(t) for t in jleaves]
    for ndim in (2, 3, 4):
        assert model.boundary_logical_axes(ndim) == \
            ref.boundary_logical_axes(ndim)


def rules_leaves(tree):
    """Leaves of a logical-axes tree in jax's flatten order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in rules_leaves(tree[k])]
    if isinstance(tree, list):
        return [v for t in tree for v in rules_leaves(t)]
    return [tree]
