"""Activation sharding constraints from logical axis names.

Sharding propagation alone can lose the batch ("data") sharding of
activations in a deep graph and replicate the whole batch on every
device. Explicit constraints on the layer-boundary activations pin the
intended layout, as the reference's ``with_sharding_constraint`` does.

``constrain`` is the identity (``constrain(x, ...) is x``) on a plain
tensor, the counterpart of the reference's no-op outside ``with mesh:``,
so model code calls it unconditionally; on a ``DTensor`` it
redistributes to the placements the rule table resolves on the tensor's
own mesh. :func:`on_batch_shard` runs a layer as a local op on each
rank's batch shard, for ops whose DTensor rule does not fit the rule
table's layout (a convolution's expects a width-sharded input and a
replicated weight; the table shards ``conv_out``). :func:`like_layout`
and :func:`shard_range` serve in-place writes into a sharded decode
cache, which DTensor refuses when the written value's placements differ
(``aten.copy_``) or at all (``aten.index_put_``): the value takes the
cache's layout, or the write runs on each rank's local shard.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.sharding.rules import placements, resolve_spec
from repro_torch.utils.tree import tree_map


def _dtensor_module(x):
    """``torch.distributed.tensor`` when ``x`` is a DTensor, else None. No
    DTensor exists before that module is imported, so the plain path
    never pays its import (~1 s)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod if mod is not None and isinstance(x, mod.DTensor) else None


def constrain(x, logical: Sequence[Optional[str]]):
    """Pin ``x`` to the layout the rule table resolves for ``logical``."""
    if _dtensor_module(x) is None:
        return x
    mesh = x.device_mesh
    want = placements(resolve_spec(tuple(x.shape), logical, mesh), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def on_batch_shard(fn: Callable[..., Any], params, x, *rest):
    """``fn(params, x, *rest)``; for a DTensor ``x`` (its batch dim alone
    left split), run as a local op on each rank's batch shard: every
    DTensor leaf of ``params`` (a tree) gathered whole at use (the stored
    parameters stay sharded), every DTensor leaf of ``rest`` (trees of
    batch-major tensors, such as a recurrent state) laid out as ``x``. The
    result (a tensor, or (named) tuples of batch-major tensors and plain
    values) is sharded as ``x``."""
    mod = _dtensor_module(x)
    if mod is None:
        return fn(params, x, *rest)
    mesh = x.device_mesh
    # Only the batch stays split: a partial sum is reduced and any other
    # split dim gathered first, so each rank's shard holds whole rows.
    rows = [p if p.is_shard() and p.dim == 0 else mod.Replicate()
            for p in x.placements]

    def laid(t, want, grad=None):
        if not isinstance(t, mod.DTensor):
            return t
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return local_view(t, grad)

    # A gathered parameter's gradient on a rank covers its rows alone: a
    # partial sum over the mesh dims the batch is split on.
    partial = [mod.Partial() if p.is_shard() else mod.Replicate()
               for p in rows]
    whole = tree_map(lambda v: laid(v, [mod.Replicate()] * mesh.ndim,
                                    partial), params)
    out = fn(whole, laid(x, rows), *[tree_map(lambda v: laid(v, rows), r)
                                     for r in rest])

    def wrap(y):
        if isinstance(y, torch.Tensor):
            return mod.DTensor.from_local(y, mesh, rows, run_check=False)
        if isinstance(y, tuple):
            vals = [wrap(v) for v in y]
            return type(y)(*vals) if hasattr(y, "_fields") else tuple(vals)
        return y

    return wrap(out)


def local_view(x, grad_placements=None):
    """A DTensor's local tensor, waited on: a redistribution's result is an
    ``AsyncCollectiveTensor``, and a local computation that mixes one into
    its autograd graph hands a DTensor gradient back to ``to_local``.
    ``grad_placements``: the placements of the local tensor's gradient
    (default: ``x``'s own)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    loc = x.to_local(grad_placements=grad_placements)
    return loc.wait() if isinstance(loc, AsyncCollectiveTensor) else loc


def gather_dim(x, dim: int):
    """``x`` with ``dim`` whole on every rank (its other dims as they
    were), for an op whose DTensor rule fails on that dim sharded."""
    mod = _dtensor_module(x)
    if mod is None:
        return x
    dim = dim % x.ndim
    want = [mod.Replicate() if p.is_shard() and p.dim == dim else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def like_layout(x, like):
    """``x`` redistributed to ``like``'s placements when ``like`` is a
    DTensor (the value an in-place ``copy_`` writes must have the
    destination's), else ``x``."""
    if _dtensor_module(like) is None or tuple(x.placements) == \
            tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def shard_range(x, dim: int):
    """``(offset, length)`` of this rank's local shard of DTensor ``x``
    along ``dim``: the dim may be split over several mesh dims, major to
    minor in mesh order."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    n, idx = 1, 0
    for j, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            n *= mesh.size(j)
            idx = idx * mesh.size(j) + coord[j]
    size = x.shape[dim] // n
    return idx * size, size
