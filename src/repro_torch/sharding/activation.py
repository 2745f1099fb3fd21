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
replicated weight; the table shards ``conv_out``).
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Optional, Sequence

from repro_torch.sharding.rules import placements, resolve_spec


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


def on_batch_shard(fn: Callable[[Any, Any], Any], params, x):
    """``fn(params, x)``; for a DTensor ``x`` sharded on its batch dim
    alone, run as a local op on each rank's batch shard with every
    DTensor leaf of ``params`` (a flat dict) gathered whole at use (the
    stored parameters stay sharded). The result is sharded as ``x``."""
    mod = _dtensor_module(x)
    if mod is None:
        return fn(params, x)
    if any(p.is_shard() and p.dim != 0 for p in x.placements):
        raise ValueError(f"on_batch_shard needs a batch-sharded input, got "
                         f"{tuple(x.placements)}")
    whole = {k: v.full_tensor() if isinstance(v, mod.DTensor) else v
             for k, v in params.items()}
    y = fn(whole, x.to_local())
    return mod.DTensor.from_local(y, x.device_mesh, x.placements,
                                  run_check=False)
