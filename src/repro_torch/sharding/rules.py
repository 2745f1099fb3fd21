"""Logical-axis -> mesh-axis resolution (MaxText-style, shape-aware): the
reference's rule table and resolver, op for op, and the map from a
resolved spec to DTensor placements.

Every parameter/activation dimension carries a *logical* axis name (set in
the ParamSpec trees). A rule table maps logical names to an ordered list
of candidate mesh-axis tuples; the resolver assigns, per array, the first
candidate that

  (a) divides the dimension size evenly, and
  (b) uses only mesh axes not already claimed by another dim of this array,

visiting dims in a fixed priority order (experts before heads before ffn
before sequence, batch first among activation dims). One rule table works
across every architecture and mesh: e.g. yi-6b's 4 KV heads can't shard
16-way on "model", so its KV cache sequence dim picks up the "model" axis
instead; grok-1's 8 experts don't divide 16, so its expert FFN dim shards
instead.

A resolved spec is one entry a tensor dim: ``None`` (replicated) or the
tuple of mesh axes that dim is split over, major to minor.
:func:`placements` turns it into one DTensor placement a mesh dim.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

AxisCandidates = List[Tuple[str, ...]]
Spec = Tuple[Optional[Tuple[str, ...]], ...]

# Ordered preference of mesh axes per logical axis name. Large weight dims
# prefer fully-sharded ("data", "model") — FSDP over the data axis composed
# with tensor parallelism — and fall back to model-only / data-only when the
# dim size doesn't divide (the resolver checks divisibility per array).
DEFAULT_RULES: Dict[str, AxisCandidates] = {
    # activations
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "seq": [],
    "kv_seq": [("data", "model"), ("model",), ("data",)],
    "enc_seq": [],
    # weights
    "vocab": [("data", "model"), ("model",), ("data",)],
    "embed": [],
    "embed_out": [],
    "ffn": [("data", "model"), ("model",), ("data",)],
    "heads": [("model",), ("data",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "expert": [("data", "model"), ("model",), ("data",)],
    "expert_in": [],
    "ssm_in": [("data", "model"), ("model",), ("data",)],
    "ssm_qk": [("model",)],
    "ssm_state": [],
    "conv_out": [("model",), ("data",)],
    "conv_in": [],
    "layers": [],
}

# Which dim gets first claim on a mesh axis within one array.
PRIORITY = [
    "batch", "expert", "heads", "kv_heads", "ffn", "ssm_in", "ssm_qk",
    "vocab", "conv_out", "kv_seq", "embed", "head_dim", "seq", "enc_seq",
]


def _priority(name: Optional[str]) -> int:
    if name is None:
        return len(PRIORITY) + 1
    try:
        return PRIORITY.index(name)
    except ValueError:
        return len(PRIORITY)


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """A mesh's ``{axis name: size}`` in mesh order: a ``DeviceMesh``
    (``mesh_dim_names``), a :class:`~repro_torch.config.types.MeshConfig`
    (``axis_names``, ``shape``) or a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None or not hasattr(mesh, "shape"):
        raise TypeError(f"expected a DeviceMesh, a MeshConfig or a mapping "
                        f"of axis sizes, got {type(mesh).__name__}")
    return {str(n): int(s) for n, s in zip(names, tuple(mesh.shape))}


def resolve_spec(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh: Any,
    rules: Optional[Dict[str, AxisCandidates]] = None,
) -> Spec:
    """Resolve one array's spec from its logical axes: for each dim, None
    or the tuple of mesh axes it is split over."""
    rules = rules if rules is not None else DEFAULT_RULES
    axis_sizes = mesh_axes(mesh)
    assignment: List[Optional[Tuple[str, ...]]] = [None] * len(shape)
    used: set = set()
    order = sorted(range(len(shape)), key=lambda i: _priority(logical[i]))
    for i in order:
        name = logical[i]
        if name is None:
            continue
        for cand in rules.get(name, []):
            if not all(a in axis_sizes for a in cand):
                continue
            prod = 1
            for a in cand:
                prod *= axis_sizes[a]
            if shape[i] % prod:
                continue
            if any(a in used for a in cand):
                continue
            assignment[i] = tuple(cand)
            used.update(cand)
            break
    return tuple(assignment)


def placements(spec: Spec, mesh: Any) -> List[Any]:
    """DTensor placements of a resolved spec, one a mesh dim: ``Shard(i)``
    where tensor dim ``i`` claims that mesh axis, else ``Replicate()``. A
    dim split over several axes shards on each of them in mesh order,
    which is JAX's major-to-minor order. A mesh axis of size 1 is
    ``Replicate()``: its one shard is the whole tensor, and DTensor's view
    rules refuse to merge a sharded dim (``(d, 1, k) -> (d, k)``) even
    when it is split once."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out: List[Any] = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} splits over {axes}, not in the "
                             f"mesh's order {tuple(names)}")
        for j in idx:
            if sizes[names[j]] > 1:
                out[j] = Shard(dim)
    return out


def shardings_for_specs(specs_tree, logical_tree, mesh: Any, rules=None):
    """The placement tree for an (abstract params, logical axes) tree
    pair: nested dicts / lists, a leaf is anything with a ``shape``."""
    if isinstance(specs_tree, dict):
        return {k: shardings_for_specs(v, logical_tree[k], mesh, rules)
                for k, v in specs_tree.items()}
    if isinstance(specs_tree, (list, tuple)):
        return [shardings_for_specs(v, lg, mesh, rules)
                for v, lg in zip(specs_tree, logical_tree)]
    spec = resolve_spec(tuple(specs_tree.shape), logical_tree, mesh, rules)
    return placements(spec, mesh)
