"""Small tree utilities over nested dicts, lists, tuples and NamedTuples
of tensors (or numpy arrays).

Leaves are visited in the reference's order, jax's flatten order: a
dict's keys **sorted**, sequences and NamedTuple fields in order, None an
empty subtree. A torch tree keeps its dicts in insertion order, so
anything that numbers leaves (the global gradient norm's sum, checkpoint
``leaf_i`` names) walks them through :func:`tree_leaves` to number them
as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

# A path entry: ("key", dict key), ("idx", sequence index) or ("attr",
# NamedTuple field), jax's DictKey / SequenceKey / GetAttrKey.
PathEntry = Tuple[str, Any]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree) -> List[Tuple[Tuple[PathEntry, ...], Any]]:
    """(path, leaf) pairs in the reference's leaf order."""
    out: List[Tuple[Tuple[PathEntry, ...], Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (("key", k),))
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + (("attr", f),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (("idx", i),))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's order (dict keys sorted)."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _map_with_path(fn: Callable, tree, path=()):
    """``tree``'s structure (and dict order) with each leaf replaced by
    ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (("key", k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_map_with_path(fn, getattr(tree, f),
                                           path + (("attr", f),))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (("idx", i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf; the result keeps the tree's structure (and
    dict order)."""
    return _map_with_path(lambda _, x: fn(x), tree)


def tree_unflatten(template, leaves: List[Any]):
    """``template``'s structure with its leaves replaced, in the
    reference's leaf order, by ``leaves``."""
    paths = [path for path, _ in tree_flatten_with_path(template)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a template of "
                         f"{len(paths)}")
    by_path = dict(zip(paths, leaves))
    return _map_with_path(lambda path, _: by_path[path], template)


def path_name(path) -> str:
    """``"a/b/0/c"``: the reference's ``tree_map_with_path_names`` name (a
    NamedTuple field prints as jax's ``GetAttrKey``, ``".field"``)."""
    return "/".join("." + str(v) if k == "attr" else str(v)
                    for k, v in path)


def keystr(path) -> str:
    """jax's ``keystr``: ``"['a'][0].field"``."""
    return "".join(f"[{v!r}]" if k != "attr" else f".{v}" for k, v in path)


def tree_param_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.dtype(x.dtype).itemsize


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves."""
    return sum(int(np.prod(x.shape)) * _itemsize(x) for x in tree_leaves(tree))


def tree_map_with_path_names(fn: Callable, tree):
    """tree_map where fn receives ("a/b/c", leaf)."""
    return _map_with_path(lambda path, x: fn(path_name(path), x), tree)


def check_no_nans(tree, where: str = "") -> None:
    """Raise if any floating leaf holds a NaN or an Inf (a host sync)."""
    for path, leaf in tree_flatten_with_path(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"non-finite values at {where}{keystr(path)}")


def cast_floating(tree, dtype: torch.dtype):
    """Cast floating leaves to dtype, leave integer leaves alone."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
