"""Checkpointing: trees of tensors to ``leaf_i``-keyed npz archives, in
the reference's on-disk layout, so a checkpoint crosses packages both
ways.

Layout: ``<dir>/step_<N:08d>/{params.npz, opt_state.npz, manifest.json}``.
Leaves are numbered in the reference's order (jax's flatten order: dict
keys sorted, :mod:`repro_torch.utils.tree`), and the manifest records
the tree's structure as jax prints it. Restore rebuilds the structure of
the templates it is given, shape- and dtype-checked, on each template
leaf's device.

numpy has no bfloat16. With ``ml_dtypes`` the reference writes a bfloat16
leaf as its raw two bytes a value, which ``np.load`` reads back as the
void dtype ``|V2``; the port writes a bfloat16 leaf as the same ``|V2``
bytes and reads ``|V2`` back as bfloat16 bits, without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import _is_namedtuple, tree_leaves, tree_unflatten

_BF16_BYTES = np.dtype("V2")


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` prints
    it (leaves ``*``)."""

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(v) for v in node) + "])")
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BYTES)
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = a.copy()
    if a.dtype == _BF16_BYTES:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf dtype {a.dtype} ({t.dtype}) != "
                         f"template {like.dtype}")
    return t.to(like.device)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], str]:
    arrays = {f"leaf_{i}": _to_numpy(torch.as_tensor(leaf))
              for i, leaf in enumerate(tree_leaves(tree))}
    return arrays, treedef_str(tree)


def save_checkpoint(directory: str, step: int, params, opt_state=None) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    p_arrays, p_def = _flatten(params)
    np.savez(os.path.join(path, "params.npz"), **p_arrays)
    manifest = {"step": step, "params_treedef": p_def}
    if opt_state is not None:
        o_arrays, o_def = _flatten(opt_state)
        np.savez(os.path.join(path, "opt_state.npz"), **o_arrays)
        manifest["opt_treedef"] = o_def
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def _unflatten_like(template, npz) -> Any:
    leaves = [torch.as_tensor(x) for x in tree_leaves(template)]
    loaded = []
    for i, like in enumerate(leaves):
        a = npz[f"leaf_{i}"]
        if tuple(like.shape) != tuple(a.shape):
            raise ValueError(f"checkpoint leaf {i} shape {a.shape} != "
                             f"template {tuple(like.shape)}")
        loaded.append(_to_tensor(a, like))
    return tree_unflatten(template, loaded)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for m in (re.match(r"step_(\d+)$", d) for d in os.listdir(directory))
        if m
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, params_template, opt_template=None,
                       step: Optional[int] = None):
    """Restore into the structure of the given templates (shape- and
    dtype-checked); returns (params, opt_state or None, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten_like(params_template, z)
    opt_state = None
    if opt_template is not None:
        with np.load(os.path.join(path, "opt_state.npz")) as z:
            opt_state = _unflatten_like(opt_template, z)
    return params, opt_state, step
