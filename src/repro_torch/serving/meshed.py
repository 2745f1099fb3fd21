"""Meshed cloud worker: the shared cloud tail, sharded over a device mesh.

The serving stack's cloud side is one device, which is fine for the
paper's testbed; the large configs (granite-34b and up) cannot hold their
tail parameters on one card. This module turns the shared cloud worker of
:class:`~repro_torch.serving.fleet.FleetServer` into an SPMD runner over a
``torch.distributed`` ``DeviceMesh``:

* **Sharded parameter tree.** Placements are resolved ONCE per (config,
  mesh axes) through :func:`repro_torch.sharding.rules.resolve_spec` (the
  priority-ordered, divisibility-checked rule table) and cached by config
  hash. Each rank wraps its own slice of every parameter as a ``DTensor``
  built on a view of the caller's tensor (copied only where the slice is
  not contiguous), so a mesh of one holds no second copy of the weights.

* **Batch-sharded boundary entry.** A group of bitpack or Huffman blobs
  decodes straight into per-rank batch shards
  (:func:`~repro_torch.kernels.quantize.ops.dequantize_wire_batch_sharded`
  and its codes flavor: each rank decodes only its own rows, one K2
  launch on the card), and the boundary is pinned through
  :func:`~repro_torch.sharding.activation.constrain` (batch on "data";
  the rule table leaves seq / embed / spatial dims replicated so the
  parameters carry the "model" axis). Other codecs decode through their
  own batch path, then each rank keeps its rows.

* **One fused forward.** The group's tail runs once over the whole group
  on DTensors; the logits are gathered, so every rank returns every
  request's logits. Results equal the single-device fused tail within
  float tolerance (the ``fuse_tail=True`` contract).

Every rank runs the same serving loop over the same requests; only this
worker's decode and tail are split. Groups whose size does not divide the
"data" axis are padded by tiling (the padding sliced off the logits), so a
group of any size serves in one forward. Groups the worker cannot shard
return None (mixed codecs, cloud-only plans, empty or unstackable
extras), and the runner's single-device path serves them.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import tensor_device
from repro_torch.models.api import Model
from repro_torch.models.init import torch_dtype
from repro_torch.sharding.activation import constrain
from repro_torch.sharding.rules import mesh_axes, shardings_for_specs
from repro_torch.utils.tree import (
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_UNSTACKABLE = object()

# (config hash, mesh axes) -> placement tree. The rule-table resolve walks
# every parameter leaf; one worker per (config, mesh) pays it once and every
# later worker reuses it.
_SHARDING_CACHE: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], Any] = {}


def _config_hash(cfg) -> str:
    # The full config repr keys the cache (reduced() variants never share
    # an entry), as the predictor tables' cache key does.
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:16]


def mesh_size(mesh) -> int:
    """Ranks in ``mesh`` (``DeviceMesh.size`` is a method, JAX's an
    attribute)."""
    n = 1
    for s in mesh_axes(mesh).values():
        n *= s
    return n


def param_shardings(model: Model, mesh):
    """The model's placement tree on ``mesh``, resolved through
    ``rules.resolve_spec`` once per (config, mesh axes) and cached."""
    key = (_config_hash(model.cfg), tuple(mesh_axes(mesh).items()))
    got = _SHARDING_CACHE.get(key)
    if got is None:
        got = shardings_for_specs(model.abstract_params(),
                                  model.param_logical_axes(), mesh)
        _SHARDING_CACHE[key] = got
    return got


def _local_slice(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` under ``placements``: a view, made
    contiguous (a copy of the slice alone) only when it is not."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = t
    for dim in range(t.ndim):
        n, idx = 1, 0
        for j, p in enumerate(placements):
            if isinstance(p, Shard) and p.dim == dim:
                n *= mesh.size(j)
                idx = idx * mesh.size(j) + coord[j]
        if n > 1:
            size = t.shape[dim] // n
            out = out.narrow(dim, idx * size, size)
    return out if out.is_contiguous() else out.contiguous()


def shard_params(params, shardings, mesh):
    """The parameter tree as DTensors with ``shardings``' placements, each
    rank's local tensor a slice of its own full parameter."""
    from torch.distributed.tensor import DTensor

    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k], mesh)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_params(v, s, mesh) for v, s in zip(params, shardings)]
    if params.device.type != mesh.device_type:
        raise ValueError(f"parameters on {params.device}, mesh on "
                         f"{mesh.device_type}")
    return DTensor.from_local(_local_slice(params, shardings, mesh), mesh,
                              shardings, run_check=False,
                              shape=params.shape, stride=params.stride())


def _tile_to(arr, b_pad: int):
    """Tile ``arr`` along axis 0 to length ``b_pad`` (b_pad >= len)."""
    b = int(arr.shape[0])
    if b == b_pad:
        return arr
    idx = np.arange(b_pad) % b
    if isinstance(arr, np.ndarray):
        return np.take(arr, idx, axis=0)
    return arr[torch.from_numpy(idx).to(arr.device)]


def _paths(tree):
    return [p for p, _ in tree_flatten_with_path(tree)]


class MeshedCloudWorker:
    """Owns the mesh and the sharded parameter tree and serves batched
    cloud steps.

    ``try_cloud_step_batch`` is the hook :meth:`DecoupledRunner.
    cloud_step_batch` calls when a mesh worker is wired in: it returns the
    per-request logits for groups it can serve fused, or ``None`` for the
    single-device path (mixed codecs, unstackable extras, empty
    boundaries)."""

    def __init__(self, model: Model, params: Any, mesh):
        self.model = model
        self.mesh = mesh
        axes = mesh_axes(mesh)
        if "data" not in axes:
            raise ValueError(f"a cloud mesh needs a 'data' axis, got "
                             f"{tuple(axes)}")
        self.data_size = axes["data"]
        self.device = tensor_device(params)
        self._dtype = torch_dtype(model.cfg.dtype)
        self.param_shardings = param_shardings(model, mesh)
        self.params = shard_params(params, self.param_shardings, mesh)
        # Serving stats the tests and chip_smoke.py assert on.
        self.fused_calls = 0
        self.group_sizes: List[int] = []

    # ------------------------------------------------------------ helpers
    def _batch_placements(self):
        from torch.distributed.tensor import Replicate, Shard

        return [Shard(0) if a == "data" else Replicate()
                for a in self.mesh.mesh_dim_names]

    def _put_batched(self, tree):
        """Every leaf (the whole padded batch, on every rank) as a DTensor
        sharded along its leading axis over "data": each rank keeps its
        rows."""
        from torch.distributed.tensor import DTensor

        j = list(self.mesh.mesh_dim_names).index("data")
        r = self.mesh.get_coordinate()[j]

        def put(a: torch.Tensor):
            per = a.shape[0] // self.data_size
            return DTensor.from_local(a[r * per:(r + 1) * per].to(
                self.device), self.mesh, self._batch_placements(),
                run_check=False)

        return tree_map(put, tree)

    def _stack_extras(self, extras_list: Sequence[Any],
                      counts: Sequence[int]):
        """Concatenate per-request extras trees along the batch axis.
        Returns None (no extras), the stacked tree, or ``_UNSTACKABLE``
        when any leaf's leading dim is not that request's batch."""
        if all(e is None for e in extras_list):
            return None
        if any(e is None for e in extras_list):
            return _UNSTACKABLE
        paths = _paths(extras_list[0])
        if any(_paths(e) != paths for e in extras_list[1:]):
            return _UNSTACKABLE
        cols = list(zip(*(tree_leaves(e) for e in extras_list)))
        for leaves in cols:
            for leaf, cnt in zip(leaves, counts):
                if leaf.ndim == 0 or int(leaf.shape[0]) != int(cnt):
                    return _UNSTACKABLE
            if len({tuple(leaf.shape[1:]) for leaf in leaves}) != 1:
                return _UNSTACKABLE
        return tree_unflatten(extras_list[0],
                              [torch.cat(leaves, 0) for leaves in cols])

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def try_cloud_step_batch(self, blobs: Sequence[Any],
                             extras_list: Optional[Sequence[Any]],
                             plan) -> Optional[List[torch.Tensor]]:
        """Serve one (point, bits, codec) group through the mesh. Returns
        the per-request logits (float-equivalent to the single-device
        fused tail) or None when the group cannot batch-shard."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.codec import get_codec
        from repro_torch.codec.base import ranges_f32
        from repro_torch.codec.bitpack import BitpackCodec
        from repro_torch.codec.huffman import HuffmanCodec
        from repro_torch.core import entropy as ent
        from repro_torch.kernels.quantize import ops

        blobs = list(blobs)
        if not blobs or plan.is_cloud_only:
            return None
        if extras_list is None:
            extras_list = [None] * len(blobs)
        if len({b.codec for b in blobs}) != 1:
            return None
        if len({tuple(b.shape[1:]) for b in blobs}) != 1:
            return None
        if any(len(b.shape) < 1 or b.num_elements == 0 for b in blobs):
            return None
        counts = [int(b.shape[0]) for b in blobs]
        extras = self._stack_extras(extras_list, counts)
        if extras is _UNSTACKABLE:
            return None
        point = int(plan.point)
        codec = get_codec(blobs[0].codec)
        ds = self.data_size
        total = sum(counts)

        decode = None
        if (len({tuple(b.shape) for b in blobs}) == 1
                and len({b.bits for b in blobs}) == 1):
            if isinstance(codec, BitpackCodec):
                decode = ops.dequantize_wire_batch_sharded
            elif isinstance(codec, HuffmanCodec):
                decode = ops.dequantize_codes_batch_sharded
        if decode is not None:
            # The host frames the bitpack bytes (as codec.decode does) or
            # entropy-decodes the Huffman payloads (data-dependent lengths
            # are host work); the dequant decodes each rank's rows of the
            # padded group straight into its batch shard.
            bits = int(blobs[0].bits)
            nb_pad = -(-len(blobs) // ds) * ds
            if decode is ops.dequantize_wire_batch_sharded:
                stacked = np.stack([codec._wire_codes(b) for b in blobs])
            else:
                wide = np.uint8 if bits <= 8 else np.uint16
                stacked = np.stack([ent.huffman_decode(b.payload).astype(
                    wide) for b in blobs])
            mn, mx = ranges_f32(blobs)
            x = decode(_tile_to(stacked, nb_pad), _tile_to(mn, nb_pad),
                       _tile_to(mx, nb_pad), bits, tuple(blobs[0].shape),
                       self.mesh, out_dtype=self._dtype)
            # Merge (n_blobs, b, ...) -> (n_blobs * b, ...): one tail
            # forward over the whole group's samples.
            x = DTensor.from_local(
                x.to_local().reshape((-1,) + tuple(blobs[0].shape[1:])),
                self.mesh, x.placements, run_check=False)
            b_pad = nb_pad * counts[0]
        else:
            boundaries = codec.decode_batch(blobs, out_dtype=self._dtype,
                                            device=self.device)
            b_pad = -(-total // ds) * ds
            x = self._put_batched(_tile_to(torch.cat(boundaries, 0), b_pad))
        if extras is not None:
            extras = self._put_batched(
                tree_map(lambda a: _tile_to(a, b_pad), extras))
        x = constrain(x, self.model.boundary_logical_axes(x.ndim))
        # Plain tensors made inside the tail (positions, masks) act as
        # replicated.
        with implicit_replication():
            logits = self.model.run_tail(self.params, x, point, extras)
        logits = logits.full_tensor()[:total]
        self.fused_calls += 1
        self.group_sizes.append(total)
        if len(counts) == 1:
            return [logits]
        return list(torch.split(logits, counts, dim=0))


def aot_tail_report(model: Model, point: int, *, batch: int = 8,
                    seq_len: int = 64, mesh=None) -> Dict[str, float]:
    """Account the cloud tail at ``point`` ahead of time on fake tensors
    (no parameter is allocated, so this works for configs whose weights
    fit no card: granite-34b is 94.5 GB in bf16) and return its per-device
    FLOPs and memory, the reference's five keys. With a mesh the
    parameters are placed through the rule table and the boundary enters
    batch-sharded on "data", the serving worker's layout; without one it
    is the whole tail on one device (``launch/dryrun.py``
    ``fake_device``; fake tensors need no card).

    The head runs on fake tensors first to give the boundary and the
    extras. The tail runs once under
    :class:`~repro_torch.launch.step_analysis.StepCounter`:
    ``flops_per_device`` counts the local shards' matrix products, so
    ``single.flops / sharded.flops`` is the parallel fraction the mesh
    achieves; ``argument_bytes_per_device`` counts the parameters the
    tail reads and the boundary (the reference's ``keep_unused=False``
    pruning), the footprint to check against a card's memory;
    ``temp_bytes_per_device`` is the unfused peak of the tail's
    intermediates."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import (
        fake_device,
        fake_mode,
        place_args,
        run_counted,
    )
    from repro_torch.launch.step_analysis import place_abstract

    dev = fake_device() if mesh is None else torch.device(mesh.device_type)
    specs = model.abstract_params()
    raw = make_batch(model.cfg, batch, seq_len, seed=0)
    with fake_mode():
        params = place_abstract(specs, None, None, dev)
        fake_batch = {k: torch.empty(np.shape(v), dtype=torch.from_numpy(
            np.asarray(v)).dtype, device=dev) for k, v in raw.items()}
        head = model.run_head(params, fake_batch, point)
        boundary, extras = head if isinstance(head, tuple) else (head, None)
        del params

        def tail(p, x, e):
            x = constrain(x, model.boundary_logical_axes(x.ndim))
            return model.run_tail(p, x, point, e)

        if mesh is None:
            args = (place_abstract(specs, None, None, dev), boundary, extras)
        else:
            from torch.distributed.tensor import Replicate, Shard

            rep = [Replicate()] * mesh.ndim
            bsh = [Shard(0) if name == "data" and mesh.size(j) > 1
                   else Replicate()
                   for j, name in enumerate(mesh.mesh_dim_names)]
            args = place_args(
                (specs, boundary, extras),
                (param_shardings(model, mesh), bsh,
                 tree_map(lambda a: rep, extras)
                 if extras is not None else None),
                mesh, dev)
        with torch.no_grad():
            _, count = run_counted(tail, args)
    return {
        "n_devices": 1 if mesh is None else mesh_size(mesh),
        "flops_per_device": float(count.flops),
        "argument_bytes_per_device": float(count.argument_bytes),
        "temp_bytes_per_device": float(count.temp_bytes),
        "output_bytes_per_device": float(count.output_bytes),
    }
