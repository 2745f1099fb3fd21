"""Per-device accounting of one step for the roofline report: the port's
counterpart of the reference's ``launch/hlo_analysis.py``.

The reference compiles a step for its mesh and reads XLA's per-device
``cost_analysis`` (FLOPs, bytes accessed), ``memory_analysis`` (argument,
output and temporary bytes) and the collectives of the compiled HLO. The
port has no HLO to parse. It runs the step once under a
:class:`StepCounter`, a ``TorchDispatchMode`` that sees every operation
PyTorch executes on each device's local tensors: the plain tensors of an
unsharded step, the local shards that ``DTensor`` issues for a sharded
one (the mode declines the ``DTensor``-level call, so ``DTensor`` runs
its sharding propagation, the redistributions it needs and the local
operation, each of which comes back to the mode), and the functional
collectives that move shards between ranks. Under ``FakeTensorMode`` the
same run allocates nothing, so a 256-rank mesh is accounted from one
process with a fake process group (``launch/dryrun.py``).

What it records, per device:

  FLOPs         the formulas ``torch.utils.flop_counter`` registers (matrix
                products, convolutions, attention and their backwards),
                applied to each operation's local shapes: work replicated
                on a mesh axis counts in full on every device, sharded
                work in part (the counterpart of XLA's count after SPMD
                partitioning). Operations no formula covers (elementwise,
                reductions, scans) add nothing.
  bytes         every operation's local input and output bytes. This is an
                unfused count: an intermediate that XLA keeps in a fused
                loop is written and read again here, so it is larger than
                XLA's ``bytes accessed`` by design. Views, metadata queries,
                ``empty`` and the wait on a collective move no bytes.
  collectives   each functional collective (all-gather, reduce-scatter,
                all-reduce, all-to-all, point-to-point) with its group size
                and local bytes, priced by the reference's ring formulas
                (per device, g = group size):
                  all-gather        out_bytes * (g-1)/g
                  reduce-scatter    in_bytes  * (g-1)/g
                  all-reduce        2 * in_bytes * (g-1)/g
                  all-to-all        in_bytes  * (g-1)/g
                  collective-permute / send / recv   in_bytes
  arguments     the local bytes of every input leaf the step reads (an
                operation reads its storage, or an output aliases it), the
                counterpart of ``jax.jit``'s ``keep_unused=False`` pruning:
                a cloud tail counts only the layers it runs.
  outputs       the local bytes of the step's outputs.
  temp          the peak of the bytes the step allocated that are live
                at once, outputs excepted: a buffer lives from the
                operation that first writes it to the last that touches
                it, as a compiler's buffer assignment would keep it (and
                not as long as Python holds it). Unfused, like the bytes.

The operations DTensor runs on global-shape fakes to propagate shapes are
not the step's and are not counted, so a real run and a fake run of the
same step count the same.

:class:`RooflineReport` keeps the reference's fields and ``to_dict`` keys;
its terms divide by the H100's figures (``config/types.py`` ``H100``,
``H100_HBM_BW``, ``H100_NVLINK_BW``), and the compute term takes the
analytic count when given, as the reference's does.
"""
from __future__ import annotations

import functools
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config.types import H100, H100_HBM_BW, H100_NVLINK_BW
from repro_torch.sharding.activation import _dtensor_module
from repro_torch.utils.tree import tree_map

# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# Functional collective (namespace::name) -> the reference's HLO kind.
_COLLECTIVE_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "_c10d_functional::isend": "collective-permute",
    "_c10d_functional::irecv": "collective-permute",
}
_NO_BYTES = frozenset([
    "_c10d_functional::wait_tensor", "aten::empty", "aten::empty_strided",
    "aten::empty_like", "aten::sym_size", "aten::sym_stride",
    "aten::sym_numel", "aten::sym_storage_offset", "aten::is_contiguous",
    "aten::is_same_size", "_c10d_functional::_wrap_tensor_autograd",
])


@dataclass
class CollectiveOp:
    kind: str
    out_bytes: int
    in_bytes: int
    group_size: int
    wire_bytes: float


@dataclass
class CollectiveStats:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    def by_kind(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for o in self.ops:
            cnt, byt = out.get(o.kind, (0, 0.0))
            out[o.kind] = (cnt + 1, byt + o.wire_bytes)
        return out


def price_collective(kind: str, in_bytes: int, out_bytes: int,
                     group_size: int) -> CollectiveOp:
    """One collective's per-device wire bytes by the reference's ring
    formulas (``in_bytes`` 0 takes ``out_bytes``, as the reference does
    for an operand it cannot see)."""
    in_bytes = in_bytes or out_bytes
    g = group_size
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        wire = out_bytes * frac
    elif kind == "reduce-scatter":
        wire = in_bytes * frac
    elif kind == "all-reduce":
        wire = 2.0 * in_bytes * frac
    elif kind == "all-to-all":
        wire = in_bytes * frac
    elif kind == "collective-permute":
        wire = float(in_bytes)
    else:
        raise ValueError(f"no wire price for collective kind {kind!r}")
    return CollectiveOp(kind, int(out_bytes), int(in_bytes), int(g), wire)


def _collective_group(func, args, kwargs) -> int:
    """A functional collective's group size: its ``group_size`` argument,
    else the size of the group its ``group_name`` names (a point-to-point
    transfer is a pair)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a.name for a in func._schema.arguments]

    def arg(n):
        i = names.index(n)
        return args[i] if i < len(args) else kwargs[n]

    if "group_size" in names:
        return int(arg("group_size"))
    if "group_name" in names:
        return _resolve_process_group(arg("group_name")).size()
    return 2


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor itself."""
    return t.to_local() if _dtensor_module(t) is not None else t


_ACTIVE: List["StepCounter"] = []
_PATCH_LOCK = threading.Lock()
_PATCHED = False


def _not_the_steps(inner, unfake: bool = False):
    """``inner`` with every active counter paused; with ``unfake``, also
    outside ``FakeTensorMode`` (DTensor bookkeeping that reads tensor
    values, which a fake tensor has none of)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    @functools.wraps(inner)
    def wrapped(*args, **kwargs):
        for c in _ACTIVE:
            c._paused += 1
        try:
            if unfake:
                with unset_fake_temporarily():
                    return inner(*args, **kwargs)
            return inner(*args, **kwargs)
        finally:
            for c in _ACTIVE:
                c._paused -= 1

    return wrapped


def _install_patches() -> None:
    """Installed once: DTensor's shape propagation (operations on
    global-shape fakes) reaches no active counter, and a strided shard's
    offsets (``_StridedShard.local_shard_size_and_offset`` builds an index
    tensor and reads it back) are computed on plain tensors."""
    global _PATCHED
    with _PATCH_LOCK:
        if _PATCHED:
            return
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        ShardingPropagator._propagate_tensor_meta_non_cached = _not_the_steps(
            ShardingPropagator._propagate_tensor_meta_non_cached)
        _StridedShard.local_shard_size_and_offset = _not_the_steps(
            _StridedShard.local_shard_size_and_offset, unfake=True)
        _PATCHED = True


@dataclass
class StepCount:
    """What one step did on one device."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    ops: int = 0


class StepCounter(TorchDispatchMode):
    """Counts the operations run inside ``with counter:`` on local tensors.
    ``inputs`` is the step's argument tree (plain tensors or DTensors);
    :meth:`finish` takes the step's outputs and returns the
    :class:`StepCount`."""

    def __init__(self, inputs: Any = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._paused = 0
        self.count = StepCount()
        # storage key -> (local bytes, read?) of every input leaf
        self._inputs: Dict[int, List[Any]] = {}
        for t in _tensors(inputs):
            loc = _local(t)
            key = _storage_key(loc)
            if key not in self._inputs:
                self._inputs[key] = [_nbytes(loc), False]
        # buffers the step allocates: storage key -> (span index, weak
        # storage); spans [bytes, first op, last op, key]
        self._buffers: Dict[int, Tuple[int, Any]] = {}
        self._spans: List[List[int]] = []

    def __enter__(self):
        _install_patches()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = sys.modules.get("torch.distributed.tensor")
        if dt is not None and any(issubclass(t, dt.DTensor) for t in types):
            # DTensor runs its propagation, redistributions and the local
            # operation; those come back here.
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        if name.startswith("prim::"):     # metadata queries of fakes
            return
        c = self.count
        c.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is None and name.startswith(("_c10d_functional::", "c10d::",
                                             "_dtensor::")) \
                and name not in _NO_BYTES:
            raise ValueError(f"no wire price for collective {name}")
        if kind is not None:
            in_b = sum(_nbytes(t) for t in ins)
            out_b = sum(_nbytes(t) for t in outs)
            c.collectives.ops.append(price_collective(
                kind, in_b, out_b, _collective_group(func, args, kwargs)))
        packet = func._overloadpacket
        if packet in self._flop_registry:
            c.flops += float(self._flop_registry[packet](*args, **kwargs,
                                                         out_val=out))
        if func.is_view or name in _NO_BYTES:
            return
        for t in ins:
            got = self._inputs.get(_storage_key(t))
            if got is not None and t.numel():
                got[1] = True
        c.bytes_accessed += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        self._track(ins, outs)

    def _track(self, ins: List[torch.Tensor],
               outs: List[torch.Tensor]) -> None:
        """Buffers the step allocates, each live from the operation that
        writes it first to the last that reads or writes it (a storage
        address freed and taken again is a new buffer)."""
        from torch.multiprocessing.reductions import StorageWeakRef

        i = self.count.ops
        for t in ins:
            got = self._buffers.get(_storage_key(t))
            if got is not None and not got[1].expired():
                self._spans[got[0]][2] = i
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._inputs:
                continue
            got = self._buffers.get(key)
            if got is not None and not got[1].expired():
                self._spans[got[0]][2] = i
                continue
            self._buffers[key] = (len(self._spans), StorageWeakRef(st))
            self._spans.append([st.nbytes(), i, i, key])

    # -------------------------------------------------------------- result
    def finish(self, outputs: Any) -> StepCount:
        """The count, with ``outputs`` (the step's result tree) giving the
        output bytes, the inputs the outputs alias, and the allocations
        the temporary peak leaves out."""
        c = self.count
        out_keys = set()
        c.output_bytes = 0
        for t in _tensors(outputs):
            loc = _local(t)
            key = _storage_key(loc)
            c.output_bytes += _nbytes(loc)
            out_keys.add(key)
            got = self._inputs.get(key)
            if got is not None:
                got[1] = True
        c.argument_bytes = sum(nb for nb, read in self._inputs.values()
                               if read)
        live = {self._buffers[k][0] for k in out_keys if k in self._buffers
                and not self._buffers[k][1].expired()}
        events = []
        for n, (nb, first, last, _) in enumerate(self._spans):
            if n not in live:
                events += [(first, nb), (last + 1, -nb)]
        cur = peak = 0
        for _, delta in sorted(events, key=lambda e: (e[0], e[1] > 0)):
            cur += delta
            peak = max(peak, cur)
        c.temp_bytes = peak
        return c


# ---------------------------------------------------------------------------
# Fake placement
# ---------------------------------------------------------------------------


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The local shard's shape of a global ``shape`` under ``placements``
    (every split divides: the rule table checks it)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(j)
    return tuple(out)


def place_abstract(tree, shardings, mesh, device):
    """Empty tensors shaped like ``tree``'s leaves (``meta`` tensors or
    anything with ``shape`` and ``dtype``) on ``device``: under
    ``FakeTensorMode`` they allocate nothing. With a mesh, each is a
    ``DTensor`` built with ``from_local`` on its local shape under the
    placements of ``shardings`` (a tree like ``tree``), as the serving
    worker places real tensors; without one, the whole tensor."""
    from torch.distributed.tensor import DTensor

    def one(a, pl):
        if a is None:
            return None
        if mesh is None:
            return torch.empty(tuple(a.shape), dtype=a.dtype, device=device)
        loc = torch.empty(local_shape(a.shape, pl, mesh), dtype=a.dtype,
                          device=device)
        return DTensor.from_local(loc, mesh, pl, run_check=False)

    if shardings is None:
        return tree_map(lambda a: one(a, None), tree)
    return _zip_map(one, tree, shardings)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        vals = [_zip_map(fn, v, o) for v, o in zip(tree, other)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return fn(tree, other)


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # counted on one device (its local tensors)
    flops: float
    bytes_accessed: float
    wire_bytes: float
    collectives: Dict[str, Tuple[int, float]]
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    # analytic references
    model_flops_global: float
    analytic_flops_global: float = 0.0
    # roofline terms in seconds, on the H100
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        # The compute term from the analytic matrix-product count when
        # given (the counted FLOPs include no elementwise work either, but
        # the analytic count is what the reference's term reads);
        # memory and collectives from the counted step.
        flops_per_dev = (
            self.analytic_flops_global / self.chips
            if self.analytic_flops_global
            else self.flops
        )
        self.compute_s = flops_per_dev / H100.flops
        self.memory_s = self.bytes_accessed / H100_HBM_BW
        self.collective_s = self.wire_bytes / H100_NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global). Catches remat/redundancy."""
        counted_global = self.flops * self.chips
        return self.model_flops_global / counted_global \
            if counted_global else 0.0

    @property
    def hbm_bytes_per_device(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops,
            "bytes_accessed_per_device": self.bytes_accessed,
            "wire_bytes_per_device": self.wire_bytes,
            "collectives": {k: list(v) for k, v in self.collectives.items()},
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "model_flops_global": self.model_flops_global,
            "analytic_flops_global": self.analytic_flops_global,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "hbm_gib_per_device": self.hbm_bytes_per_device / 2**30,
        }


def analyze_step(count: StepCount, *, arch: str, shape: str, mesh_name: str,
                 chips: int, model_flops_global: float,
                 analytic_flops_global: float = 0.0) -> RooflineReport:
    """The roofline report of one counted step (``analyze_compiled``'s
    counterpart)."""
    return RooflineReport(
        analytic_flops_global=analytic_flops_global,
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops=count.flops,
        bytes_accessed=count.bytes_accessed,
        wire_bytes=count.collectives.total_wire_bytes,
        collectives=count.collectives.by_kind(),
        argument_bytes=count.argument_bytes,
        output_bytes=count.output_bytes,
        temp_bytes=count.temp_bytes,
        model_flops_global=model_flops_global,
    )
