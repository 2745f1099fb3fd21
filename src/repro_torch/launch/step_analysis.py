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

A counter made with ``rolled`` (loop kinds, ``"time"`` and / or
``"layers"``) rolls the :func:`repro_torch.utils.scan.scan` loops of those
kinds that run on fake tensors: three steps run, the middle one in a scope
that multiplies everything recorded (FLOPs, bytes, operations,
collectives) by the n - 2 steps it stands for, and its buffers that
outlive it count n - 2 times in the temporary peak (see that module for
the rule). Real tensors always run the loop, so a real step and a fake
rolled step of the same geometry count the same.

The operations DTensor runs on global-shape fakes to propagate shapes are
not the step's and are not counted, so a real run and a fake run of the
same step count the same.

:class:`RooflineReport` keeps the reference's fields and ``to_dict`` keys;
its terms divide by the H100's figures (``config/types.py`` ``H100``,
``H100_HBM_BW``, ``H100_NVLINK_BW``), and the compute term takes the
analytic count when given, as the reference's does.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config.types import H100, H100_HBM_BW, H100_NVLINK_BW
from repro_torch.sharding.activation import _dtensor_module
from repro_torch.utils.scan import ACTIVE_COUNTERS
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
    times: int = 1          # issued this many times (a rolled loop's)


@dataclass
class CollectiveStats:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes * o.times for o in self.ops)

    def by_kind(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for o in self.ops:
            cnt, byt = out.get(o.kind, (0, 0.0))
            out[o.kind] = (cnt + o.times, byt + o.wire_bytes * o.times)
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


_ACTIVE: List["StepCounter"] = ACTIVE_COUNTERS
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
    :class:`StepCount`. ``rolled`` names the kinds of
    :func:`~repro_torch.utils.scan.scan` loop the counter rolls when they
    run on fake tensors (``"time"``, ``"layers"``)."""

    def __init__(self, inputs: Any = (), rolled: Tuple[str, ...] = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._paused = 0
        self.rolled = frozenset(rolled)
        self.count = StepCount()
        # What a rolled loop's middle step records counts this many times;
        # its scopes nest this deep.
        self._mult = 1
        self._depth = 0
        # Rolled loops: their middle steps' forward regions [weight,
        # depth, start, end, end of the next step]; the parts of the
        # backward from the last step's first node to the first step's
        # (depth, start, end); the middle gradient slices kept until the
        # unbind's stack (span index, weight, from).
        self._regions: List[List[int]] = []
        self._backward: List[Tuple[int, int, int]] = []
        self._kept: List[Tuple[int, int, int]] = []
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
        m = self._mult
        c.ops += m
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
            op = price_collective(kind, in_b, out_b,
                                  _collective_group(func, args, kwargs))
            op.times = m
            c.collectives.ops.append(op)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            c.flops += m * float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if func.is_view or name in _NO_BYTES:
            return
        self._moved(ins, outs, sum(_nbytes(t) for t in ins)
                    + sum(_nbytes(t) for t in outs))

    def _moved(self, ins: List[torch.Tensor], outs: List[torch.Tensor],
               nbytes: int) -> None:
        """An operation that reads ``ins``, writes ``outs`` and moves
        ``nbytes`` (local tensors), counted in the current scope."""
        for t in ins:
            got = self._inputs.get(_storage_key(t))
            if got is not None and t.numel():
                got[1] = True
        self.count.bytes_accessed += self._mult * nbytes
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
        for nb, first, last, n in self._copies():
            if n not in live:
                events += [(first, nb), (last + 1, -nb)]
        cur = peak = 0
        for _, delta in sorted(events, key=lambda e: (e[0], e[1] > 0)):
            cur += delta
            peak = max(peak, cur)
        c.temp_bytes = peak
        return c

    # --------------------------------------------------------- rolled loops
    def roll(self, n: int) -> "_Roll":
        """The scopes and marks of one rolled loop of ``n`` steps."""
        return _Roll(self, n)

    def _copies(self) -> List[Tuple[int, int, int, int]]:
        """(bytes, first, last, span index) of the buffers the rolled loops'
        middle steps stand for beside the one they allocated (see
        ``utils/scan.py``): for a buffer a middle step allocates that
        outlives the next step, n - 3 more copies from the step's start
        until the end of its loop's middle part of the backward if that
        reads it, else until its last touch; for a middle gradient slice,
        n - 3 more from that part's end until the unbind's stack. Copies
        an inner loop adds in an outer loop's middle step count again."""
        spans = self._spans
        firsts = [s[1] for s in spans]
        backward = sorted(self._backward, key=lambda b: b[1])

        def end_of(depth, last):
            end = last
            for d, start, stop in backward:     # the innermost wins
                if d == depth and start <= last <= stop:
                    end = stop
            return end

        out: List[Tuple[int, int, int, int]] = []
        for w, depth, a, b, next_end in sorted(self._regions,
                                               key=lambda r: r[3] - r[2]):
            lo, hi = bisect.bisect_right(firsts, a), \
                bisect.bisect_right(firsts, b)
            inside = [(s[0], s[1], s[2], k)
                      for k, s in enumerate(spans[lo:hi], lo)]
            inside += [g for g in out if a <= g[1] <= b]
            for nb, _, last, k in inside:
                if last > next_end:
                    out.append((nb * (w - 1), a, end_of(depth, last), k))
        for k, w, start in self._kept:
            out.append((spans[k][0] * (w - 1), start, spans[k][2], k))
        return out


class _Roll:
    """One rolled loop of ``n`` steps under ``counter``: the middle step's
    scopes, forward (:meth:`middle`) and backward (:meth:`hook_backward`),
    and the marks the temporary peak reads."""

    def __init__(self, counter: StepCounter, n: int):
        self.counter, self.n = counter, n
        self._region: List[int] = []
        self._start = self._end = self._mult = self._depth = 0

    @contextlib.contextmanager
    def times(self, k: int):
        """What is recorded inside counts ``k`` times more."""
        c = self.counter
        saved = c._mult
        c._mult = saved * k
        try:
            yield
        finally:
            c._mult = saved

    @contextlib.contextmanager
    def middle(self):
        """The middle step's forward: counted n - 2 times."""
        c = self.counter
        c._depth += 1
        region = [self.n - 2, c._depth, c.count.ops, 0, 0]
        try:
            with self.times(self.n - 2):
                yield
        finally:
            c._depth -= 1
        region[3] = region[4] = c.count.ops
        self._region = region
        c._regions.append(region)

    def next_step_done(self) -> None:
        """The last step's forward ended: a middle buffer read no later is
        a carry."""
        self._region[4] = self.counter.count.ops

    def hook_backward(self, last, middle, first) -> None:
        """Prehooks on the first node the backward runs of each step: the
        middle step's nodes run in the n - 2 scope, and the marks of this
        loop's part of the backward (the last step's first node to the
        first step's)."""
        c = self.counter

        def on_last(_):
            self._start, self._depth = c.count.ops, c._depth + 1

        def on_middle(_):
            c._depth += 1
            self._mult = c._mult
            c._mult *= self.n - 2

        def on_first(_):
            c._mult = self._mult
            c._depth -= 1
            self._end = c.count.ops
            c._backward.append((self._depth, self._start, self._end))

        last.register_prehook(on_last)
        middle.register_prehook(on_middle)
        first.register_prehook(on_first)

    @contextlib.contextmanager
    def _quiet(self):
        c = self.counter
        c._paused += 1
        try:
            yield
        finally:
            c._paused -= 1

    def unbind(self, x: torch.Tensor, dim: int):
        """The loop's ``unbind`` of ``x`` along ``dim``, counted as the one
        view it is, without making its n slices: (first, second, last)."""
        self.counter.count.ops += self.counter._mult
        with self._quiet():
            return tuple(x.select(dim, t) for t in (0, 1, self.n - 1))

    def stack(self, three, dim: int) -> torch.Tensor:
        """The loop's ``stack`` of n slices, ``three`` the first, a middle
        one (n - 2 times) and the last, counted as the one operation it is,
        without listing n slices. DTensors first move to the placement
        DTensor's stack gives them all (it depends only on which placements
        come in), each move counted as often as its slice comes, and the
        result takes the stack's placement."""
        placements = None
        if _dtensor_module(three[1]) is not None:
            three, placements = self._placed(three, dim)
        with self._quiet():
            ins = [_local(t) for t in three]
            d = dim % (ins[1].ndim + 1)
            shape = list(ins[1].shape)
            shape.insert(d, self.n)
            loc = ins[1].unsqueeze(d).expand(shape).contiguous()
            out = loc
            if placements is not None:
                from torch.distributed.tensor import DTensor

                full = list(three[1].shape)
                full.insert(d, self.n)
                out = DTensor.from_local(
                    loc, three[1].device_mesh, placements, run_check=False,
                    shape=torch.Size(full),
                    stride=torch.empty(full, device="meta").stride())
        c = self.counter
        c.count.ops += c._mult
        c._moved(ins, [loc], _nbytes(ins[0]) + (self.n - 2) * _nbytes(ins[1])
                 + _nbytes(ins[2]) + _nbytes(loc))
        return out

    def _placed(self, three, dim: int):
        """``three`` moved as DTensor's stack moves its inputs
        (``redistribute_local_tensor`` to the placement it follows), and
        the stack's placement."""
        from torch.distributed.tensor import DTensor, Shard
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        from torch.distributed.tensor._redistribute import (
            redistribute_local_tensor,
        )

        with self._quiet():
            placements = torch.stack(list(three), dim).placements
        d = dim % (three[1].ndim + 1)
        target = tuple(Shard(p.dim - 1) if type(p) is Shard and p.dim > d
                       else p for p in placements)
        out = []
        for t, times in zip(three, (1, self.n - 2, 1)):
            if tuple(t.placements) != target:
                spec = DTensorSpec(t.device_mesh, target,
                                   tensor_meta=t._spec.tensor_meta)
                with self.times(times):
                    loc = redistribute_local_tensor(t._local_tensor, t._spec,
                                                    spec)
                with self._quiet():
                    t = DTensor.from_local(loc, t.device_mesh, target,
                                           run_check=False, shape=t.shape,
                                           stride=t.stride())
            out.append(t)
        return out, placements

    def keep_middle_grad(self, g: torch.Tensor) -> None:
        """The middle gradient slice lives n - 2 times over until the
        unbind's stack."""
        c = self.counter
        with self._quiet():
            got = c._buffers.get(_storage_key(_local(g)))
        if got is not None and self._end and not got[1].expired():
            c._kept.append((got[0], self.n - 2, self._end))


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
