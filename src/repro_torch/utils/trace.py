"""Spans of the port's serving paths, on the device trace's clock.

A span marks one phase of serving: the fleet's decision, edge and cloud
phases, a token stream's join, head, wire, tail and token select, each
codec call and each wire-kernel launch::

    with span("fleet.edge", uid=r.uid, point=plan.point) as sp:
        ...
        if sp:
            sp.set(wire_bytes=blob.nbytes)

A span records only while a ``torch.profiler`` records on its thread, or
inside :func:`recording` (any thread). Otherwise ``span`` returns one
shared inert object: the cost is that check, with no allocation, lock or
clock read. While a profiler records, a span is also a
``record_function("repro_torch.<name>")`` range, so the kernels, launches
and idle gaps of the trace line up with it; the recorded span lies inside
its range (the range opens before the span's first clock read and closes
after its last), stamped on the same clock (Unix-epoch nanoseconds, the
profiler's), and :func:`join` pairs each with its range by name and order
on one thread.

A recorded span holds its name, start and end, its parent (the span open
on the same thread when it opened), its thread, its attributes, and the
request (``uid``) and engine step (``step``) it belongs to: the attribute
of that name, else its parent's. The record is a ring of :data:`RING`
spans: tracing left on for hours keeps the newest and holds no more.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

PREFIX = "repro_torch."
RING = 1 << 14

_profiling = torch._C._autograd._profiler_enabled
_ring: "collections.deque[Span]" = collections.deque(maxlen=RING)
_local = threading.local()
_seq = itertools.count(1)
_lock = threading.Lock()
_recording = 0                    # open recording() blocks, all threads


class Span:
    """One recorded span (see the module docstring). ``ranged``: it was
    also a profiler range."""

    __slots__ = ("name", "seq", "parent", "thread", "uid", "step", "attrs",
                 "start_ns", "end_ns", "ranged", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.seq = next(_seq)
        self.parent = parent.seq if parent else None
        self.thread = threading.get_ident()
        self.uid = self.attrs.get("uid", parent.uid if parent else None)
        self.step = self.attrs.get("step", parent.step if parent else None)
        self.ranged = _profiling()
        self._range = None
        if self.ranged:
            self._range = torch.autograd.profiler.record_function(
                PREFIX + self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        _local.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _ring.append(self)

    def __repr__(self) -> str:      # pragma: no cover - debug aid
        return (f"Span({self.name!r}, seq={self.seq}, parent={self.parent}, "
                f"uid={self.uid}, step={self.step}, {self.attrs})")


class _Off:
    """The span of a phase nobody records: enters, sets and exits as a
    no-op, and is false."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs: Any):
    """A span of ``name`` (``repro_torch.<name>`` in the trace): a
    recording :class:`Span` while a profiler records on this thread or
    :func:`recording` is open, else the shared inert one."""
    if _recording or _profiling():
        return Span(name, attrs)
    return _OFF


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record spans on every thread inside the block, without a profiler.
    The yielded list holds, after the block, the spans that opened and
    closed inside it in the order they opened (as many as the ring still
    holds)."""
    global _recording
    held: List[Span] = []
    with _lock:
        _recording += 1
    first = next(_seq)
    try:
        yield held
    finally:
        with _lock:
            _recording -= 1
        held[:] = [s for s in spans() if s.seq > first]


def spans() -> List[Span]:
    """Every span the ring holds, in the order they opened."""
    return sorted(list(_ring), key=lambda s: s.seq)


def clear() -> None:
    _ring.clear()


def tensor_bytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_span(counter: str, work: Callable[..., int]):
    """Decorate a kernel wrapper: each call is a span ``kernel.<counter>``
    (the launch counter's name) whose attribute ``bytes`` is ``work(result,
    *args, **kwargs)``, the bytes the operation needs: each input read
    once and each output written once, none of the kernel's own scratch.
    The span covers the operation on either route, the CUDA launch or the
    CPU tensor's plain version."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_recording or _profiling()):
                return fn(*args, **kwargs)
            with Span("kernel." + counter, {}) as sp:
                out = fn(*args, **kwargs)
                sp.set(bytes=work(out, *args, **kwargs))
                return out
        return call
    return wrap


Range = Tuple[str, int, int, Any]           # (name, start_ns, end_ns, thread)


def profile_ranges(prof) -> List[Range]:
    """The ``repro_torch.*`` ranges on the host of a finished
    ``torch.profiler.profile``, the prefix taken off their names."""
    from torch.autograd import DeviceType

    return [(e.name()[len(PREFIX):], int(e.start_ns()), int(e.end_ns()),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU
            and e.name().startswith(PREFIX)]


def join(recorded: Sequence[Span], ranges: Sequence[Range]
         ) -> List[Tuple[Span, Range]]:
    """Pair each recorded span that was a range with its range: by name and
    order on one thread. The profiler numbers its threads in its own way,
    so a thread of ranges pairs with the thread of spans whose names, in
    start order, are the same sequence; a thread with no such match pairs
    nothing. Spans recorded outside the ranges' time are left out."""
    if not ranges:
        return []
    lo = min(r[1] for r in ranges)
    hi = max(r[2] for r in ranges)
    mine: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in recorded:
        if s.ranged and lo <= s.start_ns <= hi:
            mine[s.thread].append(s)
    theirs: Dict[Any, List[Range]] = collections.defaultdict(list)
    for r in ranges:
        theirs[r[3]].append(r)
    out: List[Tuple[Span, Range]] = []
    free = {t: sorted(ss, key=lambda s: s.start_ns) for t, ss in mine.items()}
    for rs in theirs.values():
        rs = sorted(rs, key=lambda r: r[1])
        names = [r[0] for r in rs]
        match: Optional[int] = next(
            (t for t, ss in free.items() if [s.name for s in ss] == names),
            None)
        if match is not None:
            out.extend(zip(free.pop(match), rs))
    return out


__all__ = ["PREFIX", "RING", "Span", "span", "recording", "spans", "clear",
           "tensor_bytes", "kernel_span", "profile_ranges", "join"]
