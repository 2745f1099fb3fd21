"""The program's own spans in the traced slice: the ``repro_torch.<name>``
ranges that ``repro_torch.utils.trace`` opens while a profiler records,
on the thread that made the harness's calls, with the device work each
launched and the idle time inside it.

A device operation belongs to the innermost program span that was open
when its launch (the CUDA runtime call with the operation's correlation
id) ran on that thread, not to the span open when it ran on the device: a
kernel launched inside ``stream.tail`` that runs after the span closed is
the tail's. A span's device time is that of the operations it or the
spans inside it launched. Its idle time is the slice's idle gaps (no
device operation running) intersected with it, a gap across its edge
counting only inside.

Everything below :func:`of` works on plain tuples. A program without
spans (one older than ``repro_torch.utils.trace``) leaves the slice
without ``repro_torch.`` ranges, and every reader then returns None."""
from __future__ import annotations

import bisect
import functools
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "repro_torch."
SLICE = "bench.slice"
# Host calls that put work on the device; their correlation ids are those
# of the device operations they made.
LAUNCH = re.compile(r"^cu(da)?(Launch|Memcpy|Memset|GraphLaunch)")

Range = Tuple[str, int, int]                    # (name, start, end) ns
Op = Tuple[str, int, int, int]                  # (name, start, end, corr)


class ProgramSpans:
    """``ranges``: the program's spans on the serving thread, their names
    without the prefix; ``launches``: correlation id -> the time its launch
    ran on that thread; ``ops``: the device operations; ``gaps``: the
    slice's idle gaps; ``attrs``: per range, the attributes of the span it
    joins in the program's record, or None."""

    def __init__(self, ranges: Sequence[Range], launches: Dict[int, int],
                 ops: Sequence[Op], gaps: Sequence[Tuple[int, int]],
                 attrs: Optional[Sequence[Optional[dict]]] = None):
        order = sorted(range(len(ranges)),
                       key=lambda i: (ranges[i][1], -ranges[i][2]))
        self.ranges = [ranges[i] for i in order]
        self.attrs = ([attrs[i] for i in order] if attrs is not None
                      else [None] * len(order))
        self.gaps = sorted(gaps)
        self.ops = list(ops)
        self.parent = _parents(self.ranges)
        self._starts = [r[1] for r in self.ranges]
        self.owner = [self._innermost(launches.get(corr))
                      for _, _, _, corr in ops]
        own = [0] * len(self.ranges)
        for (_, a, b, _), i in zip(ops, self.owner):
            if i >= 0:
                own[i] += b - a
        self.device = own[:]
        for i in reversed(range(len(self.ranges))):
            if self.parent[i] >= 0:
                self.device[self.parent[i]] += self.device[i]

    def _innermost(self, t: Optional[int]) -> int:
        """The innermost range open at ``t``; -1 where none is (or the
        launch was not on the serving thread)."""
        if t is None:
            return -1
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.ranges[i][2] <= t:
            i = self.parent[i]
        return i

    def named(self, name: str) -> List[int]:
        return [i for i, r in enumerate(self.ranges) if r[0] == name]

    def children(self, i: int, name: Optional[str] = None) -> List[int]:
        return [j for j, p in enumerate(self.parent)
                if p == i and (name is None or self.ranges[j][0] == name)]

    def inside(self, i: int, name: str) -> List[int]:
        """Ranges of ``name`` nested anywhere inside range ``i``."""
        _, a, b = self.ranges[i]
        return [j for j in self.named(name) if j != i
                and a <= self.ranges[j][1] and self.ranges[j][2] <= b]

    def idle_pct(self, name: str) -> Optional[float]:
        """Share of the time inside the ranges of ``name`` in which no
        device operation ran; None without such ranges."""
        spans = [(a, b) for n, a, b in self.ranges if n == name and b > a]
        total = sum(b - a for a, b in spans)
        if not total:
            return None
        idle = sum(max(0, min(b, gb) - max(a, ga))
                   for a, b in spans for ga, gb in self.gaps)
        return 100.0 * idle / total


def _parents(ranges: List[Range]) -> List[int]:
    """Each range's enclosing range (-1 at the top): one sweep over the
    nested ranges in start order."""
    out, stack = [], []
    for i, (_, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] <= a:
            stack.pop()
        out.append(stack[-1] if stack else -1)
        stack.append(i)
    return out


@functools.lru_cache(maxsize=1)
def _reduce(prof, gaps: Tuple[Tuple[int, int], ...]) -> Optional[ProgramSpans]:
    from torch.autograd import DeviceType

    ranges, launches, ops = [], [], []
    bench: Counter = Counter()
    window = None
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation()
                    or name.startswith(("bench.", PREFIX))):
                ops.append((name, start, end, int(e.correlation_id())))
            continue
        if e.device_type() != DeviceType.CPU:
            continue
        thread = e.start_thread_id()
        if name == SLICE:
            window = (start, end)
        if name.startswith("bench."):
            bench[thread] += 1
        elif name.startswith(PREFIX):
            ranges.append((name[len(PREFIX):], start, end, thread))
        elif LAUNCH.match(name):
            launches.append((int(e.correlation_id()), start, thread))
    if window is None or not bench:
        return None
    main = bench.most_common(1)[0][0]
    mine = [r for r in ranges if r[3] == main
            and window[0] <= r[1] < window[1]]
    if not mine:
        return None
    return ProgramSpans([r[:3] for r in mine],
                        {c: t for c, t, th in launches if th == main},
                        ops, gaps, _attributes(mine))


def _attributes(ranges) -> List[Optional[dict]]:
    """Each range's attributes, from the program's record of the spans
    (joined by name and order on one thread); None where the program has
    no record or the join pairs nothing."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return [None] * len(ranges)
    paired = {r: s.attrs for s, r in trace.join(trace.spans(), ranges)}
    return [paired.get(r) for r in ranges]


def of(run) -> Optional[ProgramSpans]:
    """The program's spans of a run's traced slice; None without a slice
    or without program spans in it."""
    prof = getattr(run.record, "_done", None)
    if prof is None or run.trace is None:
        return None
    return _reduce(prof, tuple((a, b) for a, b, _ in run.trace.gaps))

