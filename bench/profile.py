"""One traced slice of a run's window: ``torch.profiler`` over whole calls
into the program, reduced to what the per-layer metrics read.

The harness marks each call it makes inside the slice with a
``record_function("bench.<span>")`` range and the whole slice with
``bench.slice``. The device's work is every CUDA event (kernels, copies,
sets); the device is busy where at least one runs. An idle gap is named
by the innermost host operation that was running at its middle, on the
thread that made the calls."""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SLICE = "bench.slice"
PREFIX = "bench."
# A kernel's name in the breakdown: its first characters.
NAME_CHARS = 160


@dataclass
class TraceSlice:
    window: Tuple[int, int]                         # ns, profiler clock
    kernels: List[Tuple[str, int, int]]             # (name, start, end)
    copies: List[Tuple[str, int, int]]              # memcpy / memset
    spans: List[Tuple[str, int, int]]               # the bench.<span> ranges
    busy_s: float = 0.0
    gaps: List[Tuple[int, int, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels_matching(self, pattern) -> List[Tuple[str, int, int]]:
        return [k for k in self.kernels if pattern.search(k[0])]

    def kernels_in(self, t0: int, t1: int) -> List[Tuple[str, int, int]]:
        """Kernels that started inside ``[t0, t1)``."""
        return [k for k in self.kernels if t0 <= k[1] < t1]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels + self.copies:
            ops[name[:NAME_CHARS]] += (b - a) * 1e-9
        idle: Dict[str, float] = defaultdict(float)
        for a, b, name in self.gaps:
            idle[name] += (b - a) * 1e-9
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:top]}


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int
           ) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _name_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[str, int, int]]
               ) -> List[Tuple[int, int, str]]:
    """Each gap with the innermost host operation open at its middle: one
    sweep over the host events (nested, in start order) and the gaps'
    middles."""
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    starts = [e[1] for e in host]
    out = []
    stack: List[Tuple[str, int, int]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            e = host[i]
            while stack and stack[-1][2] <= e[1]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        inner = [e[0] for e in stack if not e[0].startswith(PREFIX)]
        if inner:
            name = inner[-1]
        elif stack:
            name = stack[-1][0] + ".python"
        else:
            name = "host.python"
        out.append((a, b, name))
    return out


def summarize(prof) -> Optional[TraceSlice]:
    """The slice of a finished ``torch.profiler.profile``; None where the
    trace holds no ``bench.slice`` range."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host = [], []
    threads: Counter = Counter()
    for e in events:
        item = (e.name(), int(e.start_ns()),
                int(e.start_ns()) + int(e.duration_ns()))
        if e.device_type() == DeviceType.CUDA:
            # The harness's ranges are mirrored on the device's timeline;
            # they are no work of the device.
            if not (getattr(e, "is_user_annotation", bool)()
                    or item[0].startswith(PREFIX)):
                device.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append((item, e.start_thread_id()))
            if item[0].startswith(PREFIX):
                threads[e.start_thread_id()] += 1
    window = [h for h, _ in host if h[0] == SLICE]
    if not window:
        return None
    lo, hi = window[0][1], window[0][2]
    main = threads.most_common(1)[0][0]
    host_main = [h for h, t in host if t == main]
    copies = [d for d in device if d[0].startswith(("Memcpy", "Memset"))]
    kernels = [d for d in device if not d[0].startswith(("Memcpy", "Memset"))]
    busy = _union([(a, b) for _, a, b in device], lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    spans = sorted((h for h in host_main
                    if h[0].startswith(PREFIX) and h[0] != SLICE),
                   key=lambda h: h[1])
    return TraceSlice(window=(lo, hi), kernels=sorted(kernels, key=lambda k: k[1]),
                      copies=copies, spans=spans,
                      busy_s=sum(b - a for a, b in busy) * 1e-9,
                      gaps=_name_gaps(gaps, host_main))
