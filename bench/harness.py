"""One run of one cell: set-up, the measured window, the check of what
the program answered, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``bench/configs/<config>.json``), its traffic
mix (``bench/traffic/<traffic>.json``) and its cards;
``bench/workloads/<cell>.json`` holds only what is the cell's own (its
rate, the limits of its check). The configuration names its system
(``bench/systems/<system>.py``) and its family's plain reference
(``bench/reference/<family>.py``), the mix its kind
(``bench/traffic/<kind>.py``), and each per-layer metric is read by
``bench/metrics/<metric>.py``."""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")
# Draws of the check's sample come from their own stream of the seed.
CHECK_STREAM = 0x5EED


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict                     # the cell's entry in BENCHMARK.json
    config: dict
    mix: dict                       # the traffic mix, the cell's own keys over it
    own: dict                       # bench/workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    base = root / "bench"
    config = load_json(base / "configs" / f"{entry['config']}.json")
    own = load_json(base / "workloads" / f"{name}.json")
    mix = dict(load_json(base / "traffic" / f"{entry['traffic']}.json"))
    mix.update(own.get("traffic_params", {}))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in names]
    return Cell(name, entry, config, mix, own, e2e, per_layer)


def metric_reader(root: Path, name: str) -> Callable:
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(xs, q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear interpolation) of every
    sample; None without samples."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else None


@dataclass
class Record:
    """What a window recorded: the harness's spans around its calls into
    the program (host clock; each with the call's meta), per-request
    timings, and the traced slice."""

    slice_s: Optional[tuple] = None        # (start, length) in the window
    spans: List[dict] = field(default_factory=list)
    latencies_ms: List[float] = field(default_factory=list)
    late_ms: List[float] = field(default_factory=list)
    ttft_ms: List[float] = field(default_factory=list)
    itl_ms: List[float] = field(default_factory=list)
    tokens: int = 0
    attempted: int = 0
    answered: int = 0
    drain_s: float = 0.0
    window_start: float = 0.0
    window_end: float = 0.0
    requests: Any = None
    trace: Any = None
    gc_ms: List[float] = field(default_factory=list)
    _prof: Any = None
    _done: Any = None
    _slice_rf: Any = None

    @contextlib.contextmanager
    def span(self, name: str, t0: float):
        """Time one call into the program. A span is ``before`` the traced
        slice, ``traced`` inside it (under a ``bench.<name>`` range) or
        ``after`` it."""
        meta: Dict[str, Any] = {}
        rf = None
        if (self.slice_s and self._prof is None and self._done is None
                and time.perf_counter() - t0 >= self.slice_s[0]):
            self._start()
        if self._prof is not None:
            from torch.profiler import record_function

            rf = record_function("bench." + name)
            rf.__enter__()
        part = ("traced" if rf is not None
                else "after" if self._done is not None else "before")
        start = time.perf_counter()
        yield meta
        end = time.perf_counter()
        if rf is not None:
            rf.__exit__(None, None, None)
        self.spans.append(dict(name=name, t0=start, t1=end, part=part,
                               **meta))
        if self._prof is not None and end - t0 >= sum(self.slice_s):
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._slice_rf = record_function("bench.slice")
        self._slice_rf.__enter__()

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._slice_rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    def close(self) -> None:
        """After the window: end a slice still open, then reduce it."""
        from bench.profile import summarize

        if self._prof is not None:
            self._stop()
        if self._done is not None:
            self.trace = summarize(self._done)


@contextlib.contextmanager
def gc_pauses(into: List[float]):
    """Record the milliseconds of each full collection of Python's
    garbage collector inside the block (the program's heap, not the
    harness's, is what it walks)."""
    import gc

    t: Dict[str, float] = {}

    def note(phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            t["start"] = time.perf_counter()
        elif "start" in t:
            into.append((time.perf_counter() - t.pop("start")) * 1e3)

    gc.callbacks.append(note)
    try:
        yield
    finally:
        gc.callbacks.remove(note)


def warm_profiler() -> None:
    """Start the profiler once in set-up, so that the traced slice does
    not pay its first start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def end_to_end(rec: Record) -> Dict[str, Optional[float]]:
    window = rec.window_end - rec.window_start
    return {
        "req_ms_p50": percentile(rec.latencies_ms, 50),
        "tokens_per_s": rec.tokens / window if rec.tokens else None,
        "itl_ms_p95": percentile(rec.itl_ms, 95),
    }


@dataclass
class Outcome:
    result: dict
    checks: Dict[str, tuple]            # name -> (number, limit)
    system: Any = None


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             started: float, device: str = "cuda", cell: Cell = None,
             keep_system: bool = False) -> Outcome:
    """Set up, measure, check. ``started``: the process's start on the
    host clock (set-up is measured from it)."""
    import torch

    cell = cell or find_cell(root, name)
    system_mod = importlib.import_module(
        f"bench.systems.{cell.config['system']}")
    kind = importlib.import_module(f"bench.traffic.{cell.mix['kind']}")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    system = system_mod.System(cell.config, seed, device)
    rec = Record()
    kind.warm(system, cell.mix, seed, rec)
    if trace and on_card:
        warm_profiler()
        # The slice closes the window, so stopping the profiler delays no
        # call that a metric reads.
        length = min(cell.mix["trace_s"], seconds / 2)
        rec.slice_s = (seconds - length, length)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    with gc_pauses(rec.gc_ms):
        kind.drive(system, cell.mix, seed, seconds, rec)
    rec.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    system.close()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([seed, CHECK_STREAM])
    numbers = system.check(rng, cell.own["check_sample"],
                           **cell.own.get("check_args", {}))
    checks = {k: (v, cell.own["limits"][k]) for k, v in numbers.items()}
    failed = max(0, rec.attempted - rec.answered)
    correct = (rec.attempted > 0 and failed == 0
               and all(v <= lim for v, lim in checks.values()))
    if trace:
        values = {}
        for m in cell.per_layer:
            v = metric_reader(root, m["name"])(
                Run(cell, rec, rec.trace, seconds))
            if v is not None:
                values[m["name"]] = (v, m["unit"])
    else:
        e2e = end_to_end(rec)
        e2e["setup_s"] = setup_s
        values = {m["name"]: (e2e[m["name"]], m["unit"])
                  for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    result = {"correct": bool(correct), "attempted": int(rec.attempted),
              "failed": int(failed),
              "metrics": {k: {"value": v, "unit": u}
                          for k, (v, u) in values.items()},
              "device": {
                  "platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(0) if on_card
                           else "cpu"),
                  "count": int(cell.entry["chips"]),
                  "memory_peak_bytes": int(peak)}}
    if trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    call_ms = [(sp["t1"] - sp["t0"]) * 1e3 for sp in rec.spans]
    result["schedule"] = {
        "late_ms_p95": percentile(rec.late_ms, 95),
        # Too wide from run to run for a bound; shown, not compared.
        "req_ms_p95": percentile(rec.latencies_ms, 95),
        "ttft_ms_p90": percentile(rec.ttft_ms, 90),
        "drain_s": rec.drain_s, "window_s": rec.window_end - rec.window_start,
        "calls": len(rec.spans), "call_ms_p99": percentile(call_ms, 99),
        "call_ms_max": max(call_ms, default=None),
        "gc_full": len(rec.gc_ms), "gc_ms_max": max(rec.gc_ms, default=None),
        "gc_ms": sum(rec.gc_ms)}
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, (v, lim) in checks.items()}
    return Outcome(result, checks, system if keep_system else None)


@dataclass
class Run:
    """What a per-layer metric reads."""

    cell: Cell
    record: Record
    trace: Any
    seconds: float

    def spans(self, *names: str, part: Optional[str] = None) -> List[dict]:
        """The spans of ``names``, of one part of the window (``before``,
        ``traced``, ``after`` the slice) or all."""
        return [s for s in self.record.spans if s["name"] in names
                and (part is None or s["part"] == part)]


def banned_modules() -> List[str]:
    """Modules of JAX, Flax or the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def emit(outcome: Outcome) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, (v, lim) in outcome.checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome.result), flush=True)

