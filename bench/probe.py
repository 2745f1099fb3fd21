"""Measurements that define a cell, not part of its runs.

    python3 bench/probe.py sweep --workload <cell> --seed <n> --seconds <s> --rates 60,80,...
    python3 bench/probe.py controls --workload <cell> --seeds <n,...> --seconds <s>

``sweep`` sets an open-loop cell up once and offers each rate in turn for
``seconds``: the tail, how late the loop ran and the drain, to find the
highest rate the program sustains. ``controls`` sets the cell up a seed
at a time, serves a short window, and prints the program's compared
numbers beside the control's (the plain reference in the next lower
precision in the program's place), on the same sample.

    python3 bench/probe.py edges --workload <cell> --seeds <n,...> --seconds <s> --edges 0,1e-5,...

``edges`` (a fleet cell) serves a window a seed, then for the sampled
requests cut at the last layer, whose served logits are the wire's own
codes, reads how far each sound float32 path lies from the plain
reference before the rounding, in codes: the program's head run alone,
the reference on one frame at a time, the reference channels-last; and
the TF32 reference's distance. It prints the compared number of the
program and of the control at each ``code_edge`` of ``--edges``, and the
distance to a rounding edge of every code the program served moved."""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from bench import harness  # noqa: E402
from bench.reference import quant  # noqa: E402


def _setup(cell, seed):
    system = importlib.import_module(
        f"bench.systems.{cell.config['system']}").System(cell.config, seed,
                                                         "cuda")
    kind = importlib.import_module(f"bench.traffic.{cell.mix['kind']}")
    rec = harness.Record()
    kind.warm(system, cell.mix, seed, rec)
    return system, kind, rec


def sweep(cell, seed, seconds, rates):
    import torch

    t = time.perf_counter()
    system, kind, _ = _setup(cell, seed)
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    for i, rate in enumerate(rates):
        mix = dict(cell.mix, rate_per_s=rate)
        rec = harness.Record()
        kind.drive(system, mix, seed + i, seconds, rec)
        torch.cuda.synchronize()
        waves = [s["requests"] for s in rec.spans]
        print(json.dumps({
            "rate": rate, "requests": rec.attempted,
            "req_ms_p50": harness.percentile(rec.latencies_ms, 50),
            "req_ms_p95": harness.percentile(rec.latencies_ms, 95),
            "late_ms_p95": harness.percentile(rec.late_ms, 95),
            "drain_s": rec.drain_s, "calls": len(rec.spans),
            "wave_mean": float(np.mean(waves)) if waves else 0,
            "wave_ms_p50": harness.percentile(
                [(s["t1"] - s["t0"]) * 1e3 for s in rec.spans], 50),
            "groups_mean": float(np.mean([n for s in rec.spans
                                          for n in s["group_sizes"]] or [0])),
        }), flush=True)
    served = Counter(str(p) for u, (_, p) in system.answers.items() if u >= 0)
    print(json.dumps({"plans": served.most_common(12)}), flush=True)


def controls(cell, seeds, seconds, sample):
    import torch

    for seed in seeds:
        t = time.perf_counter()
        system, kind, rec = _setup(cell, seed)
        setup = time.perf_counter() - t
        kind.drive(system, cell.mix, seed, seconds, rec)
        torch.cuda.synchronize()
        system.close()
        torch.cuda.empty_cache()
        out = {"seed": seed, "setup_s": setup, "attempted": rec.attempted}
        for label, control in (("program", False), ("control", True)):
            rng = np.random.default_rng([seed, harness.CHECK_STREAM])
            t = time.perf_counter()
            out[label] = system.check(rng, sample, control=control,
                                      **cell.own.get("check_args", {}))
            out[label + "_s"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        del system
        torch.cuda.empty_cache()


def _code_units(b, bits, codec):
    return quant.codes(b, bits, quant.codec_dims(b, codec))[3]


def _quantiles(xs):
    xs = np.concatenate([np.ravel(x) for x in xs]) if xs else np.zeros(1)
    return [float(np.quantile(xs, q)) for q in (0.5, 0.99, 1.0)]


def edges(cell, seeds, seconds, sample, candidates):
    import torch

    for seed in seeds:
        system, kind, rec = _setup(cell, seed)
        kind.drive(system, cell.mix, seed, seconds, rec)
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rng = np.random.default_rng([seed, harness.CHECK_STREAM])
        pool = sorted(u for u in system.answers if u >= 0)
        picked = rng.choice(pool, size=min(sample, len(pool)), replace=False)
        model, ref, m = system.fleet.engine.model, system.ref, system.m
        last = len(ref.layers(m)) - 1
        d = {"program": [], "frames": [], "channels_last": [], "tf32": []}
        moved, plans = [], Counter()
        with torch.no_grad():
            for uid in picked:
                served, plan = system.answers[int(uid)]
                plans[str(plan)] += 1
                point, bits, codec = plan
                if point != last:
                    continue
                x = system._input(int(uid))
                b = ref.forward(m, system.params, x, 0, point + 1)
                u = _code_units(b, bits, codec)
                cl = {k: {n: (t.contiguous(memory_format=torch.channels_last)
                              if t.ndim == 4 else t) for n, t in v.items()}
                      for k, v in system.params.items()}
                alt = {
                    "program": model.run_head(system.params, {"images": x},
                                              point),
                    "frames": torch.cat([ref.forward(m, system.params,
                                                     x[i:i + 1], 0, point + 1)
                                         for i in range(x.shape[0])]),
                    "channels_last": ref.forward(
                        m, cl, x.contiguous(memory_format=torch.channels_last),
                        0, point + 1),
                    "tf32": ref.forward(m, system.params, x, 0, point + 1,
                                        "tf32")}
                for k, v in alt.items():
                    d[k].append((_code_units(v, bits, codec) - u).abs()
                                .cpu().numpy())
                want = quant.codec_qdq(b, bits, codec)
                step = float((b.max() - b.min()) / ((1 << bits) - 1))
                got = torch.from_numpy(served).to(want.device)
                off = ((got - want).abs() > 0.5 * step).nonzero(as_tuple=True)
                frac = u[off] - torch.floor(u[off])
                moved += [float(v) for v in (frac - 0.5).abs().cpu()]
        out = {"seed": seed, "attempted": rec.attempted, "plans": plans,
               "codes_from_reference_p50_p99_max":
                   {k: _quantiles(v) for k, v in d.items()},
               "moved_codes_edge_distance": moved}
        system.close()
        torch.cuda.empty_cache()
        for e in candidates:
            for label, control in (("program", False), ("control", True)):
                rng = np.random.default_rng([seed, harness.CHECK_STREAM])
                out[f"{label}@{e:g}"] = system.check(
                    rng, sample, control=control, code_edge=e)[
                        "logits_rel_err"]
        print(json.dumps(out), flush=True)
        del system
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("sweep", "controls", "edges"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--sample", type=int, default=0)
    ap.add_argument("--edges", default="0")
    args = ap.parse_args()
    cell = harness.find_cell(ROOT, args.workload)
    if args.mode == "sweep":
        sweep(cell, args.seed, args.seconds,
              [float(r) for r in args.rates.split(",")])
    elif args.mode == "edges":
        edges(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
              args.sample or cell.own["check_sample"],
              [float(e) for e in args.edges.split(",")])
    else:
        controls(cell, [int(s) for s in args.seeds.split(",")],
                 args.seconds, args.sample or cell.own["check_sample"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
