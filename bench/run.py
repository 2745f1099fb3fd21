"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with 2, printing no result, where the card or the cells' count of
cards is missing, and with 3 where JAX, Flax or the JAX package was loaded
in this process by the time the window closed."""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every cache of a kernel build stays at a fixed path in the checkout.
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "repro_torch")
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_ext"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.find_cell(ROOT, args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    outcome = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), STARTED, cell=cell)
    found = harness.banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.emit(outcome)
    return 0


if __name__ == "__main__":
    sys.exit(main())
