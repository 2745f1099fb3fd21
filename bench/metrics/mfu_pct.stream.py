"""The decoder's FLOPs of the prompt and output tokens processed in the
traced slice (bench/counts/flops.py) over the slice at the bfloat16
peak."""
from bench.counts.peaks import BF16_FLOPS


def read(run):
    t = run.trace
    work = sum(s["flops"] for s in run.spans("decode_step", "join_step",
                                             part="traced"))
    if t is None or not work:
        return None
    return 100.0 * work / (t.window_s * BF16_FLOPS)
