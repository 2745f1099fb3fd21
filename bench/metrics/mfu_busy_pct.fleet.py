"""ResNet-50's FLOPs of the images served in the traced slice over the
slice's device-busy seconds at the float32 peak outside the tensor cores
(the model runs float32 with TF32 off). Under an open loop at a fixed
rate the FLOPs of a window are fixed by the offered load, so only the
busy time shows a faster step."""
from bench.counts.peaks import F32_FLOPS


def read(run):
    t = run.trace
    work = sum(s["flops"] for s in run.spans("serve", part="traced"))
    if t is None or not work or t.busy_s <= 0:
        return None
    return 100.0 * work / (t.busy_s * F32_FLOPS)
