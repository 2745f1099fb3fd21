"""Device kernels a decode step: kernels that started inside each traced
decode step's range, averaged over those steps."""


def read(run):
    if run.trace is None:
        return None
    steps = [s for s in run.trace.spans if s[0] == "bench.decode_step"]
    if not steps:
        return None
    return sum(len(run.trace.kernels_in(a, b)) for _, a, b in steps) \
        / len(steps)
