"""Median, over the traced slice's engine steps that seated no request,
of the device time launched inside the step's ``ssm.decode`` spans: every
Mamba2 layer's decode, head and tail, its state written back
(bench/program_spans.py). None where the program opens no such span."""
import statistics

from bench import program_spans


def read(run):
    p = program_spans.of(run)
    if p is None or not p.ops:
        return None
    ms = [sum(p.device[j] for j in p.inside(i, "ssm.decode")) * 1e-6
          for i in p.named("stream.step")
          if not p.inside(i, "stream.join") and p.inside(i, "ssm.decode")]
    return statistics.median(ms) if ms else None
