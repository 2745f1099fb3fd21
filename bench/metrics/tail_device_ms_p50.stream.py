"""Median, over the traced slice's engine steps that seated no request,
of the device time launched inside the step's ``stream.tail`` span: the
cloud tail's decode, its int8 KV cache's dequantization included
(bench/program_spans.py)."""
import statistics

from bench import program_spans


def read(run):
    p = program_spans.of(run)
    if p is None or not p.ops:
        return None
    ms = [sum(p.device[j] for j in p.children(i, "stream.tail")) * 1e-6
          for i in p.named("stream.step") if not p.inside(i, "stream.join")]
    return statistics.median(ms) if ms else None
