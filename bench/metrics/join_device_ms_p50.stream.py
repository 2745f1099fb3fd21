"""Median, over the traced slice's ``stream.join`` spans, of the device
time launched inside one: a prompt's prefill across the cut, head, wire
round trip and tail (bench/program_spans.py)."""
import statistics

from bench import program_spans


def read(run):
    p = program_spans.of(run)
    if p is None or not p.ops:
        return None
    ms = [p.device[i] * 1e-6 for i in p.named("stream.join")]
    return statistics.median(ms) if ms else None
