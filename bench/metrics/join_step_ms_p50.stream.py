"""Median host time of an engine step that admitted at least one request
(its prefills across the cut and the step's decode), before the traced
slice."""
import statistics


def read(run):
    ms = [(s["t1"] - s["t0"]) * 1e3
          for s in run.spans("join_step", part="before")]
    return statistics.median(ms) if ms else None
