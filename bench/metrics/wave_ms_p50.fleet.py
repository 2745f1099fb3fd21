"""Median host time of one ``FleetServer.serve(wave)`` call, answers on the
host, over the window's calls before the traced slice."""
import statistics


def read(run):
    ms = [(s["t1"] - s["t0"]) * 1e3
          for s in run.spans("serve", part="before")]
    return statistics.median(ms) if ms else None
