"""Share of the time inside the program's ``fleet.serve`` spans of the
traced slice in which no device operation ran: the fleet server's host
path, while a wave is being served (bench/program_spans.py)."""
from bench import program_spans


def read(run):
    p = program_spans.of(run)
    return None if p is None else p.idle_pct("fleet.serve")
