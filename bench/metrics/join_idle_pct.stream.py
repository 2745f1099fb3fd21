"""Share of the time inside the traced slice's ``stream.join`` spans in
which no device operation ran: how far a join's host work (framing the
prompt's boundary, the wire round trip's syncs, seating) holds the device
idle (bench/program_spans.py)."""
from bench import program_spans


def read(run):
    p = program_spans.of(run)
    return None if p is None else p.idle_pct("stream.join")
