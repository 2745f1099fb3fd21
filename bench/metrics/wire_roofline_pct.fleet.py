"""The wire kernels' share of their HBM roofline in the traced slice, read
from the program's own spans: the bytes of the slice's ``kernel.*`` spans
(each launch's inputs read once and outputs written once, as the program
counts them) at 3.35 TB/s, over the device time of the operations
launched inside those spans (bench/program_spans.py). None where a kernel
span's bytes are not known."""
from bench import program_spans
from bench.counts.peaks import HBM_BYTES_PER_S


def read(run):
    p = program_spans.of(run)
    if p is None:
        return None
    kernels = [i for i, r in enumerate(p.ranges)
               if r[0].startswith("kernel.")]
    work = [(p.attrs[i] or {}).get("bytes") for i in kernels]
    spent = sum(p.device[i] for i in kernels) * 1e-9
    if not kernels or None in work or spent <= 0:
        return None
    return 100.0 * sum(work) / HBM_BYTES_PER_S / spent
