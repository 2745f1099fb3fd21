"""The bytes that the traced slice's Mamba2 decodes must move at least
(bench/counts/hybrid.py ``ssm_decode_bytes``: each layer's weights once,
each live row's float32 state and conv window read and written once) at
3.35 TB/s, over the device time launched inside their ``ssm.decode``
spans, on the engine steps that seated no request. A step's live rows
are its ``stream.step`` span's ``active``; its decode rows, each
``ssm.decode`` span's ``rows``. None where the program opens no such span
or its record gives no attributes."""
from bench import program_spans
from bench.counts import hybrid
from bench.counts.peaks import HBM_BYTES_PER_S


def read(run):
    p = program_spans.of(run)
    if p is None or not p.ops:
        return None
    m = run.cell.config["model"]
    need = 0
    device_ns = 0
    for i in p.named("stream.step"):
        layers = p.inside(i, "ssm.decode")
        if not layers or p.inside(i, "stream.join"):
            continue
        step = p.attrs[i]
        if step is None or any(p.attrs[j] is None for j in layers):
            return None
        need += sum(hybrid.ssm_decode_bytes(m, step["active"],
                                            p.attrs[j]["rows"])
                    for j in layers)
        device_ns += sum(p.device[j] for j in layers)
    if not device_ns:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / (device_ns * 1e-9)
