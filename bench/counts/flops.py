"""FLOPs of the work a cell serves, from the configuration's shapes; each
family's reference module (``bench/reference/<family>.py``) binds its own.

A CNN: two FLOPs a multiply-accumulate of every convolution and the
classifier of its layer list. The decoder: the port's analytic count of a dense decoder
(``models/api.py`` ``analytic_step_flops``, copied and frozen): the
matrix products, the attention's full score matrix (the masked half
too, as the dense prefill computes it; a decode token against the whole
cache it reads) and the tied logits."""
from __future__ import annotations



def cnn_flops_per_image(layers) -> float:
    """``layers``: (name, kind, geometry) as ``reference/resnet.py``'s."""
    total = 0.0
    for _, kind, g in layers:
        if kind == "conv":
            o = g["hw"] // g["stride"]
            total += o * o * g["cout"] * g["cin"] * g["k"] ** 2
        elif kind == "unit":
            o = g["hw"] // g["stride"]
            ci, cm, co = g["cin"], g["cmid"], g["cout"]
            total += o * o * (cm * ci + cm * cm * 9 + co * cm)
            if ci != co or g["stride"] != 1:
                total += o * o * co * ci
        elif kind == "fc":
            total += g["fin"] * g["fout"]
    return 2.0 * total


def _block_fmacs_per_token(cfg: dict) -> float:
    d, h, kv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // h
    return d * (h + 2 * kv) * hd + h * hd * d + 3.0 * d * cfg["d_ff"]


def decoder_prefill_flops(cfg: dict, s: int) -> float:
    """One prompt of ``s`` tokens."""
    d, h = cfg["d_model"], cfg["num_heads"]
    L = cfg["num_layers"]
    fwd = 2.0 * _block_fmacs_per_token(cfg) * L * s
    fwd += 4.0 * h * s * s * (d // h) * L
    return fwd + 2.0 * s * d * cfg["vocab_size"]


def decoder_decode_flops(cfg: dict, cache_len: int) -> float:
    """One decoded token against a cache of ``cache_len`` positions."""
    d, h = cfg["d_model"], cfg["num_heads"]
    L = cfg["num_layers"]
    fwd = 2.0 * _block_fmacs_per_token(cfg) * L
    fwd += 4.0 * h * cache_len * (d // h) * L
    return fwd + 2.0 * d * cfg["vocab_size"]
