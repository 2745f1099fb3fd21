"""FLOPs and bytes of a Mamba2 hybrid decoder (IBM Granite 4.0-H), from
the configuration's shapes (Hugging Face ``granitemoehybrid`` key names).

FLOPs count two a multiply-accumulate: every projection (Mamba2's in and
out projections and depthwise conv, attention's q, k, v and output,
each layer's SwiGLU MLP), the attention's full score matrix (the masked
half too, as the dense decoder's count; a decode token against the whole
cache it reads), Mamba2's scan and the tied logits. A prefill's scan is
the chunked SSD the program runs above one chunk (its last chunk padded):
per chunk of ``Q`` steps the scores ``C B^T`` (Q^2 n), the intra-chunk
products (Q^2 h p), the chunk's end state and the carried state's output
(2 Q n h p); up to one chunk, and a decode token, the recurrence (the
state's update and its readout, 2 n h p a token).

Bytes: what one Mamba2 decode layer has to move at least, each input
read once and each output written once: its weights, the token's input
and output rows, and each live row's float32 SSM state and conv window,
read and written."""
from __future__ import annotations

import math
from typing import Dict, List


def kinds(m: dict) -> List[str]:
    """Each layer's kind: ``"mamba"`` or ``"attention"``."""
    return list(m["layer_types"])


def dims(m: dict) -> Dict[str, int]:
    d = m["hidden_size"]
    di = m["mamba_n_heads"] * m["mamba_d_head"]
    n = m["mamba_d_state"] * m["mamba_n_groups"]
    return {"d": d, "di": di, "n": n, "h": m["mamba_n_heads"],
            "p": m["mamba_d_head"], "w": m["mamba_d_conv"],
            "conv": di + 2 * n, "hd": d // m["num_attention_heads"]}


def mamba_fmacs_per_token(m: dict) -> float:
    g = dims(m)
    d, di, n, h = g["d"], g["di"], g["n"], g["h"]
    return d * (2 * di + 2 * n + h) + g["w"] * g["conv"] + di * d


def attention_fmacs_per_token(m: dict) -> float:
    d, hd = m["hidden_size"], dims(m)["hd"]
    h, kv = m["num_attention_heads"], m["num_key_value_heads"]
    return d * (h + 2 * kv) * hd + h * hd * d


def layer_fmacs_per_token(m: dict) -> List[float]:
    mlp = 3.0 * m["hidden_size"] * m["intermediate_size"]
    return [(mamba_fmacs_per_token(m) if k == "mamba"
             else attention_fmacs_per_token(m)) + mlp for k in kinds(m)]


def scan_prefill_flops(m: dict, s: int) -> float:
    """One Mamba2 layer's scan over a prompt of ``s`` tokens."""
    g = dims(m)
    q, n, hp = m["mamba_chunk_size"], g["n"], g["h"] * g["p"]
    if s <= q:
        return 2.0 * 2 * n * hp * s
    chunks = math.ceil(s / q)
    return 2.0 * chunks * (q * q * n + q * q * hp + 2 * q * n * hp)


def prefill_flops(m: dict, s: int) -> float:
    """One prompt of ``s`` tokens."""
    d, h, hd = m["hidden_size"], m["num_attention_heads"], dims(m)["hd"]
    n_attn = kinds(m).count("attention")
    fwd = 2.0 * sum(layer_fmacs_per_token(m)) * s
    fwd += 4.0 * h * s * s * hd * n_attn
    fwd += kinds(m).count("mamba") * scan_prefill_flops(m, s)
    return fwd + 2.0 * s * d * m["vocab_size"]


def decode_flops(m: dict, cache_len: int) -> float:
    """One decoded token against a cache of ``cache_len`` positions."""
    g = dims(m)
    d, h = g["d"], m["num_attention_heads"]
    fwd = 2.0 * sum(layer_fmacs_per_token(m))
    fwd += 4.0 * h * cache_len * g["hd"] * kinds(m).count("attention")
    fwd += kinds(m).count("mamba") * 2.0 * 2 * g["n"] * g["h"] * g["p"]
    return fwd + 2.0 * d * m["vocab_size"]


def mamba_weight_count(m: dict) -> int:
    """Elements of one Mamba2 mixer's weights: in_proj, conv weight and
    bias, A_log, D, dt_bias, the gated norm's scale, out_proj."""
    g = dims(m)
    d, di, h = g["d"], g["di"], g["h"]
    return (d * (2 * di + 2 * g["n"] + h) + (g["w"] + 1) * g["conv"]
            + 3 * h + di + di * d)


def ssm_decode_bytes(m: dict, live_rows: int, rows: int,
                     param_bytes: int = 2) -> int:
    """Bytes one Mamba2 decode layer moves at least for a step of ``rows``
    decode rows of which ``live_rows`` advance: the weights once, the
    ``rows`` input and output rows, and each live row's float32 SSM state
    and ``param_bytes`` conv window read and written."""
    g = dims(m)
    state = g["h"] * g["n"] * g["p"] * 4
    window = (g["w"] - 1) * g["conv"] * param_bytes
    return (mamba_weight_count(m) * param_bytes
            + 2 * rows * g["d"] * param_bytes
            + 2 * live_rows * (state + window))
