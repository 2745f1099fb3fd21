"""IBM Granite 4.0-H (Hugging Face ``granitemoehybrid``; granite-4.0-h-micro)
as the served program lays it out: Mamba2 and NoPE GQA attention layers,
each followed by its own SwiGLU MLP, with muP scalars, tied embeddings.
Plain float32 PyTorch over a whole sequence at once: no cache, no
batching, no chunked scan.

    x_0 = e * E[t]
    x <- x + r * mixer(RMSNorm(x))          mixer: Mamba2 or attention
    x <- x + r * W_down(silu(W_g h) * W_u h),   h = RMSNorm(x)
    logits = RMSNorm(x) E^T / l

with ``e`` = ``embedding_multiplier``, ``r`` = ``residual_multiplier``, ``l``
= ``logits_scaling``, and attention scores scaled by
``attention_multiplier``. The Mamba2 mixer: ``in_proj`` to [z, xBC, dt], a
causal depthwise conv with a bias and SiLU on xBC, ``dt = softplus(dt +
dt_bias)``, ``A = -exp(A_log)``, then the scan in its quadratic (masked,
decayed) form

    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < k <= t} dt_k A) dt_s x_s
          + D x_t,

in blocks of query positions, the cumulative decay in float64; then the
gated RMSNorm of ``y * silu(z)`` and ``out_proj``.

Departures from Hugging Face's code, none of them in the mathematics:
float32 throughout (the published model runs bfloat16, its scan float32);
the scan by the quadratic form, not HF's chunked scan or its recurrence
(equal in exact arithmetic); one group (``mamba_n_groups`` 1, the
published value); no ``time_step_limit`` clamp (HF's default, (0, inf), is
none). The weights are drawn (``bench/weights.py``), not the checkpoint.

A served token stream crosses the cut after layer ``point``, as
``reference/olmo.py`` describes: the prompt's boundary as one tensor and
each later row alone, min-max quantized to ``bits``; with ``int8_kv`` the
tail's attention reads int8 key and value rows from ``prompt`` on. The
Mamba2 state crosses nothing: each side keeps its own."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench.counts import hybrid
from bench.reference.lowp import rounder
from bench.reference.quant import int8_row_qdq, minmax_qdq

# The program holds Mamba2 heads of 64 and scans in chunks of 256.
PORT_HEAD_DIM = 64
PORT_CHUNK = 256
# Query positions a block of the scan and of attention: their score
# blocks stay ~1 GB at 8,192 positions.
SCAN_BLOCK = 256
ATTN_BLOCK = 1024
KIND = {"mamba": "M", "attention": "d"}


def _check(cfg: dict) -> None:
    g = hybrid.dims(cfg)
    fixed = {"mamba_d_head": PORT_HEAD_DIM, "mamba_n_groups": 1,
             "mamba_chunk_size": PORT_CHUNK,
             "position_embedding_type": "nope", "tie_word_embeddings": True,
             "mamba_conv_bias": True, "mamba_proj_bias": False,
             "attention_bias": False}
    off = {k: cfg[k] for k, v in fixed.items() if cfg[k] != v}
    if off or g["di"] != cfg["mamba_expand"] * g["d"]:
        raise ValueError(f"the program cannot hold {off or 'this width'}")


def port_overrides(cfg: dict) -> dict:
    """The keys of the program's configuration that ``cfg`` sets."""
    _check(cfg)
    return {"num_layers": cfg["num_hidden_layers"],
            "d_model": cfg["hidden_size"],
            "num_heads": cfg["num_attention_heads"],
            "num_kv_heads": cfg["num_key_value_heads"],
            "head_dim": hybrid.dims(cfg)["hd"],
            "d_ff": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"],
            "ssm_state_dim": cfg["mamba_d_state"],
            "ssm_conv_width": cfg["mamba_d_conv"],
            "ssm_expand": cfg["mamba_expand"],
            "block_pattern": "".join(KIND[k] for k in cfg["layer_types"]),
            "embedding_multiplier": float(cfg["embedding_multiplier"]),
            "residual_multiplier": float(cfg["residual_multiplier"]),
            "attention_multiplier": float(cfg["attention_multiplier"]),
            "logits_scaling": float(cfg["logits_scaling"])}


def prefill_flops(cfg: dict, s: int) -> float:
    return hybrid.prefill_flops(cfg, s)


def decode_flops(cfg: dict, cache_len: int) -> float:
    return hybrid.decode_flops(cfg, cache_len)


def _runs(cfg: dict) -> List[Tuple[str, int]]:
    """The layer types as runs of one kind: the program's segments."""
    out: List[Tuple[str, int]] = []
    for k in cfg["layer_types"]:
        if out and out[-1][0] == k:
            out[-1] = (k, out[-1][1] + 1)
        else:
            out.append((k, 1))
    return out


def layout(cfg: dict) -> Dict[str, object]:
    """Parameter tree: leaf -> (shape, fan_in). The embedding's fan-in is
    ``"embed"`` (its own scale); a norm's scale, ``D`` and the conv take a
    fan-in of 1, 1 and the conv's width; ``conv_b``, ``A_log`` and
    ``dt_bias`` None (zeros: A = -1, dt = softplus(dt))."""
    g = hybrid.dims(cfg)
    d, di, n, h, hd = g["d"], g["di"], g["n"], g["h"], g["hd"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    f = cfg["intermediate_size"]

    def norm(L):
        return {"scale": ((L, d), 1)}

    def segment(kind: str, L: int) -> dict:
        mlp = {"w_gate": ((L, d, f), d), "w_up": ((L, d, f), d),
               "w_down": ((L, f, d), f)}
        if kind == "attention":
            return {"ln1": norm(L),
                    "attn": {"wq": ((L, d, heads, hd), d),
                             "wk": ((L, d, kv, hd), d),
                             "wv": ((L, d, kv, hd), d),
                             "wo": ((L, heads, hd, d), heads * hd)},
                    "ln2": norm(L), "mlp": mlp}
        return {"ln": norm(L),
                "mamba": {"in_proj": ((L, d, 2 * di + 2 * n + h), d),
                          "conv_w": ((L, g["w"], g["conv"]), g["w"]),
                          "conv_b": ((L, g["conv"]), None),
                          "A_log": ((L, h), None), "D": ((L, h), 1),
                          "dt_bias": ((L, h), None),
                          "norm_scale": ((L, di), 1),
                          "out_proj": ((L, di, d), di)},
                "ln2": norm(L), "mlp": mlp}

    return {"embed": ((cfg["vocab_size"], d), "embed"),
            "final_norm": {"scale": ((d,), 1)},
            "segments": [segment(k, L) for k, L in _runs(cfg)]}


def _layers(cfg: dict, params: dict) -> Iterator[Tuple[str, dict]]:
    """Each layer's kind and its own slice of the stacked parameters."""
    def pick(tree, j):
        if isinstance(tree, dict):
            return {k: pick(v, j) for k, v in tree.items()}
        return tree[j]

    for (kind, L), seg in zip(_runs(cfg), params["segments"]):
        for j in range(L):
            yield kind, pick(seg, j)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _scan(x, dt, A, B, C) -> torch.Tensor:
    """The quadratic form of the scan (module docstring) without ``D``:
    x (S, h, p), dt (S, h), A (h,), B, C (S, n) -> (S, h, p)."""
    s = x.shape[0]
    cum = torch.cumsum(dt.double() * A.double(), dim=0)          # (S, h)
    y = torch.empty_like(x)
    for t0 in range(0, s, SCAN_BLOCK):
        t1 = min(s, t0 + SCAN_BLOCK)
        seg = cum[t0:t1, None] - cum[None, :t1]                   # (q, s, h)
        later = (torch.arange(t0, t1, device=x.device)[:, None]
                 < torch.arange(t1, device=x.device)[None])
        seg = seg.masked_fill(later[..., None], float("-inf"))
        w = torch.exp(seg).float() * dt[None, :t1] \
            * (C[t0:t1] @ B[:t1].t())[..., None]
        y[t0:t1] = torch.einsum("qsh,shp->qhp", w, x[:t1])
    return y


def _mamba(cfg: dict, p: dict, h: torch.Tensor, mm) -> torch.Tensor:
    g = hybrid.dims(cfg)
    di, n, width = g["di"], g["n"], g["w"]
    s = h.shape[0]
    proj = mm(h, p["in_proj"])
    z, xbc, dt = proj[:, :di], proj[:, di:di + g["conv"]], \
        proj[:, di + g["conv"]:]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    w = p["conv_w"].float()
    xbc = F.silu(sum(pad[i:i + s] * w[i] for i in range(width))
                 + p["conv_b"].float())
    x = xbc[:, :di].reshape(s, g["h"], g["p"])
    B, C = xbc[:, di:di + n], xbc[:, di + n:]
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = _scan(x, dt, A, B, C) + p["D"].float()[:, None] * x
    y = y.reshape(s, di) * F.silu(z)
    y = _rms(y, p["norm_scale"], cfg["rms_norm_eps"])
    return mm(y, p["out_proj"])


def _attention(cfg: dict, p: dict, h: torch.Tensor, mm,
               prompt: Optional[int], int8_kv: bool) -> torch.Tensor:
    """Causal NoPE GQA attention, query blocks; with ``int8_kv`` the
    positions from ``prompt`` on read int8 key and value rows."""
    s, d = h.shape
    heads, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = hybrid.dims(cfg)["hd"]
    q = mm(h, p["wq"].reshape(d, heads * hd)).view(s, heads, hd)
    k = mm(h, p["wk"].reshape(d, kvh * hd)).view(s, kvh, hd)
    v = mm(h, p["wv"].reshape(d, kvh * hd)).view(s, kvh, hd)
    g = heads // kvh
    pairs = [(k, v)]
    if int8_kv and prompt is not None and prompt < s:
        pairs.append((int8_row_qdq(k), int8_row_qdq(v)))
    pairs = [(kk.repeat_interleave(g, 1), vv.repeat_interleave(g, 1))
             for kk, vv in pairs]
    out = torch.empty_like(q)
    for t0 in range(0, s, ATTN_BLOCK):
        t1 = min(s, t0 + ATTN_BLOCK)
        later = (torch.arange(t0, t1, device=h.device)[:, None]
                 < torch.arange(t1, device=h.device)[None])
        rows = []
        for kk, vv in pairs:
            sc = torch.einsum("qhk,shk->hqs", q[t0:t1], kk[:t1]) \
                * cfg["attention_multiplier"]
            sc = sc.masked_fill(later, float("-inf"))
            rows.append(torch.einsum("hqs,shk->qhk", torch.softmax(sc, -1),
                                     vv[:t1]))
        o = rows[0]
        if len(rows) > 1:
            o = torch.where((torch.arange(t0, t1, device=h.device)
                             >= prompt)[:, None, None], rows[1], o)
        out[t0:t1] = o
    return mm(out.reshape(s, heads * hd), p["wo"].reshape(heads * hd, d))


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor,
            point: Optional[int] = None, prompt: Optional[int] = None,
            bits: int = 8, int8_kv: bool = False,
            precision: str = "f32") -> torch.Tensor:
    """Logits (S, V) in float32 of a (S,) token sequence. ``point``,
    ``prompt``, ``bits`` and ``int8_kv`` give the served path across a cut
    (module docstring); ``precision="fp8"`` rounds the operands of every
    projection to float8 e4m3, one scale a tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rnd = rounder(precision)

    def mm(a, w):
        a, w = a.float(), w.float()
        if rnd is not None:
            a, w = rnd(a), rnd(w)
        return a @ w

    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    emb = params["embed"].float()
    x = emb[tokens] * cfg["embedding_multiplier"]
    s = tokens.shape[0]
    for i, (kind, p) in enumerate(_layers(cfg, params)):
        if kind == "mamba":
            y = _mamba(cfg, p["mamba"], _rms(x, p["ln"]["scale"], eps), mm)
        else:
            y = _attention(cfg, p["attn"], _rms(x, p["ln1"]["scale"], eps),
                           mm, prompt,
                           int8_kv and point is not None and i > point)
        x = x + r * y
        h = _rms(x, p["ln2"]["scale"], eps)
        m = p["mlp"]
        x = x + r * mm(F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"]),
                       m["w_down"])
        if point is not None and i == point:
            q = s if prompt is None else prompt
            x = torch.cat([minmax_qdq(x[:q], bits),
                           minmax_qdq(x[q:], bits, (1,))], dim=0)
    x = _rms(x, params["final_norm"]["scale"], eps)
    return mm(x, emb.t()) / cfg["logits_scaling"]
