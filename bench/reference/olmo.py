"""OLMo-1B (arXiv:2402.00838) as the served program lays it out: a dense
decoder with non-parametric LayerNorm, rotary positions (half-split),
SwiGLU and tied embeddings, its layers stacked on a leading axis. Plain
float32 PyTorch over a whole sequence at once: no KV cache, no batching.

A served token stream crosses a JALAD cut after layer ``point``: the
boundary of the prompt crosses as one tensor and each later position's
row alone, both min-max quantized to ``bits``; the cloud's tail keeps its
keys and values as symmetric int8 rows, so every position after the
prompt attends to them, while the prompt attends to its own keys and
values unquantized (a prefill computes its attention before it stores
the cache). ``forward`` takes that served path in plain arithmetic when
given ``point``; without it, the unsplit model."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from bench.counts import flops
from bench.reference.lowp import rounder
from bench.reference.quant import int8_row_qdq, minmax_qdq

PORT_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
             "vocab_size", "rope_theta")


def port_overrides(cfg: dict) -> dict:
    """The keys of the program's configuration that ``cfg`` sets."""
    return {k: cfg[k] for k in PORT_KEYS}


def prefill_flops(cfg: dict, s: int) -> float:
    return flops.decoder_prefill_flops(cfg, s)


def decode_flops(cfg: dict, cache_len: int) -> float:
    return flops.decoder_decode_flops(cfg, cache_len)


def layout(cfg: dict) -> Dict[str, object]:
    """Parameter tree: leaf -> (shape, fan_in); the embedding's fan-in is
    the string ``"embed"`` (its own scale), a parameterless norm ``{}``."""
    L, d, h = cfg["num_layers"], cfg["d_model"], cfg["num_heads"]
    kv, f = cfg["num_kv_heads"], cfg["d_ff"]
    hd = d // h
    return {
        "embed": ((cfg["vocab_size"], d), "embed"),
        "final_norm": {},
        "segments": [{
            "ln1": {},
            "attn": {"wq": ((L, d, h, hd), d), "wk": ((L, d, kv, hd), d),
                     "wv": ((L, d, kv, hd), d), "wo": ((L, h, hd, d), h * hd)},
            "ln2": {},
            "mlp": {"w_gate": ((L, d, f), d), "w_up": ((L, d, f), d),
                    "w_down": ((L, f, d), f)},
        }],
    }


def _ln(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * (var + 1e-5) ** -0.5


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, prompt: Optional[int], int8_kv: bool):
    """Causal attention of (S, h, hd) ``q`` over ``k``, ``v``; with
    ``int8_kv`` the positions from ``prompt`` on read int8 rows."""
    s, h, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()

    def core(kk, vv):
        kk = kk.repeat_interleave(g, dim=1)
        vv = vv.repeat_interleave(g, dim=1)
        sc = torch.einsum("qhk,shk->hqs", q, kk) * hd ** -0.5
        sc = sc.masked_fill(~mask, float("-inf"))
        return torch.einsum("hqs,shk->qhk", torch.softmax(sc, -1), vv)

    out = core(k, v)
    if int8_kv and prompt is not None and prompt < s:
        late = core(int8_row_qdq(k), int8_row_qdq(v))
        out = torch.cat([out[:prompt], late[prompt:]], dim=0)
    return out


@torch.no_grad()
def forward(cfg: dict, params: dict, tokens: torch.Tensor,
            point: Optional[int] = None, prompt: Optional[int] = None,
            bits: int = 8, int8_kv: bool = False,
            precision: str = "f32") -> torch.Tensor:
    """Logits (S, V) in float32 of a (S,) token sequence. ``point``,
    ``prompt``, ``bits`` and ``int8_kv`` give the served path across a cut
    (see the module docstring); ``precision="fp8"`` rounds the operands
    of every projection to float8 e4m3, one scale a tensor."""
    rnd = rounder(precision)

    def mm(a, w):
        a, w = a.float(), w.float()
        if rnd is not None:
            a, w = rnd(a), rnd(w)
        return a @ w

    d, theta = cfg["d_model"], float(cfg["rope_theta"])
    h, kvh = cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // h
    emb = params["embed"].float()
    x = emb[tokens] * math.sqrt(d)
    seg = params["segments"][0]
    s = tokens.shape[0]
    for i in range(cfg["num_layers"]):
        a, m = ({k: w[i] for k, w in seg[n].items()} for n in ("attn", "mlp"))
        tail = point is not None and i > point
        hn = _ln(x)
        q = _rope(mm(hn, a["wq"].reshape(d, h * hd)).view(s, h, hd), theta)
        k = _rope(mm(hn, a["wk"].reshape(d, kvh * hd)).view(s, kvh, hd),
                  theta)
        v = mm(hn, a["wv"].reshape(d, kvh * hd)).view(s, kvh, hd)
        o = _attend(q, k, v, prompt, int8_kv and tail)
        x = x + mm(o.reshape(s, h * hd), a["wo"].reshape(h * hd, d))
        hn = _ln(x)
        gate = torch.nn.functional.silu(mm(hn, m["w_gate"]))
        x = x + mm(gate * mm(hn, m["w_up"]), m["w_down"])
        if point is not None and i == point:
            p = s if prompt is None else prompt
            x = torch.cat([minmax_qdq(x[:p], bits),
                           minmax_qdq(x[p:], bits, (1,))], dim=0)
    return mm(_ln(x), emb.t())
