"""Feed-forward layers: SwiGLU (llama family) and the GELU MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.init import spec
from repro_torch.sharding.activation import constrain

_FFN = ("batch", "seq", "ffn")


def swiglu_spec(d: int, f: int, dtype: str):
    return {
        "w_gate": spec((d, f), ("embed", "ffn"), dtype),
        "w_up": spec((d, f), ("embed", "ffn"), dtype),
        "w_down": spec((f, d), ("ffn", "embed"), dtype),
    }


def apply_swiglu(params, x: torch.Tensor) -> torch.Tensor:
    gate = constrain(torch.matmul(x, params["w_gate"]), _FFN)
    up = constrain(torch.matmul(x, params["w_up"]), _FFN)
    h = F.silu(gate.float()).to(x.dtype) * up
    return torch.matmul(h, params["w_down"])


def gelu_mlp_spec(d: int, f: int, dtype: str):
    return {
        "w_in": spec((d, f), ("embed", "ffn"), dtype),
        "b_in": spec((f,), ("ffn",), dtype, init="zeros"),
        "w_out": spec((f, d), ("ffn", "embed"), dtype),
        "b_out": spec((d,), ("embed",), dtype, init="zeros"),
    }


def apply_gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    h = constrain(torch.matmul(x, params["w_in"]) + params["b_in"], _FFN)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, params["w_out"]) + params["b_out"]
