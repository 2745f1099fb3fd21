"""Mixture-of-Experts layer (top-k routing, group-wise capacity dispatch).

The reference's "dropping" MoE: tokens are routed in groups of
``group_size`` along the sequence of each row, and each expert takes at
most ``capacity`` (token, choice) pairs of a group, in token-major, then
choice-rank order; a choice past capacity is dropped (its weight is lost,
not moved to another expert).

The layout is the reference's fixed buffer ``(E, B, nG, C, d)``: every
expert runs its FFN over all ``B * nG * C`` slots, filled or not, as one
``torch.bmm`` over the expert axis. A slot's row of the product depends
only on that slot, and the GEMM's shape only on (B, S), so a row's output
does not depend on how the other rows routed (the serving engines'
batched-equals-solo contract). The buffer is filled by an index scatter
and read back by a gather of each kept (token, choice) slot, where the
reference multiplies one-hot dispatch and combine tensors; both move the
same values.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.types import ModelConfig
from repro_torch.models.init import spec

DEFAULT_GROUP = 256


def moe_spec(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff_
    return {
        "router": spec((d, e), ("embed", "expert_in"), "float32", scale=0.1),
        "w_gate": spec((e, d, f), ("expert", "embed", "ffn"), cfg.param_dtype),
        "w_up": spec((e, d, f), ("expert", "embed", "ffn"), cfg.param_dtype),
        "w_down": spec((e, f, d), ("expert", "ffn", "embed"), cfg.param_dtype),
    }


def expert_capacity(group: int, cfg: ModelConfig,
                    capacity_factor: float = 1.25) -> int:
    cap = int(group * cfg.experts_per_token * capacity_factor
              / cfg.num_experts)
    cap = max(cap, min(4, group * cfg.experts_per_token))
    return (cap + 7) // 8 * 8  # pad to a multiple of 8


def group_shape(s: int, group_size: int = DEFAULT_GROUP) -> Tuple[int, int]:
    """(tokens a group, groups a row): ``min(group_size, S)`` tokens, or
    the whole row when that does not divide S."""
    g = min(group_size, s)
    if s % g:
        g = s
    return g, s // g


class Routing(NamedTuple):
    """One layer's routing of a (B, S) batch."""

    probs: torch.Tensor       # (B, S, E) float32 softmax of the logits
    ids: torch.Tensor         # (B, S, k) chosen experts, best first
    weights: torch.Tensor     # (B, S, k) float32, renormalized over k
    slot: torch.Tensor        # (B, S, k) position in the expert's group
    kept: torch.Tensor        # (B, S, k) bool: slot < capacity
    capacity: int             # slots an expert has in each group


def route(logits: torch.Tensor, cfg: ModelConfig,
          capacity_factor: float = 1.25,
          group_size: int = DEFAULT_GROUP) -> Routing:
    """Top-k routing of float32 router logits (B, S, E): their softmax,
    then :func:`select`."""
    return select(torch.softmax(logits, dim=-1), cfg, capacity_factor,
                  group_size)


def select(probs: torch.Tensor, cfg: ModelConfig,
           capacity_factor: float = 1.25,
           group_size: int = DEFAULT_GROUP) -> Routing:
    """Top-k experts of router probabilities (B, S, E), renormalized, and
    their slots. Ties go to the lower expert index (``jax.lax.top_k``'s
    order; ``torch.topk`` makes no such promise, a stable descending sort
    does)."""
    b, s, e = probs.shape
    k = cfg.experts_per_token
    g, ng = group_shape(s, group_size)
    cap = expert_capacity(g, cfg, capacity_factor)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[..., :k], top_ids[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Position of each (token, choice) in its expert's group buffer: a
    # running count over the group's g * k choices, token-major.
    ids_g = top_ids.reshape(b, ng, g * k)
    sel = F.one_hot(ids_g, e)                              # (B, nG, gk, E)
    pos = torch.cumsum(sel, dim=2) - 1
    slot = pos.gather(-1, ids_g[..., None]).reshape(b, s, k)
    return Routing(probs, top_ids, top_w, slot, slot < cap, cap)


def dropped_choices(r: Routing) -> int:
    """(token, choice) pairs past their expert's capacity."""
    return int((~r.kept).sum())


# Instrumentation: the lists that record_routing() blocks of this thread
# have open. Thread-local, so a block opened on one thread does not
# collect the routings of models that other threads (a server's stage
# threads) run meanwhile.
_TAPS = threading.local()


def _open_taps() -> List[List[Routing]]:
    if not hasattr(_TAPS, "lists"):
        _TAPS.lists = []
    return _TAPS.lists


@contextlib.contextmanager
def record_routing() -> Iterator[List[Routing]]:
    """Collect the :class:`Routing` of every MoE layer that this thread
    runs inside the ``with`` block, in order (a model forward's, layer by
    layer). For tests and drop counts; serving never opens one."""
    seen: List[Routing] = []
    taps = _open_taps()
    taps.append(seen)
    try:
        yield seen
    finally:
        taps.remove(seen)


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                capacity_factor: float = 1.25,
                group_size: int = DEFAULT_GROUP
                ) -> Tuple[torch.Tensor, Routing]:
    """Returns (output (B, S, d), the layer's routing)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.matmul(x.float(), params["router"])
    r = route(logits, cfg, capacity_factor, group_size)
    for seen in _open_taps():
        seen.append(r)
    g, ng = group_shape(s, group_size)
    cap = r.capacity
    # Flat row of each (token, choice) in the (E, B, nG, C) buffer; a
    # dropped choice writes to (and reads from) one spare row past the end.
    n_slots = e * b * ng * cap
    row = torch.arange(b, device=x.device)[:, None, None]
    grp = (torch.arange(s, device=x.device) // g)[None, :, None]
    flat = ((r.ids * b + row) * ng + grp) * cap + r.slot
    flat = torch.where(r.kept, flat, n_slots).reshape(-1)
    buf = x.new_zeros((n_slots + 1, d))
    src = x.reshape(b * s, 1, d).expand(b * s, k, d).reshape(-1, d)
    buf.index_copy_(0, flat, src)
    xe = buf[:n_slots].view(e, b * ng * cap, d)
    gate = torch.bmm(xe, params["w_gate"])
    up = torch.bmm(xe, params["w_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    ye = torch.bmm(h, params["w_down"]).reshape(n_slots, d)
    # Combine: each kept slot's output times its weight, the weight cast
    # to the activation dtype first (the reference's combine tensor is in
    # it), summed over the k choices in float32.
    w = torch.where(r.kept, r.weights.to(x.dtype).float(), 0.0)
    picked = ye[flat.clamp(max=n_slots - 1)].reshape(b, s, k, d)
    y = (picked.float() * w[..., None]).sum(dim=2).to(x.dtype)
    return y, r


def load_balance_loss(r: Routing) -> torch.Tensor:
    """Switch-style load balance over the whole batch, counted on the
    choices before the capacity drop."""
    _, s, e = r.probs.shape
    k = r.ids.shape[-1]
    counts = F.one_hot(r.ids, e).sum(dim=(1, 2)).float()    # (B, E)
    frac_tokens = counts / (s * k)
    frac_probs = r.probs.mean(dim=1)
    return e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25,
              group_size: int = DEFAULT_GROUP
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's signature: (output (B, S, d), the Switch
    load-balance loss). The model's blocks call :func:`moe_forward` and
    take the loss from its routing over a sequence only: a decode step
    would discard it."""
    y, r = moe_forward(params, x, cfg, capacity_factor, group_size)
    return y, load_balance_loss(r)
