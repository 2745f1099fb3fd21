"""AdamW with decoupled weight decay, a cosine LR schedule and global-norm
gradient clipping, written out (no optimizer library), as the reference's
``optim/adamw.py``.

The moments are float32 trees shaped like the parameters. The update runs
in place under ``torch.no_grad()``, one leaf at a time: the parameters,
the moments and the (clipped) gradients are overwritten, so a full-width
step holds no second copy of the parameters, only one leaf's float32
temporaries (the counterpart of the reference's donated buffers). The
operations follow the reference's order: ``m_hat / (sqrt(v_hat) +
1e-8)``, weight decay added inside the ``lr *``, every division tensor by
tensor (PyTorch would turn a division by a host scalar into a reciprocal
multiplication). The global norm sums per-leaf squares in the reference's
leaf order (dict keys sorted, :mod:`repro_torch.utils.tree`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config.types import TrainConfig
from repro_torch.utils.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # first moment  (tree like params, f32)
    nu: Any               # second moment (tree like params, f32)


def init_state(params) -> AdamWState:
    zeros = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    device = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros, tree_map(torch.clone, zeros))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def cosine_lr(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The float32 learning rate at ``step`` (an int32 tensor): linear
    warm-up, then a cosine down to a tenth."""
    warm = torch.minimum(step.float() / _f32(max(cfg.warmup_steps, 1), step),
                         _f32(1.0, step))
    progress = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * progress))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale the gradients, in place, to a global norm of at most
    ``max_norm``; returns (the gradients, their float32 norm before)."""
    leaves = tree_leaves(grads)
    total = torch.sum(torch.square(leaves[0].float()))
    for g in leaves[1:]:
        total = total + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(_f32(max_norm, gnorm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: TrainConfig
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: returns (params, state, {"lr",
    "grad_norm"}) holding the same tensors, overwritten. ``grads`` is
    consumed (clipped in place)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1, step), step.float())
    bc2 = 1 - torch.pow(_f32(b2, step), step.float())
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        gf = g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
        del gf
        delta = m / bc1
        delta.div_(torch.sqrt_(v / bc2).add_(1e-8))
        pf = p.float()
        delta.add_(cfg.weight_decay * pf)
        p.copy_(pf - delta.mul_(lr))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, AdamWState(step, state.mu, state.nu), metrics
