"""Training: the train step (loss -> gradients -> AdamW update, in
place), gradient accumulation over microbatches, activation
rematerialization, and the host loop with metrics and checkpoints.

Gradients come from ``torch.autograd.grad`` over the parameter tree's
leaf tensors, which ask for gradients only for the step's forward and
backward; outside a step the parameters are plain tensors, so the serving
paths take the trained tree as it is. The products stay
``torch.matmul`` / cuBLAS: the reference's train step runs no Pallas
kernel either.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.types import TrainConfig
from repro_torch.device import DeviceLike, tensor_device
from repro_torch.models.api import Model, batch_to
from repro_torch.optim import adamw
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

log = get_logger("repro_torch.training")

REMAT_MODES = ("none", "full", "dots", "blocks")

# The operations whose outputs "dots" keeps: the matrix products (jax's
# ``checkpoint_dots`` saves every dot_general).
_DOT_OPS = frozenset([torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default])


def _save_dots(ctx, op, *args, **kwargs):
    """Keep a product's output, unless it runs with gradients off: the
    products inside an autograd Function's forward (the chunked
    attention's score blocks) reach the backward through what the
    Function saves, and keeping them would hold the S^2 scores."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _DOT_OPS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def make_loss_fn(model: Model, remat: str = "none") -> Callable:
    """``loss(params, batch)`` under a rematerialization mode: ``"none"``;
    ``"full"`` keeps only the loss's inputs and recomputes the whole
    forward in the backward; ``"dots"`` keeps the outputs of matrix
    products and recomputes the rest; ``"blocks"`` keeps each block's
    input (``cfg.block_remat``, O(layers) activation memory)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {remat!r}; one of {REMAT_MODES}")
    if remat == "blocks":
        return Model(cfg=model.cfg.replace(block_remat=True),
                     specs=model.specs).loss_fn
    loss = model.loss_fn
    if remat == "full":
        return functools.partial(checkpoint, loss, use_reentrant=False)
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(
            checkpoint, loss, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    return loss


def _value_and_grad(loss_fn: Callable, params, batch
                    ) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients shaped like ``params``; zeros for a leaf the loss
    does not reach, as jax gives)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, cfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, the update in place. With ``cfg.microbatches >
    1`` the batch is split on its leading axis and the gradients are
    accumulated in order into float32 zeros, then scaled by
    ``1 / microbatches`` (they stay float32, as the reference's do)."""
    loss_fn = make_loss_fn(model, cfg.remat)

    def single(params, batch):
        return _value_and_grad(loss_fn, params, batch)

    def accumulated(params, batch):
        mb = cfg.microbatches
        micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        dev = tensor_device(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        grad_sum = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
            params)
        for i in range(mb):
            loss, grads = single(params, {k: v[i] for k, v in micro.items()})
            for acc, g in zip(tree_leaves(grad_sum), tree_leaves(grads)):
                acc.add_(g)
            loss_sum = loss_sum + loss
            del grads
        scale = 1.0 / mb
        for g in tree_leaves(grad_sum):
            g.mul_(scale)
        return loss_sum * scale, grad_sum

    compute = accumulated if cfg.microbatches > 1 else single

    def train_step(params, opt_state, batch):
        loss, grads = compute(params, batch)
        params, opt_state, m = adamw.apply_updates(params, grads, opt_state,
                                                   cfg)
        return params, opt_state, {"loss": loss, **m}

    return train_step


@dataclass
class TrainResult:
    params: Any
    opt_state: Any
    losses: List[float] = field(default_factory=list)
    steps_per_sec: float = 0.0
    step_s: List[float] = field(default_factory=list)   # wall time a step


def train(model: Model, cfg: TrainConfig, data: Iterable[Dict], *,
          params=None, num_steps: Optional[int] = None,
          device: DeviceLike = None) -> TrainResult:
    """Host loop: init -> step -> metrics; returns params + loss history.
    ``params`` None draws them from ``cfg.seed`` on ``device`` (default:
    the card); given params train where they lie (``device`` unused),
    updated in place. Each
    step ends with its loss read on the host, so ``step_s`` holds whole
    steps."""
    steps = num_steps or cfg.total_steps
    if params is None:
        params = model.init(cfg.seed, device)
    dev = tensor_device(params)
    opt_state = adamw.init_state(params)
    step_fn = make_train_step(model, cfg)

    losses: List[float] = []
    step_s: List[float] = []
    it = iter(data)
    t0 = time.perf_counter()
    for step in range(steps):
        ts = time.perf_counter()
        batch = batch_to(next(it), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if cfg.log_every and step % cfg.log_every == 0:
            log.info("step %d loss %.4f lr %.2e gnorm %.2f", step, loss,
                     float(metrics["lr"]), float(metrics["grad_norm"]))
        if cfg.checkpoint_every and cfg.checkpoint_dir and \
                (step + 1) % cfg.checkpoint_every == 0:
            from repro_torch.checkpoint import save_checkpoint
            save_checkpoint(cfg.checkpoint_dir, step + 1, params, opt_state)
    dt = time.perf_counter() - t0
    return TrainResult(params, opt_state, losses, steps / max(dt, 1e-9),
                       step_s)
