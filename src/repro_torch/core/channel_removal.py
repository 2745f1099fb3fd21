"""RL-based channel-wise feature removal (paper Sec. I, contribution 1:
"we introduce reinforcement learning based channel-wise feature removal to
reduce the transmission data").

A REINFORCE bandit learns per-channel keep-probabilities for the boundary
feature map at a decoupling point. Action: Bernoulli mask over channels.
Reward: -(transmitted fraction) - lambda * accuracy drop, so the policy
prunes channels whose removal is cheap in accuracy but saves bytes. The
learned deterministic mask (keep-prob > 0.5, subject to the removal
budget) feeds the compression pipeline before quantization.

The policy is numpy, the reference's own: the same generator and the same
``evaluate`` give the same logits, rewards and masks in both packages.
``apply_channel_mask`` multiplies a torch tensor on its own device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np
import torch


@dataclass
class ChannelRemovalPolicy:
    num_channels: int
    removal_budget: float = 0.25      # max fraction of channels removed
    acc_weight: float = 20.0          # lambda
    lr: float = 0.5
    baseline_decay: float = 0.9
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0)
    )

    def __post_init__(self):
        # Start biased toward keeping everything.
        self.logits = np.full(self.num_channels, 2.0)
        self._baseline = 0.0
        self.reward_history: List[float] = []

    # --------------------------------------------------------------- policy
    def keep_probs(self) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits))

    def sample_mask(self) -> np.ndarray:
        return (self.rng.random(self.num_channels) < self.keep_probs())

    def deterministic_mask(self) -> np.ndarray:
        """Greedy mask honoring the removal budget: drop the lowest-prob
        channels, at most ``removal_budget`` of them, and only those whose
        keep-probability fell below 0.5."""
        p = self.keep_probs()
        max_drop = int(self.removal_budget * self.num_channels)
        order = np.argsort(p)
        mask = np.ones(self.num_channels, bool)
        dropped = 0
        for ch in order:
            if dropped >= max_drop or p[ch] >= 0.5:
                break
            mask[ch] = False
            dropped += 1
        return mask

    # ------------------------------------------------------------- learning
    def update(self, mask: np.ndarray, acc_drop: float) -> float:
        """One REINFORCE step. ``mask`` is the sampled action; ``acc_drop``
        the measured accuracy drop when transmitting only kept channels."""
        kept_frac = mask.mean()
        reward = -(kept_frac) - self.acc_weight * max(acc_drop, 0.0)
        self.reward_history.append(reward)
        self._baseline = (
            self.baseline_decay * self._baseline
            + (1 - self.baseline_decay) * reward
        )
        adv = reward - self._baseline
        p = self.keep_probs()
        grad = (mask.astype(np.float64) - p) * adv   # d log pi / d logits
        self.logits += self.lr * grad
        self.logits = np.clip(self.logits, -6.0, 6.0)
        return reward


def train_channel_policy(
    policy: ChannelRemovalPolicy,
    evaluate: Callable[[np.ndarray], float],
    steps: int = 100,
) -> ChannelRemovalPolicy:
    """``evaluate(mask) -> accuracy drop`` closure provided by the caller
    (runs the decoupled tail with masked channels)."""
    for _ in range(steps):
        mask = policy.sample_mask()
        acc_drop = evaluate(mask)
        policy.update(mask, acc_drop)
    return policy


def apply_channel_mask(x: torch.Tensor, mask: np.ndarray, axis: int = -1
                       ) -> torch.Tensor:
    """Zero out removed channels (the cloud side re-inserts zeros, so shapes
    stay static; only the *transmitted* bytes shrink). A product with the
    0/1 mask in ``x``'s dtype on ``x``'s device, as the reference computes
    it: a removed negative element becomes ``-0.0``. The CNN testbed is
    NCHW in both packages, so its callers pass ``axis=1``."""
    shape = [1] * x.ndim
    shape[axis] = len(mask)
    m = torch.from_numpy(np.asarray(mask).astype(np.float32)).reshape(shape)
    return x * m.to(device=x.device, dtype=x.dtype)
