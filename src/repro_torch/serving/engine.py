"""Serving runtime: KV-cache sessions (prefill + decode), greedy/temperature
sampling, and a request batcher over the continuous-batching engine."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config.types import ServeConfig
from repro_torch.device import tensor_device
from repro_torch.models.api import Model, batch_to


@dataclass
class ServeSession:
    """One batched generation session against a shared KV cache."""

    model: Model
    params: Any
    cfg: ServeConfig

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Prefill on the prompt batch then decode ``max_new_tokens``.
        Sampling (``temperature > 0``) draws from a ``torch.Generator``
        seeded with ``seed``."""
        device = tensor_device(self.params)
        tb = batch_to(batch, device)
        logits, caches = self.model.prefill(self.params, tb,
                                            self.cfg.max_seq_len)
        pos = tb["tokens"].shape[1]
        last = torch.argmax(logits[:, -1:], dim=-1)
        out = [last]
        gen = torch.Generator(device=device).manual_seed(seed)
        for _ in range(max_new_tokens - 1):
            logits, caches = self.model.decode_step(self.params, last, pos,
                                                    caches)
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature,
                                      dim=-1)
                last = torch.multinomial(probs, 1, generator=gen)
            else:
                last = torch.argmax(logits[:, -1:], dim=-1)
            out.append(last)
            pos += 1
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


@dataclass
class Request:
    uid: int
    tokens: np.ndarray            # (prompt_len,)
    max_new_tokens: int
    arrival: float = 0.0
    result: Optional[np.ndarray] = None
    done_at: float = 0.0


@dataclass
class RequestScheduler:
    """Facade over the continuous-batching engine: ``submit`` queues,
    ``step`` drains everything queued through
    :class:`~repro_torch.serving.scheduler.ContinuousBatchingEngine`, whose
    tokens are those of serving each request alone."""

    session: ServeSession
    queue: List[Request] = field(default_factory=list)
    completed: List[Request] = field(default_factory=list)

    def __post_init__(self):
        from repro_torch.serving.scheduler import ContinuousBatchingEngine

        self._engine = ContinuousBatchingEngine(
            self.session.model, self.session.params, self.session.cfg
        )

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def step(self) -> List[Request]:
        """Drain everything currently queued; returns the finished
        requests in completion order."""
        from repro_torch.serving.scheduler import GenRequest

        if not self.queue:
            return []
        by_uid: Dict[int, Request] = {}
        for r in self.queue:
            by_uid[r.uid] = r
            self._engine.submit(GenRequest(
                uid=r.uid, tokens=np.asarray(r.tokens, np.int32),
                max_new_tokens=r.max_new_tokens,
            ))
        self.queue = []
        done = []
        already = len(self._engine.completed)
        finished = self._engine.run()[already:]
        now = time.time()
        for g in finished:
            r = by_uid[g.uid]
            r.result = g.result
            r.done_at = now
            self.completed.append(r)
            done.append(r)
        return done
