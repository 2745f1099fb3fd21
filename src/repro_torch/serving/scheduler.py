"""Continuous-batching request scheduler (slot-based, vLLM-style).

The engine keeps ``max_batch`` independent *slots*. A request joins a free
slot at any decode step (its prompt is prefilled into that slot's cache
rows), every active slot advances one token per engine step through ONE
batched decode, and a slot is evicted the moment its request finishes
(max tokens or EOS), so short requests never wait for long ones.

Per-slot positions: the reference vmaps a batch-1 ``decode_step`` over a
leading slot axis. Here the slots are the rows of one batched decode
whose ``pos`` is a ``(rows,)`` tensor: each row rotates, writes its cache
and masks its attention at its own position, and rows that are not active
keep their cache rows (``live``).

Batch invariance: the contract is that a request's tokens are those of
serving it alone. One ``(n, d)`` matrix product may round a row
differently from an ``(m, d)`` one (a library picks its kernel by shape),
and the difference grows over the layers until a near-tie between two
logits flips. So every engine decodes a fixed number of rows,
``max_batch`` rounded up to a multiple of ``DECODE_ROWS``; the rows past
``max_batch`` are never active. Every engine of up to ``DECODE_ROWS``
slots then runs the same shapes, and a row's arithmetic does not depend
on the other rows.

Token selection is batched: greedy argmax for all active slots in one
device op and one host transfer a step. A sampled slot (``temperature >
0``) draws from its own ``torch.Generator`` (seeded ``cfg.seed + uid``),
one draw a token, so its stream is reproducible; it cannot match the
reference's ``jax.random`` draws.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.types import ServeConfig
from repro_torch.device import tensor_device
from repro_torch.models.api import Model
from repro_torch.utils.trace import span

# Decode rows come in multiples of this (see the module docstring).
DECODE_ROWS = 8


@dataclass
class GenRequest:
    """One generation request and (after serving) its result."""

    uid: int
    tokens: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    arrival: float = 0.0               # engine step at which it may join
    # Filled by the engine:
    out_tokens: List[int] = field(default_factory=list)
    joined_step: int = -1
    done_step: int = -1
    slot: int = -1

    @property
    def result(self) -> np.ndarray:
        return np.asarray(self.out_tokens, np.int32)


def copy_into_row(bufs: List[Any], new: List[Any], row: int) -> None:
    """Write a batch-1 cache list into row ``row`` of a stacked one (the
    batch axis follows the layer axis)."""
    for buf, one in zip(bufs, new):
        for k in buf:
            buf[k][:, row] = one[k][:, 0]


def zero_row(bufs: List[Any], row: int) -> None:
    for buf in bufs:
        for v in buf.values():
            v[:, row] = 0


def sample_rows(rows: torch.Tensor, temps: List[float],
                gens: List[Optional[torch.Generator]]) -> torch.Tensor:
    """Next token of each row of ``rows`` (k, V): the argmax, or one draw
    from ``softmax(row / t)`` with the row's generator where ``t > 0``."""
    toks = torch.argmax(rows, dim=-1)
    for j, t in enumerate(temps):
        if t > 0:
            probs = torch.softmax(rows[j].float() / t, dim=-1)
            toks[j] = torch.multinomial(probs, 1, generator=gens[j])[0]
    return toks


@dataclass
class ContinuousBatchingEngine:
    """Slot-based continuous batching over a shared batched decode."""

    model: Model
    params: Any
    cfg: ServeConfig

    def __post_init__(self):
        if not self.model.is_lm:
            raise ValueError("continuous batching serves autoregressive "
                             "families; CNNs go through the edge-cloud "
                             "servers (repro_torch.serving.edge_cloud)")
        n = self.cfg.max_batch
        self.device = tensor_device(self.params)
        self.rows = -(-n // DECODE_ROWS) * DECODE_ROWS
        self._init_compute()
        self._pos = torch.zeros(self.rows, dtype=torch.int64,
                                device=self.device)
        self._last = torch.zeros((self.rows, 1), dtype=torch.int64,
                                 device=self.device)
        self._slots: List[Optional[GenRequest]] = [None] * n
        self._gens: List[Optional[torch.Generator]] = [None] * n
        self.queue: Deque[GenRequest] = deque()
        self.completed: List[GenRequest] = []
        self.events: List[Tuple[str, int, int]] = []   # (kind, step, uid)
        self.step_count = 0

    def _init_compute(self) -> None:
        """The decode rows' caches. The token-streaming session overrides
        this with split head/tail state (see
        :mod:`repro_torch.serving.streaming`)."""
        self._caches = self.model.init_caches(self.rows, self.cfg.max_seq_len,
                                              self.device)

    # ------------------------------------------------------------ admission
    def submit(self, req: GenRequest) -> None:
        self.queue.append(req)

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is not None]

    def _admit(self) -> None:
        """Admit eligible queued requests into free slots (FIFO; requests
        whose ``arrival`` lies in the future are deferred in order)."""
        free = self._free_slots()
        deferred: List[GenRequest] = []
        while free and self.queue:
            req = self.queue.popleft()
            if req.arrival > self.step_count - 1:
                deferred.append(req)
                continue
            self._join(free.pop(0), req)
        self.queue.extendleft(reversed(deferred))

    # ------------------------------------------------------------- internals
    def _prompt(self, req: GenRequest) -> dict:
        """The prefill batch of one request: its tokens alone (a vlm
        request is a text prompt). An encoder-decoder is refused here,
        at its first prefill, where the reference fails for want of
        ``src_frames``."""
        if self.model.cfg.is_encdec:
            raise ValueError(
                f"continuous batching prefills token prompts alone; "
                f"{self.model.cfg.arch_id} (family "
                f"{self.model.cfg.family!r}) needs src_frames, the "
                "encoder's input, which a GenRequest does not carry")
        return {"tokens": torch.as_tensor(
            np.asarray(req.tokens)[None, :], dtype=torch.int64,
            device=self.device)}

    def _seat(self, slot: int, req: GenRequest, logits: torch.Tensor) -> None:
        """Bookkeeping of a join: the slot's position, the request's
        generator, the event, and the first token from the prompt's last
        logits."""
        self._pos[slot] = len(req.tokens)
        req.slot = slot
        req.joined_step = self.step_count
        self._slots[slot] = req
        if req.temperature > 0:
            self._gens[slot] = torch.Generator(device=self.device
                                               ).manual_seed(
                self.cfg.seed + req.uid)
        self.events.append(("join", self.step_count, req.uid))
        toks_np, toks = self._select_tokens([slot], logits[:, -1])
        self._last[slot, 0] = toks[0]
        self._record_token(slot, int(toks_np[0]))

    @torch.no_grad()
    def _join(self, slot: int, req: GenRequest) -> None:
        logits, caches = self.model.prefill(self.params, self._prompt(req),
                                            self.cfg.max_seq_len)
        copy_into_row(self._caches, caches, slot)
        self._seat(slot, req, logits)

    def _select_tokens(self, slots: List[int], rows: torch.Tensor
                       ) -> Tuple[np.ndarray, torch.Tensor]:
        """Select the next token for every listed slot: batched on the
        device, one host transfer. Returns (host tokens, device tokens)."""
        with span("stream.select", rows=len(slots)):
            toks = sample_rows(rows,
                               [self._slots[s].temperature for s in slots],
                               [self._gens[s] for s in slots])
            return toks.cpu().numpy(), toks     # the step's single host sync

    def _record_token(self, slot: int, token: int) -> None:
        req = self._slots[slot]
        req.out_tokens.append(token)
        finished = len(req.out_tokens) >= req.max_new_tokens or (
            req.eos_id is not None and token == req.eos_id
        )
        if finished:
            self._evict(slot)

    def _evict(self, slot: int) -> None:
        req = self._slots[slot]
        req.done_step = self.step_count
        self._slots[slot] = None
        self._gens[slot] = None
        self.completed.append(req)
        self.events.append(("evict", self.step_count, req.uid))

    def _live(self, active: List[int]) -> torch.Tensor:
        mask = np.zeros((self.rows,), bool)
        mask[active] = True
        return torch.as_tensor(mask, device=self.device)

    def _finish_step(self, active: List[int], rows: torch.Tensor) -> None:
        toks_np, toks = self._select_tokens(active, rows)
        self._last[torch.as_tensor(active, device=self.device), 0] = toks
        for j, slot in enumerate(active):
            self._record_token(slot, int(toks_np[j]))

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> List[GenRequest]:
        """One engine step: admit eligible requests into free slots, then
        advance every active slot by one decode token. Returns the requests
        that finished during this step."""
        self.step_count += 1
        done_before = len(self.completed)
        self._admit()
        active = self._active_slots()
        if active:
            live = self._live(active)
            logits, _ = self.model.decode_step(self.params, self._last,
                                               self._pos, self._caches, live)
            self._pos += live
            idx = torch.as_tensor(active, device=self.device)
            self._finish_step(active, logits[idx, -1])
        return self.completed[done_before:]

    def run(self) -> List[GenRequest]:
        """Drain the queue and all active slots; returns completions in
        finish order."""
        while self.queue or self.num_active:
            self.step()
        return self.completed
