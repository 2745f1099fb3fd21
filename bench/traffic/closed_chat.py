"""Kind ``closed_chat``: a closed loop of chat requests, one client a
slot. Each client submits its next request when its last one finishes.

Lengths are log-uniform between the mix's bounds, drawn as a fixed set
and dealt in another order by the seed: every block of ``clients``
consecutive requests holds the same prompt lengths (the block's
quantiles of the log-uniform law) and the same output lengths, each
block shuffled apart, so every seed offers the same work in a window. Token
ids are drawn from the seed."""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np


def log_uniform_grid(lo: int, hi: int, n: int) -> np.ndarray:
    """The ``n`` midpoint quantiles of the log-uniform law on [lo, hi]."""
    q = (np.arange(n) + 0.5) / n
    return np.round(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                    ).astype(np.int64)


class Requests:
    """The seed's endless request sequence: ``next()`` gives (prompt token
    ids, output length)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.rng = np.random.default_rng(seed)
        self.block = mix["clients"]
        self.prompts = log_uniform_grid(*mix["prompt_tokens"], self.block)
        self.outputs = log_uniform_grid(*mix["output_tokens"], self.block)
        self.vocab = vocab
        self._queue: List[Tuple[int, int]] = []

    def next(self) -> Tuple[np.ndarray, int]:
        if not self._queue:
            self._queue = list(zip(self.rng.permutation(self.prompts),
                                   self.rng.permutation(self.outputs)))[::-1]
        p, o = self._queue.pop()
        return (self.rng.integers(1, self.vocab, size=int(p)).astype(np.int32),
                int(o))


def warm(system, mix: dict, seed: int, rec) -> None:
    """Fill every slot: one request a client joins, then ``warm_steps``
    decode steps run. The window starts with the slots full."""
    rec.requests = Requests(mix, seed, system.vocab)
    for _ in range(mix["clients"]):
        system.submit(*rec.requests.next())
    while system.pending():
        system.step()
    for _ in range(mix["warm_steps"]):
        system.step()


def drive(system, mix: dict, seed: int, seconds: float, rec) -> None:
    """Step ``system`` for ``seconds`` and record every request's first
    token and every gap between two of its tokens, as the host sees them
    at the end of a step. The slots were filled in set-up; the tokens of
    those requests count from the window's start. A request counts as
    attempted once a step starts while it waits or is served, and as
    answered once a token of it is seen. ``system``: ``submit(tokens,
    n_out)`` returns a handle with ``out_tokens`` and ``done_step``;
    ``pending()``; ``step()`` returns a meta dict; ``inflight()`` lists the
    handles being served."""
    clock = time.perf_counter
    t0 = clock()
    rec.window_start = t0
    # handle -> [tokens seen, time of the last one, submission time]
    live = {id(r): [r, len(r.out_tokens), None, None]
            for r in system.inflight()}
    offered, answered = set(), set()
    while clock() - t0 < seconds:
        offered.update(live)
        with rec.span("join_step" if system.pending() else "decode_step",
                      t0) as meta:
            meta.update(system.step())
        t = rec.spans[-1]["t1"]
        for key in list(live):
            req, n_seen, last, sub = live[key]
            n = len(req.out_tokens)
            if n > n_seen:
                answered.add(key)
                rec.tokens += n - n_seen
                if last is not None:
                    rec.itl_ms.append((t - last) * 1e3)
                elif sub is not None:
                    rec.ttft_ms.append((t - sub) * 1e3)
                # Tokens that arrive together are apart by nothing.
                rec.itl_ms.extend([0.0] * (n - n_seen - 1))
                live[key][1:3] = [n, t]
            if req.done_step >= 0:
                del live[key]
                nxt = system.submit(*rec.requests.next())
                live[id(nxt)] = [nxt, 0, None, clock()]
    rec.window_end = rec.spans[-1]["t1"] if rec.spans else clock()
    rec.attempted = len(offered)
    rec.answered = len(offered & answered)
