"""Token-level decoupled serving: the JALAD cut inside the decode loop.

One-shot decoupling (``DecoupledRunner``) ships the boundary once per
request. In autoregressive generation a small ``(1, 1, d_model)``
boundary row crosses the link *every token*, a regime where per-token
fixed costs (host framing, kernel launches, host syncs) dominate.
:class:`TokenStreamSession` extends the continuous-batching engine so the
decode loop itself runs across the cut:

* **Split state.** Each slot carries *head* caches (edge side, first
  ``point + 1`` blocks, full precision) and *tail* caches (cloud side,
  remaining blocks, int8-quantized KV by default, with a bytes-halved
  check at session construction).
* **Amortized wire.** Per engine step the head halves of ALL slots run as
  one batched decode, the active slots' boundary rows are encoded in ONE
  ``encode_batch`` (one kernel launch: K1, K3 or K4), decoded in ONE
  ``decode_batch`` (one K2 or K5 launch), and the tail halves advance in
  one batched decode.
* **Streaming wire format.** A per-session ``StreamHeader`` pins (codec,
  bits, frame shape) once at session open, so every later frame costs
  ``WireBlob.stream_nbytes``.
* **Same tokens as alone.** The head/tail split runs the unsplit
  forward's blocks in the same order, every engine decodes the same
  number of rows (``scheduler.DECODE_ROWS``), and the batched codec calls
  are byte-identical per frame to encoding each row alone, so a batched
  session emits exactly the tokens of serving each request by itself.

Cross-session batching lives in :func:`step_stream_group`: sessions on the
same (point, bits, codec) plan merge their per-step boundary rows into ONE
encode/decode group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.codec import get_codec
from repro_torch.core.decoupler import DecoupledPlan
from repro_torch.models import transformer as tf_lib
from repro_torch.models.api import Model
from repro_torch.models.init import torch_dtype
from repro_torch.serving.scheduler import (
    ContinuousBatchingEngine,
    GenRequest,
    copy_into_row,
    zero_row,
)

if TYPE_CHECKING:
    from repro_torch.codec import BoundaryCodec, StreamHeader, WireBlob
    from repro_torch.serving.edge_cloud import EdgeCloudServer, \
        LatencyBreakdown

PlanKey = Tuple[int, int, str]            # (point, bits, codec)


def _tree_nbytes(caches: List[Any]) -> int:
    """Total buffer bytes of a cache list (meta tensors count too)."""
    return sum(v.numel() * v.element_size() for c in caches
               for v in c.values())


@dataclass
class TokenStreamSession(ContinuousBatchingEngine):
    """Continuous batching with the decode loop split at a JALAD cut.

    ``plan`` fixes (point, bits, codec) for the session's lifetime (get
    one from :meth:`JaladEngine.decide_streaming`). ``cloud_kv_bits=8``
    (default) keeps the cloud tail's KV cache int8-quantized; ``0`` keeps
    it full precision.
    """

    plan: Optional[DecoupledPlan] = None
    cloud_kv_bits: int = 8

    def __post_init__(self) -> None:
        if self.plan is None:
            raise ValueError(
                "TokenStreamSession needs a DecoupledPlan (point, bits, "
                "codec) — get one from JaladEngine.decide_streaming")
        if self.plan.is_cloud_only:
            raise ValueError(
                "a cloud-only plan has no boundary stream; serve through "
                "the base ContinuousBatchingEngine instead")
        super().__post_init__()

    # ---------------------------------------------------------- state setup
    def _init_compute(self) -> None:
        model = self.model
        L = self.cfg.max_seq_len
        point = self.plan.point
        cfg_cloud = (model.cfg.replace(kv_cache_bits=self.cloud_kv_bits)
                     if self.cloud_kv_bits else model.cfg)
        # Same weights, different cache handling: the cloud view only
        # changes how tail KV rows are stored (int8 codes + f32 scales).
        self.cloud_model = Model(cfg=cfg_cloud, specs=model.specs)
        self._codec: "BoundaryCodec" = get_codec(self.plan.codec)
        self._cloud_dtype = torch_dtype(cfg_cloud.dtype)
        self._head_caches = model.init_head_caches(self.rows, L, point,
                                                   self.device)
        self._tail_caches = self.cloud_model.init_tail_caches(
            self.rows, L, point, self.device)
        self._frame_shape = (1, 1, int(model.cfg.d_model))
        # Session-open handshake: (codec, bits, frame shape) ship once,
        # every frame after that costs stream_nbytes.
        self.header: "StreamHeader" = self._codec.open_stream(
            self._frame_shape, self.plan.bits)
        self.bytes_sent: int = self.header.nbytes
        self.encode_groups: List[Tuple[int, List[int]]] = []
        self.tokens_out: int = 0
        self.kv_bytes_ratio: Optional[float] = None
        if self.cloud_kv_bits == 8:
            self.kv_bytes_ratio = self._check_kv_bytes(cfg_cloud, L, point)

    def _check_kv_bytes(self, cfg_cloud, cache_len: int,
                        point: int) -> Optional[float]:
        """The serving-time bytes-halved contract: the int8 tail KV cache
        must cost well under the full-precision bytes (codes shrink 4x
        for f32 models, 2x for bf16; per-row f32 scales add a 1/head_dim
        tax). Returns the ratio, or None when the tail holds no
        attention KV to quantize. Counted on meta tensors: no memory."""
        meta = torch.device("meta")
        q8 = tf_lib.init_tail_caches(cfg_cloud, 1, cache_len, point, meta)
        if not any(v.dtype == torch.int8 for c in q8 for v in c.values()):
            return None
        fp = tf_lib.init_tail_caches(self.model.cfg, 1, cache_len, point,
                                     meta)
        ratio = _tree_nbytes(q8) / max(_tree_nbytes(fp), 1)
        if ratio > 0.6:
            raise RuntimeError(
                f"int8 cloud KV cache is {ratio:.2f}x the full-precision "
                "bytes — expected at most 0.6x (bytes-halved contract)")
        return ratio

    # ------------------------------------------------------------ lifecycle
    @torch.no_grad()
    def _join(self, slot: int, req: GenRequest) -> None:
        """Prefill across the cut: head forward on the edge, the boundary
        sequence through the wire (a real encode/decode round trip,
        counted at stream framing cost), tail prefill on the cloud."""
        L, point = self.cfg.max_seq_len, self.plan.point
        boundary, head = self.model.prefill_head(self.params,
                                                 self._prompt(req), L, point)
        blob = self._codec.encode(boundary, self.plan.bits)
        self.bytes_sent += blob.stream_nbytes
        x = self._codec.decode(blob, out_dtype=self._cloud_dtype,
                               device=self.device)
        logits, tail = self.cloud_model.prefill_tail(self.params, x, L, point)
        copy_into_row(self._head_caches, head, slot)
        copy_into_row(self._tail_caches, tail, slot)
        self._seat(slot, req, logits)

    def _record_token(self, slot: int, token: int) -> None:
        self.tokens_out += 1
        super()._record_token(slot, token)

    def _evict(self, slot: int) -> None:
        super()._evict(slot)
        # Free the evicted slot's KV rows on BOTH sides of the cut; the
        # slot is no longer active, so it never joins a later encode group.
        zero_row(self._head_caches, slot)
        zero_row(self._tail_caches, slot)

    # --------------------------------------------------------- step phases
    def _head_phase(self, active: List[int]
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Edge half of one step: ONE batched head decode over all rows
        (only the active rows' caches advance), the active boundary rows
        gathered as ``(1, 1, d)`` frames."""
        live = self._live(active)
        boundary, _ = self.model.decode_head(
            self.params, self._last, self._pos, self._head_caches,
            self.plan.point, self.cfg.max_seq_len, live)
        return [boundary[s:s + 1] for s in active], live

    def _account_encode(self, active: List[int],
                        blobs: Sequence["WireBlob"]) -> List[int]:
        uids = [self._slots[s].uid for s in active]
        self.encode_groups.append((self.step_count, uids))
        self.bytes_sent += sum(b.stream_nbytes for b in blobs)
        return uids

    def _tail_phase(self, active: List[int], live: torch.Tensor,
                    xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Cloud half: scatter the decoded rows back to their slots, ONE
        batched tail decode (int8 KV update inside), advance the live
        rows' positions. Returns the (k, V) logits rows of the active
        slots."""
        idx = torch.as_tensor(active, device=self.device)
        dec = torch.zeros((self.rows,) + self._frame_shape[1:],
                          dtype=self._cloud_dtype, device=self.device)
        dec[idx] = torch.cat(list(xs))
        logits, _ = self.cloud_model.decode_tail(
            self.params, dec, self._pos, self._tail_caches, self.plan.point,
            self.cfg.max_seq_len, live)
        self._pos += live
        return logits[idx, -1]

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self) -> List[GenRequest]:
        """One engine step across the cut: admit, batched head decode, ONE
        batched boundary encode, ONE batched wire decode, batched tail
        decode, one batched token select + host sync. Returns the requests
        that finished during this step."""
        self.step_count += 1
        done_before = len(self.completed)
        self._admit()
        active = self._active_slots()
        if active:
            rows, live = self._head_phase(active)
            blobs = self._codec.encode_batch(rows, self.plan.bits)
            self._account_encode(active, blobs)
            xs = self._codec.decode_batch(blobs, out_dtype=self._cloud_dtype,
                                          device=self.device)
            self._finish_step(active, self._tail_phase(active, live, xs))
        return self.completed[done_before:]

    # ------------------------------------------------------------- protocol
    @property
    def plan_key(self) -> PlanKey:
        return (self.plan.point, self.plan.bits, self.plan.codec)

    def serve(self, server: "EdgeCloudServer",
              bandwidth: float) -> "LatencyBreakdown":
        """One engine step as a bandwidth-trace item (the
        ``EdgeCloudServer.serve_trace`` protocol, see
        :class:`~repro_torch.serving.edge_cloud.Servable`): advance every
        active slot one token, price the step with the planner's per-token
        stage times, and record it on the server's clock."""
        from repro_torch.serving.edge_cloud import LatencyBreakdown

        t0, b0 = self.tokens_out, self.bytes_sent
        self.step()
        k = self.tokens_out - t0
        nbytes = self.bytes_sent - b0
        edge_b, cloud_b = server.engine.plan_space.stage_times(self.plan)
        tpb = server.engine.stream_terms.tokens_per_batch
        bd = LatencyBreakdown(
            edge_b / tpb * k, nbytes / bandwidth, cloud_b / tpb * k,
            int(nbytes), self.plan.point, self.plan.bits, self.plan.codec)
        return server.record(bd)


@torch.no_grad()
def step_stream_group(sessions: Sequence[TokenStreamSession]
                      ) -> List[Tuple[TokenStreamSession, List[int]]]:
    """Advance same-plan sessions one engine step each, with the wire work
    of the WHOLE group merged: one cross-session ``encode_batch`` and one
    ``decode_batch`` cover every active slot of every session. Per-session
    tokens equal stepping each session alone (the codec's batched
    byte-identity contract). Returns (session, uids-encoded) pairs."""
    if not sessions:
        return []
    keys = {s.plan_key for s in sessions}
    if len(keys) > 1:
        raise ValueError(f"stream group mixes plans: {sorted(keys)}")
    bits = sessions[0].plan.bits
    codec = sessions[0]._codec
    dtype = sessions[0]._cloud_dtype
    device = sessions[0].device
    staged = []
    for s in sessions:
        s.step_count += 1
        s._admit()
        active = s._active_slots()
        rows, live = s._head_phase(active) if active else ([], None)
        staged.append((s, active, rows, live))
    all_rows = [r for _, _, rows, _ in staged for r in rows]
    all_blobs = codec.encode_batch(all_rows, bits) if all_rows else []
    all_xs = (codec.decode_batch(all_blobs, out_dtype=dtype, device=device)
              if all_blobs else [])
    out: List[Tuple[TokenStreamSession, List[int]]] = []
    lo = 0
    for s, active, rows, live in staged:
        hi = lo + len(rows)
        blobs, xs = all_blobs[lo:hi], all_xs[lo:hi]
        lo = hi
        uids: List[int] = []
        if active:
            uids = s._account_encode(active, blobs)
            s._finish_step(active, s._tail_phase(active, live, xs))
        out.append((s, uids))
    return out


__all__ = ["TokenStreamSession", "step_stream_group", "PlanKey"]
