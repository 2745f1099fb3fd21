"""Accuracy- and size-predictor tables A_i(c), S_i(c) (paper Sec. III-C),
with a codec axis: A[i, c, k] / S[i, c, k] for every boundary codec k the
engine may choose.

**Units.** S[i, c, k] is the mean wire size of one *calibration batch*
(header + payload bytes of the full batch boundary tensor), the unit of
``LatencyModel.input_bytes`` and of the batch-level FMAC vectors.

Calibration (:func:`build_tables`) is one pass per batch on the
parameters' device: the full forward, every decoupling boundary from one
tapped sweep (``Model.run_heads``), all bit-width choices of a boundary
stacked per value transform (``BoundaryCodec.simulate_batch``) and run
through ONE tail forward over the ``(C*B, ...)`` stack, top-1 counts
accumulated on the device. Wire sizes come from
``BoundaryCodec.transfer_size_batch``: shape-only for fixed-rate codecs,
one device histogram pass per (point, batch) for entropy codecs.

The historical per-cell loop is kept as :func:`build_tables_reference`,
the oracle the one-pass :func:`build_tables` is pinned bitwise-equal to
(``tests/test_torch_lm_serving.py``). Both count their host/device
traffic into a :class:`CalibrationStats` the caller passes.

Decoders score the final position (top-1 of the last token's logits);
with no labels in the batch the un-quantized model's own prediction is
the reference, exactly how A_i(c) behaves for a deployed model.

Table files are the reference's npz format: a table built by either
package loads in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import tensor_device
from repro_torch.models.api import Model, batch_to

# Bumped whenever the table semantics change; part of the cache key.
TABLE_FORMAT_VERSION = 2


@dataclass
class PredictorTables:
    """A[i, c, k] = accuracy drop; S[i, c, k] = mean compressed wire bytes
    per calibration batch, for decoupling point i, bit width c, codec k."""

    points: List[str]
    bits_choices: List[int]
    codecs: List[str]
    acc_drop: np.ndarray          # (N, C, K)
    size_bytes: np.ndarray        # (N, C, K) bytes per calibration batch
    base_accuracy: float

    # ------------------------------------------------------------- views
    def codec_index(self, name: str) -> int:
        return self.codecs.index(name)

    def drops(self, codec: Optional[str] = None) -> np.ndarray:
        """(N, C) accuracy-drop table of one codec (default: first)."""
        k = self.codec_index(codec) if codec else 0
        return self.acc_drop[:, :, k]

    def sizes(self, codec: Optional[str] = None) -> np.ndarray:
        """(N, C) per-batch wire-size table of one codec (default: first)."""
        k = self.codec_index(codec) if codec else 0
        return self.size_bytes[:, :, k]

    # -------------------------------------------------------- persistence
    @staticmethod
    def _npz_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        path = self._npz_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path,
            acc_drop=self.acc_drop,
            size_bytes=self.size_bytes,
            base_accuracy=self.base_accuracy,
            points=np.array(self.points),
            bits_choices=np.array(self.bits_choices),
            codecs=np.array(self.codecs),
        )

    @classmethod
    def load(cls, path: str) -> "PredictorTables":
        if not os.path.exists(path):
            path = cls._npz_path(path)
        z = np.load(path, allow_pickle=False)
        acc = z["acc_drop"]
        size = z["size_bytes"]
        if acc.ndim == 2:             # pre-codec table files
            acc = acc[:, :, None]
            size = size[:, :, None]
        codecs = (
            [str(c) for c in z["codecs"]] if "codecs" in z else ["huffman"]
        )
        return cls(
            points=[str(p) for p in z["points"]],
            bits_choices=[int(b) for b in z["bits_choices"]],
            codecs=codecs,
            acc_drop=acc,
            size_bytes=size,
            base_accuracy=float(z["base_accuracy"]),
        )

    # --------------------------------------------------------- cache key
    @staticmethod
    def cache_key(arch_id: str, bits_choices: Sequence[int],
                  codecs: Sequence[str],
                  points: Optional[Sequence[int]] = None,
                  **calib) -> str:
        """Deterministic hash of everything the tables depend on (the
        reference's key: the same config names the same file)."""
        payload = {
            "format": TABLE_FORMAT_VERSION,
            "arch": str(arch_id),
            "bits": [int(b) for b in bits_choices],
            "codecs": [str(c) for c in codecs],
            "points": None if points is None else [int(p) for p in points],
            "calib": {k: calib[k] for k in sorted(calib)},
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:20]


@dataclass
class CalibrationStats:
    """Host/device traffic of one ``build_tables*`` call."""

    batches: int = 0
    step_dispatches: int = 0     # passes carrying tail forwards
    host_syncs: int = 0          # device->host result fetches (accuracy)
    size_calls: int = 0          # transfer_size_batch / per-cell size calls
    tail_forwards: int = 0       # tail forward executions (both paths)


def _top1(logits: torch.Tensor) -> torch.Tensor:
    if logits.ndim == 3:          # decoder: score the final position
        logits = logits[:, -1]
    return logits.argmax(-1)


def _batch_size(batch: Dict, labels_key: str) -> int:
    if labels_key in batch:
        return int(np.shape(batch[labels_key])[0])
    return int(np.shape(next(iter(batch.values())))[0])


def _repeat_extras(extras, n: int):
    """A head's extras for ``n`` bit-width copies of its boundary stacked
    along the batch axis: each tensor leaf (positions ``(B, S)``, M-RoPE
    ids ``(B, S, 3)``, the encoder output ``(B, S_enc, d)``) repeated
    ``n`` times along that axis. The reference vmaps its tail over the
    widths with the extras closed over instead."""
    if extras is None:
        return None
    return {k: None if v is None else torch.cat([v] * n)
            for k, v in extras.items()}


@torch.no_grad()
def build_tables(
    model: Model,
    params,
    batches: Sequence[Dict],
    bits_choices: Sequence[int],
    *,
    codecs: Sequence[str] = ("huffman",),
    points: Optional[Sequence[int]] = None,
    labels_key: str = "labels",
    stats: Optional[CalibrationStats] = None,
) -> PredictorTables:
    """One-pass calibration (see module docstring) on the parameters'
    device: for each point i, bit width c and codec k, the accuracy drop
    of the boundary the cloud would reconstruct and the exact per-batch
    wire size. Equal, bit for bit, to :func:`build_tables_reference`."""
    from repro_torch.codec import get_codec

    device = tensor_device(params)
    names = model.decoupling_points()
    pts = tuple(points) if points is not None else tuple(range(len(names)))
    bits_t = tuple(int(b) for b in bits_choices)
    codec_objs = [get_codec(c) for c in codecs]
    n_c, n_k, n_p = len(bits_t), len(codec_objs), len(pts)

    # Codecs sharing a value_key share one tail forward.
    key_order: List[str] = []
    key_rep: Dict[str, object] = {}
    for c in codec_objs:
        if c.value_key not in key_rep:
            key_rep[c.value_key] = c
            key_order.append(c.value_key)
    key_of = [key_order.index(c.value_key) for c in codec_objs]

    stats = CalibrationStats() if stats is None else stats
    correct_base = 0
    total = 0
    correct = np.zeros((n_p, len(key_order), n_c), np.int64)
    sizes = np.zeros((n_p, n_c, n_k))
    n_batches = 0

    for batch in batches:
        n_batches += 1
        stats.batches += 1
        stats.step_dispatches += 1
        tb = batch_to(batch, device)
        base_pred = _top1(model.forward(params, tb))
        ref = tb[labels_key] if labels_key in tb else base_pred
        counts = torch.zeros((n_p, len(key_order), n_c), dtype=torch.int64,
                             device=device)
        heads = model.run_heads(params, tb, pts) if n_c else []
        for pi, (point, (boundary, extras)) in enumerate(zip(pts, heads)):
            extras = _repeat_extras(extras, n_c)
            for kk, key in enumerate(key_order):
                xq = key_rep[key].simulate_batch(boundary, bits_t)
                logits = model.run_tail(params, xq.reshape(
                    (-1,) + tuple(boundary.shape[1:])), point, extras)
                stats.tail_forwards += 1
                preds = _top1(logits).reshape(n_c, -1)
                counts[pi, kk] = (preds == ref[None]).sum(dim=1)
            for ki, codec in enumerate(codec_objs):
                sizes[pi, :, ki] += codec.transfer_size_batch(boundary,
                                                              bits_t)
                stats.size_calls += 1
        total += _batch_size(batch, labels_key)
        correct_base += int((base_pred == ref).sum())
        correct += counts.cpu().numpy()
        stats.host_syncs += 1

    base_acc = correct_base / max(total, 1)
    acc_counts = np.zeros((n_p, n_c, n_k))
    for ki in range(n_k):
        acc_counts[:, :, ki] = correct[:, key_of[ki], :]
    acc = acc_counts / max(total, 1)
    return PredictorTables(
        points=[names[p] for p in pts],
        bits_choices=list(bits_t),
        codecs=list(codecs),
        acc_drop=np.maximum(base_acc - acc, 0.0),
        size_bytes=sizes / max(n_batches, 1),
        base_accuracy=base_acc,
    )


@torch.no_grad()
def build_tables_reference(
    model: Model,
    params,
    batches: Sequence[Dict],
    bits_choices: Sequence[int],
    *,
    codecs: Sequence[str] = ("huffman",),
    points: Optional[Sequence[int]] = None,
    labels_key: str = "labels",
    stats: Optional[CalibrationStats] = None,
) -> PredictorTables:
    """The historical ``batches x points x bits x codecs`` loop: one tail
    forward and one host sync per (point, bits) cell and value transform,
    one size call per (point, bits, codec). The oracle the one-pass
    :func:`build_tables` is pinned bitwise-equal to."""
    from repro_torch.codec import get_codec

    device = tensor_device(params)
    names = model.decoupling_points()
    pts = list(points) if points is not None else list(range(len(names)))
    n_c = len(bits_choices)
    codec_objs = [get_codec(c) for c in codecs]
    n_k = len(codec_objs)
    stats = CalibrationStats() if stats is None else stats

    correct_base = 0
    total = 0
    correct = np.zeros((len(pts), n_c, n_k))
    sizes = np.zeros((len(pts), n_c, n_k))
    n_batches = 0

    for batch in batches:
        n_batches += 1
        stats.batches += 1
        tb = batch_to(batch, device)
        base_pred = _top1(model.forward(params, tb)).cpu().numpy()
        stats.host_syncs += 1
        ref = (tb[labels_key].cpu().numpy() if labels_key in tb
               else base_pred)
        correct_base += int((base_pred == ref).sum())
        total += ref.shape[0]

        for pi, point in enumerate(pts):
            out = model.run_head(params, tb, point)
            boundary, extras = out if isinstance(out, tuple) else (out, None)
            for ci, bits in enumerate(bits_choices):
                n_ok_by_key: Dict[str, int] = {}
                for ki, codec in enumerate(codec_objs):
                    key = codec.value_key
                    if key not in n_ok_by_key:
                        xq = codec.simulate(boundary, bits)
                        logits = model.run_tail(params, xq, point, extras)
                        stats.step_dispatches += 1
                        stats.host_syncs += 1
                        stats.tail_forwards += 1
                        n_ok_by_key[key] = int(
                            (_top1(logits).cpu().numpy() == ref).sum())
                    correct[pi, ci, ki] += n_ok_by_key[key]
                    # Per-batch wire bytes: the full batch boundary's size.
                    sizes[pi, ci, ki] += codec.transfer_size_bytes(
                        boundary, bits)
                    stats.size_calls += 1

    base_acc = correct_base / max(total, 1)
    acc = correct / max(total, 1)
    return PredictorTables(
        points=[names[p] for p in pts],
        bits_choices=list(bits_choices),
        codecs=list(codecs),
        acc_drop=np.maximum(base_acc - acc, 0.0),
        size_bytes=sizes / max(n_batches, 1),
        base_accuracy=base_acc,
    )


def load_or_build_tables(cache_dir: Optional[str], key: str, builder
                         ) -> Tuple[PredictorTables, bool]:
    """Return ``(tables, cache_hit)``: load ``<cache_dir>/tables-<key>.npz``
    when present, otherwise call ``builder()`` and persist the result.
    ``cache_dir=None`` disables persistence (always builds)."""
    if not cache_dir:
        return builder(), False
    path = os.path.join(cache_dir, f"tables-{key}.npz")
    if os.path.exists(path):
        return PredictorTables.load(path), True
    tables = builder()
    tables.save(path)
    return tables, False
