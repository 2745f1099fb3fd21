"""The boundary-codec interface: how quantized features cross the link.

* :class:`WireBlob` — the codec-agnostic unit that crosses the edge-cloud
  link: an opaque payload plus the header every codec needs (shape, bit
  width, affine ranges). Its bytes are the reference's: a blob encoded by
  either package decodes in the other.
* :class:`BoundaryCodec` — ``encode``/``decode``/``wire_size_bytes`` with
  the calibration hooks ``simulate`` (the dequantized values the cloud will
  see) and ``transfer_size_bytes`` (the exact data-dependent wire size the
  S_i(c) predictor records).
* a registry (``register_codec``/``get_codec``/``list_codecs``) the planner
  enumerates over.

``encode`` runs on the device of its input tensor. ``decode`` builds its
tensor on ``device`` (default: the CUDA card; ``"cpu"`` on request).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import quantize_dequantize


@dataclass(frozen=True)
class WireBlob:
    """One boundary tensor on the wire (see the module docstring)."""

    codec: str                      # registry id (out-of-band, not counted)
    payload: bytes
    shape: Tuple[int, ...]
    bits: int
    x_min: np.ndarray               # () or (C,) float32
    x_max: np.ndarray
    axis: Optional[int] = None      # channel axis for vector ranges

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def header_bytes(self) -> int:
        # (min, max) pairs as f32 + the bits byte.
        return 8 * int(np.size(self.x_min)) + 1

    @property
    def nbytes(self) -> int:
        return len(self.payload) + self.header_bytes

    @property
    def stream_nbytes(self) -> int:
        """Wire cost inside an open token stream: the session header pins
        the bit width, so the 1-byte bits tag is amortized away."""
        return self.nbytes - 1


@dataclass(frozen=True)
class StreamHeader:
    """Per-session header of a token stream: codec id (1 byte), bits (1
    byte), rank (1 byte) and 4 bytes per dim."""

    codec: str
    bits: int
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return 3 + 4 * len(self.shape)


class BoundaryCodec(ABC):
    """One wire format for the edge->cloud boundary tensor. Codecs with the
    same ``value_key`` decode to identical tensors, so calibration shares
    one tail forward between them."""

    name: str = ""
    value_key: str = "tensor"

    @abstractmethod
    def encode(self, x: torch.Tensor, bits: int) -> WireBlob:
        """Quantize + serialize one boundary tensor (runs on the edge)."""

    @abstractmethod
    def decode(self, blob: WireBlob, out_dtype=torch.float32,
               device=None) -> torch.Tensor:
        """Reconstruct the dequantized tensor (runs on the cloud)."""

    @abstractmethod
    def wire_size_bytes(self, shape: Tuple[int, ...], bits: int) -> int:
        """Shape-only wire size: exact for fixed-rate codecs, an upper
        bound for entropy-coded ones."""

    # ------------------------------------------------------ batched API
    def encode_batch(self, xs: Sequence[torch.Tensor], bits: int
                     ) -> List[WireBlob]:
        """Encode a stack of boundary tensors; each blob byte-identical to
        ``encode`` of that tensor alone."""
        return [self.encode(x, bits) for x in xs]

    def decode_batch(self, blobs: Sequence[WireBlob], out_dtype=torch.float32,
                     device=None) -> List[torch.Tensor]:
        """Batched inverse of :meth:`encode_batch`."""
        return [self.decode(b, out_dtype, device) for b in blobs]

    def open_stream(self, shape: Tuple[int, ...], bits: int) -> StreamHeader:
        return StreamHeader(codec=self.name, bits=bits, shape=tuple(shape))

    # ------------------------------------------------------------ hooks
    def transfer_size_bytes(self, x: torch.Tensor, bits: int) -> int:
        """Exact data-dependent wire size (what S_i(c) records)."""
        return self.wire_size_bytes(tuple(x.shape), bits)

    def simulate(self, x: torch.Tensor, bits: int) -> torch.Tensor:
        """The dequantized values the cloud will reconstruct."""
        return quantize_dequantize(x, bits)

    def simulate_batch(self, x: torch.Tensor, bits_list: Sequence[int]
                       ) -> torch.Tensor:
        """``(C, *x.shape)``: :meth:`simulate` at every bit width."""
        return torch.stack([self.simulate(x, b) for b in bits_list])

    def transfer_size_batch(self, x: torch.Tensor, bits_list: Sequence[int]
                            ) -> List[int]:
        """Exact wire sizes of one boundary at every bit width."""
        return [self.transfer_size_bytes(x, b) for b in bits_list]


def stackable_shapes(shapes: List[Tuple[int, ...]]) -> bool:
    """True when one batched launch can cover tensors of these shapes: more
    than one tensor, a single common shape, at least one element."""
    return (len(shapes) > 1 and len(set(shapes)) == 1
            and int(np.prod(shapes[0])) > 0)


def ranges_f32(blobs: Sequence[WireBlob]) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked (B,) float32 (min, max) headers of per-tensor blobs."""
    return (np.stack([np.float32(b.x_min) for b in blobs]),
            np.stack([np.float32(b.x_max) for b in blobs]))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, BoundaryCodec] = {}


def register_codec(codec: BoundaryCodec) -> BoundaryCodec:
    if not codec.name:
        raise ValueError("codec must set a non-empty .name")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> BoundaryCodec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown boundary codec {name!r}; registered: {list_codecs()}"
        ) from None


def list_codecs() -> List[str]:
    return sorted(_REGISTRY)
