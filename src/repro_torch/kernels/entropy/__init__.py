"""The two-phase batched Huffman encode (device histogram, host tables,
kernel K3)."""
from repro_torch.kernels.entropy.ops import (
    PACK_MAX_CODE_BITS,
    huffman_encode_batch_device,
)

__all__ = ["PACK_MAX_CODE_BITS", "huffman_encode_batch_device"]
