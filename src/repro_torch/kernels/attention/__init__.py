"""The int8 KV cache's decode step, K7a (append) and K7b (attend), with
its plain PyTorch version."""
from repro_torch.kernels.attention.ops import kv8_decode, kv8_decode_plain

__all__ = ["kv8_decode", "kv8_decode_plain"]
