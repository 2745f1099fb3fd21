"""Hand-written CUDA kernels of the port, each behind a wrapper that runs
its plain PyTorch version on CPU tensors and launches the kernel on CUDA
tensors (``build.py`` compiles ``csrc/`` with ``nvcc`` at first use).

* ``quantize`` — K1 fused encode, K2 fused decode (``csrc/quantize.cu``);
  K4 per-channel encode, K5 per-channel decode (``csrc/perchannel.cu``);
  the three-launch encode chain K6a, K6b, K6c (``csrc/threelaunch.cu``).
* ``entropy``  — the batched Huffman encode and K3 (``csrc/huffman_pack.cu``).
* ``attention`` — the int8 KV cache's decode step, K7a append and K7b
  attend (``csrc/kv8_attention.cu``).

``counters`` holds every wrapper's launch count.
"""
