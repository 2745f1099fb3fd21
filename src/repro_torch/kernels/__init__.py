"""Hand-written CUDA kernels of the port, each behind a wrapper that runs
its plain PyTorch version on CPU tensors and launches the kernel on CUDA
tensors (``build.py`` compiles ``csrc/`` with ``nvcc`` at first use).

* ``quantize`` — K1 fused encode, K2 fused decode (``csrc/quantize.cu``).
* ``entropy``  — the batched Huffman encode and K3 (``csrc/huffman_pack.cu``).
"""
