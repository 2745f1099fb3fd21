"""JALAD core: quantization, Huffman entropy coding, the latency model,
the decoupling ILP and its vectorized planner, the calibration tables,
the decoupled runner and the bandwidth-adaptive controller.

Import the submodules directly (``repro_torch.core.planner`` ...); this
package imports nothing at load time, so the codec and model layers can
depend on ``core.quantization`` without cycles.
"""
