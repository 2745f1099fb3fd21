"""PyTorch + CUDA port of the JALAD edge-cloud system.

The JAX package ``repro`` is the reference this port is held against. This
package imports ``torch`` and never ``jax``, and nothing of ``repro``: the
numpy/dataclass modules it needs are kept here as its own copies.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`). The boundary-codec
kernels are hand-written CUDA C++ for Hopper (``csrc/``), built at first
use; on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
