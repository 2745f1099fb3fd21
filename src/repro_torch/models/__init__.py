"""Models of the port behind the ``Model`` API: the paper's CNN testbed
and the decoder families dense, moe, ssm, hybrid, vlm and audio
(``transformer``, ``blocks``, ``layers``)."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
