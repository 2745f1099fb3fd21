"""Architecture configs ported so far: the paper's own CNN testbed
(VGG16/19, ResNet50/101) and the dense decoders olmo-1b and qwen3-8b.
Importing this package registers them in ``repro_torch.config.registry``;
select with ``--arch <id>``."""
from repro_torch.configs import cnn_testbed, olmo_1b, qwen3_8b  # noqa: F401
