"""Architecture configs ported so far: the paper's own CNN testbed
(VGG16/19, ResNet50/101), the dense decoders olmo-1b, qwen3-8b, yi-6b and
granite-34b, the xLSTM model xlstm-1.3b (family ``ssm``) and the Mamba2
hybrid zamba2-2.7b (family ``hybrid``). Importing this package registers
them in ``repro_torch.config.registry``; select with ``--arch <id>``."""
from repro_torch.configs import (  # noqa: F401
    cnn_testbed,
    granite_34b,
    olmo_1b,
    qwen3_8b,
    xlstm_1_3b,
    yi_6b,
    zamba2_2_7b,
)
