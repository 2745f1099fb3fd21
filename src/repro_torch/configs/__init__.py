"""Architecture configs ported so far: the paper's own CNN testbed
(VGG16/19, ResNet50/101), the dense decoders olmo-1b, qwen3-8b, yi-6b and
granite-34b, the xLSTM model xlstm-1.3b (family ``ssm``), the Mamba2
hybrid zamba2-2.7b (family ``hybrid``) and the mixtures of experts
grok-1-314b and llama4-maverick-400b-a17b (family ``moe``). Importing
this package registers them in ``repro_torch.config.registry``; select
with ``--arch <id>``."""
from repro_torch.configs import (  # noqa: F401
    cnn_testbed,
    granite_34b,
    grok_1_314b,
    llama4_maverick_400b_a17b,
    olmo_1b,
    qwen3_8b,
    xlstm_1_3b,
    yi_6b,
    zamba2_2_7b,
)
