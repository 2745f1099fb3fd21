"""Architecture configs: the paper's own CNN testbed (VGG16/19,
ResNet50/101) and the ten assigned architectures, the reference's set:
the dense decoders olmo-1b, qwen3-8b, yi-6b and granite-34b, the xLSTM
model xlstm-1.3b (family ``ssm``), the Mamba2 hybrid zamba2-2.7b (family
``hybrid``), the mixtures of experts grok-1-314b and
llama4-maverick-400b-a17b (family ``moe``), the vision-language decoder
qwen2-vl-7b (family ``vlm``) and the encoder-decoder
seamless-m4t-large-v2 (family ``audio``); and one arch the port alone
holds, the Mamba2 hybrid granite-4.0-h-micro. Importing this package
registers them in ``repro_torch.config.registry``; select with ``--arch
<id>``."""
from repro_torch.configs import (  # noqa: F401
    cnn_testbed,
    granite_4_0_h_micro,
    granite_34b,
    grok_1_314b,
    llama4_maverick_400b_a17b,
    olmo_1b,
    qwen2_vl_7b,
    qwen3_8b,
    seamless_m4t_large_v2,
    xlstm_1_3b,
    yi_6b,
    zamba2_2_7b,
)
