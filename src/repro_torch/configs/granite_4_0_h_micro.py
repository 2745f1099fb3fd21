"""granite-4.0-h-micro — IBM Granite 4.0-H Micro (3B, ``granitemoehybrid``):
40 layers, 36 Mamba2 and 4 NoPE GQA attention layers (5, 15, 25, 35),
each followed by its own SwiGLU MLP, with muP scalars.

Source: https://huggingface.co/ibm-granite/granite-4.0-h-micro (its
``config.json``). d_model 2,048, MLP 8,192, vocabulary 100,352 tied;
attention 32 query and 8 KV heads of 64, no positions; Mamba2 64 heads
of 64 (expand 2), state 128, one group, conv 4 with a bias, chunk 256;
embedding x12, both residual branches x0.22, attention scale 1/64, logits
/8; RMSNorm eps 1e-5; every leaf bfloat16, as the published checkpoint.

Port-only: the reference registry has no such arch, so the config is a
:class:`~repro_torch.config.types.MupConfig` registered ``port_only``.
Block ``'M'`` is a Mamba2 mixer and its MLP, ``'d'`` the attention layer.
"""
from repro_torch.config.registry import register
from repro_torch.config.types import MupConfig

ATTENTION_LAYERS = (5, 15, 25, 35)
PATTERN = "".join("d" if i in ATTENTION_LAYERS else "M" for i in range(40))

CONFIG = register(
    MupConfig(
        arch_id="granite-4.0-h-micro",
        family="hybrid",
        source="https://huggingface.co/ibm-granite/granite-4.0-h-micro",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=100352,
        rope_kind="none",
        norm_kind="rmsnorm",
        tie_embeddings=True,
        ssm_state_dim=128,
        ssm_conv_width=4,
        ssm_expand=2,
        block_pattern=PATTERN,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.015625,
        logits_scaling=8.0,
        ssm_param_dtype="bfloat16",
    ),
    port_only=True,
)
