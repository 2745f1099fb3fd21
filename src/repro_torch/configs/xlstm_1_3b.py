"""xlstm-1.3b — sLSTM + mLSTM blocks at the paper's 7:1 ratio
[arXiv:2405.04517].

48 blocks: every 8th is an sLSTM ('s'), the rest mLSTM ('l'). Recurrent
state is O(1) in sequence length, so long_500k decodes natively.
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="xlstm-1.3b",
        family="ssm",
        source="arXiv:2405.04517",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,                     # xLSTM blocks have no separate MLP
        vocab_size=50304,
        ssm_expand=2,
        block_pattern=("l" * 7 + "s") * 6,
        rope_kind="none",
        norm_kind="layernorm",
    )
)
