"""granite-34b — deep llama-architecture code model with MQA (kv=1)
[arXiv:2405.04324]."""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="granite-34b",
        family="dense",
        source="arXiv:2405.04324",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,            # multi-query attention
        d_ff=24576,
        vocab_size=49152,
        rope_theta=10000.0,
        norm_kind="layernorm",
        attention_window=8192,
        window_only_for_long=True,
    )
)
