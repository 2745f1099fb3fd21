"""grok-1-314b — 8-expert top-2 MoE decoder [hf:xai-org/grok-1].

Every layer routes (pure-MoE pattern "e" * 64).
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="grok-1-314b",
        family="moe",
        source="hf:xai-org/grok-1",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        moe_d_ff=32768,
        block_pattern="e" * 64,
        rope_theta=10000.0,
        norm_kind="rmsnorm",
        attention_window=8192,
        window_only_for_long=True,
    )
)
