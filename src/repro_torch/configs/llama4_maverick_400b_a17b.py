"""llama4-maverick-400b-a17b — interleaved-MoE decoder, 128 experts top-1,
early-fusion multimodal text trunk [hf:meta-llama/Llama-4-Scout-17B-16E].

Llama-4 Maverick interleaves dense and MoE decoder layers (every other
layer routes); we encode that as block pattern "de" * 24 = 48 layers.
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="llama4-maverick-400b-a17b",
        family="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        experts_per_token=1,
        moe_d_ff=8192,
        block_pattern="de" * 24,
        rope_theta=500_000.0,
        norm_kind="rmsnorm",
        attention_window=8192,
        window_only_for_long=True,
    )
)
