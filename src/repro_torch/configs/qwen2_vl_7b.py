"""qwen2-vl-7b — VLM decoder with M-RoPE and dynamic resolution
[arXiv:2409.12191].

The vision frontend (ViT + projector) is a stub, as in the reference:
``make_batch`` draws precomputed patch embeddings of the right shape;
this config is the language decoder that consumes them. M-RoPE splits each
rotary half into (temporal, height, width) sections = (16, 24, 24),
summing to head_dim/2 = 64.
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="qwen2-vl-7b",
        family="vlm",
        source="arXiv:2409.12191",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        norm_kind="rmsnorm",
        num_vision_tokens=1024,     # dynamic-resolution stub budget
        attention_window=8192,
        window_only_for_long=True,
    )
)
