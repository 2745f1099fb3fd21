"""qwen3-8b — dense decoder with per-head q/k RMSNorm and GQA
[hf:Qwen/Qwen3-8B]."""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="qwen3-8b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        norm_kind="rmsnorm",
        attention_window=8192,
        window_only_for_long=True,
    )
)
