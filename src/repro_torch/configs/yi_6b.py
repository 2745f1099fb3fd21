"""yi-6b — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="yi-6b",
        family="dense",
        source="arXiv:2403.04652",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        norm_kind="rmsnorm",
        # long_500k runs the sliding-window variant (sub-quadratic); all
        # other shapes keep paper-exact full causal attention.
        attention_window=8192,
        window_only_for_long=True,
    )
)
