"""olmo-1b — dense decoder with non-parametric LayerNorm and tied
embeddings [arXiv:2402.00838]."""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="olmo-1b",
        family="dense",
        source="arXiv:2402.00838",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm_kind="nonparametric",  # OLMo: LN without scale/bias
        tie_embeddings=True,
        rope_theta=10000.0,
        attention_window=8192,
        window_only_for_long=True,
    )
)
