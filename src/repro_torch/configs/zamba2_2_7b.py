"""zamba2-2.7b — Mamba2 backbone with a single shared attention block
invoked periodically [arXiv:2411.15242].

54 Mamba2 blocks; one weight-shared attention+MLP block ('A') runs after
every 6 Mamba2 blocks (9 invocations, one parameter set). ssm_state=64.
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="zamba2-2.7b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state_dim=64,
        ssm_conv_width=4,
        ssm_expand=2,
        block_pattern="m" * 54,
        shared_attention_every=6,
        norm_kind="rmsnorm",
        # shared attention block uses a sliding window at long context;
        # the Mamba2 state is O(1), so long_500k runs natively.
        attention_window=8192,
        window_only_for_long=True,
    )
)
