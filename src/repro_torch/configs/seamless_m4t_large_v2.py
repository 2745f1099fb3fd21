"""seamless-m4t-large-v2 — encoder-decoder multimodal translation backbone
[arXiv:2308.11596].

The speech frontend (mel-spectrogram + conv feature extractor) is a stub,
as in the reference: the encoder consumes precomputed frame embeddings
(``src_frames``, drawn by ``make_batch``). 24 encoder layers + 24 decoder
layers with cross-attention ('c' blocks). kv=16 = num_heads (full MHA).
"""
from repro_torch.config.registry import register
from repro_torch.config.types import ModelConfig

CONFIG = register(
    ModelConfig(
        arch_id="seamless-m4t-large-v2",
        family="audio",
        source="arXiv:2308.11596",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        block_pattern="c" * 24,
        num_encoder_layers=24,
        encoder_is_stub_input=True,
        rope_kind="none",          # seamless uses learned/relative pos; we
        norm_kind="layernorm",     # use rope-free layernorm blocks
        attention_window=8192,
        window_only_for_long=True,
    )
)
