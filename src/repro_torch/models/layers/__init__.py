"""Transformer layers of the dense decoder: norms, RoPE, MLPs, attention."""
