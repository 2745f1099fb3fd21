"""Deterministic numpy data streams (shared bit for bit with the
reference's, so both packages see identical batches)."""
from repro_torch.data.synthetic import (
    ImageStream,
    ShardedLoader,
    TokenStream,
    make_batch,
)

__all__ = ["TokenStream", "ImageStream", "ShardedLoader", "make_batch"]
