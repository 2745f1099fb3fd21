from repro_torch.optim.adamw import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    cosine_lr,
    init_state,
)

__all__ = ["AdamWState", "init_state", "cosine_lr", "clip_by_global_norm",
           "apply_updates"]
