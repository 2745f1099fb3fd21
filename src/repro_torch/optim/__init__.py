from repro_torch.optim.adamw import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    cosine_lr,
    init_state,
)

# The reference's public names; the port's own (``clip_by_global_norm``)
# stay importable by name.
__all__ = [
    "AdamWState",
    "init_state",
    "cosine_lr",
    "apply_updates",
]
