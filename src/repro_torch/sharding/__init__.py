from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    placements,
    resolve_spec,
    shardings_for_specs,
)

# The reference's public names; the port's own (``placements``) stay
# importable by name.
__all__ = [
    "DEFAULT_RULES",
    "resolve_spec",
    "shardings_for_specs",
]
