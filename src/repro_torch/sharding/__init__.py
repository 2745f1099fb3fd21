from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    placements,
    resolve_spec,
    shardings_for_specs,
)

__all__ = ["DEFAULT_RULES", "placements", "resolve_spec",
           "shardings_for_specs"]
