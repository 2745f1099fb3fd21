from repro_torch.utils.tree import (
    tree_size_bytes,
    tree_param_count,
    tree_map_with_path_names,
    check_no_nans,
    cast_floating,
)
from repro_torch.utils.log import get_logger

# The reference's public names; the port's own (``cast_floating``) stay
# importable by name.
__all__ = [
    "tree_size_bytes",
    "tree_param_count",
    "tree_map_with_path_names",
    "check_no_nans",
    "get_logger",
]
