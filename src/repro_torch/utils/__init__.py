"""Host-side helpers: named-tensor trees, timers and the logger (the
counterparts of ``repro/utils``)."""
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer, timed
from repro_torch.utils.tree import (
    tree_size_bytes,
    tree_count_params,
    tree_zeros_like,
    tree_cast,
    tree_global_norm,
    tree_add,
    tree_scale,
)

__all__ = [
    "tree_size_bytes",
    "tree_count_params",
    "tree_zeros_like",
    "tree_cast",
    "tree_global_norm",
    "tree_add",
    "tree_scale",
    "Timer",
    "timed",
    "get_logger",
]
