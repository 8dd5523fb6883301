"""Host-side helpers: named-tensor trees, timers and the logger (the
counterparts of ``repro/utils``)."""
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer, timed
from repro_torch.utils.tree import tree_global_norm

__all__ = ["tree_global_norm", "Timer", "timed", "get_logger"]
