"""Helpers over named tensors (the port's counterpart of the reference's
pytree helpers in ``repro/utils/tree.py``): a model's parameters, their
gradients and the optimizer's moments are dicts keyed by ``state_dict``
names."""
from __future__ import annotations

from typing import Mapping

import torch


def tree_global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
