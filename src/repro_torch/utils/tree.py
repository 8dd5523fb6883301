"""Helpers over named tensors (the port's counterpart of the reference's
pytree helpers in ``repro/utils/tree.py``): a model's parameters, their
gradients and the optimizer's moments are dicts keyed by ``state_dict``
names, and each helper maps over the entries as the reference's maps over
a pytree's leaves."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

Tree = Mapping[str, torch.Tensor]


def tree_size_bytes(tree: Tree) -> int:
    """Total bytes of all entries."""
    return sum(x.numel() * x.element_size() for x in tree.values())


def tree_count_params(tree: Tree) -> int:
    """Total element count of all entries."""
    return sum(x.numel() for x in tree.values())


def tree_zeros_like(tree: Tree, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(x, dtype=dtype or x.dtype)
            for k, x in tree.items()}


def tree_cast(tree: Tree, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return {k: x.to(dtype) for k, x in tree.items()}


def tree_global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in float32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def tree_add(a: Tree, b: Tree) -> Dict[str, torch.Tensor]:
    return {k: a[k] + b[k] for k in a}


def tree_scale(tree: Tree, s) -> Dict[str, torch.Tensor]:
    return {k: x * s for k, x in tree.items()}
