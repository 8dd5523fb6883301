"""Parameters, gradients and optimizer state carried over from the JAX
package (a gradient tree is shaped as the params: ``params_from_jax``
names it too).

The JAX package keeps a model's parameters as a nested dict/list tree;
the port keeps the same names and layouts as ``nn.Module`` attributes,
so the tree's paths joined with ``.`` are the port model's
``state_dict`` keys (``{"layers": [{"w": ...}]}`` -> ``"layers.0.w"``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch
from torch import nn


def params_from_jax(tree) -> "OrderedDict[str, torch.Tensor]":
    """A ``state_dict`` from the JAX package's params, given as the
    nested dict/list of numpy arrays that
    ``jax.tree_util.tree_map(np.asarray, params)`` returns."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node, prefix):
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Load the JAX package's params into ``model`` in place; every
    parameter must be matched by name and shape."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def opt_state_from_jax(tree) -> dict:
    """The port's optimizer state from the reference's: ``{"step", "m",
    "v"}`` (adam, adamw) or ``{"step"[, "mu"]}`` (sgd), each moment tree
    named by ``state_dict`` keys, the step a Python int."""
    out = {"step": int(np.asarray(tree["step"]))}
    for k in ("m", "v", "mu"):
        if k in tree:
            out[k] = dict(params_from_jax(tree[k]))
    return out
