"""Parameters, gradients and optimizer state carried over from the JAX
package (a gradient tree is shaped as the params: ``params_from_jax``
names it too).

The JAX package keeps a model's parameters as a nested dict/list tree;
the port keeps the same names and layouts as ``nn.Module`` attributes,
so the tree's paths joined with ``.`` are the port model's
``state_dict`` keys (``{"layers": [{"w": ...}]}`` -> ``"layers.0.w"``).
The LM zoo's stacked blocks are unrolled by :func:`lm_params_from_jax`.
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


def lm_params_from_jax(cfg, tree) -> "OrderedDict[str, torch.Tensor]":
    """A :class:`~repro_torch.arch.TransformerLM` ``state_dict`` from the
    JAX package's LM params (``repro/arch/model.py``), given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    Layout mapping: every path but ``blocks`` keeps its name
    (``embed.table``, ``final_norm.scale``, ``lm_head``). The reference
    stacks the blocks: ``params["blocks"]`` is a list with one entry per
    layer kind of a group (one entry for a dense or RWKV model), each a
    dict whose leaves carry a leading ``n_groups`` axis, and layer ``g *
    len(blocks) + s`` is entry ``s`` at index ``g``. The port keeps one
    block per layer: leaf ``a[g]`` of entry ``s`` becomes
    ``blocks.<g * len(blocks) + s>.<path>``. Weights keep their
    ``(d_in, d_out)`` layout; every array arrives as float32 and
    ``load_state_dict`` casts it to the parameter's dtype."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    groups = tree["blocks"]
    per_group = len(groups)
    for key, value in params_from_jax(
            {k: v for k, v in tree.items() if k != "blocks"}).items():
        out[key] = value
    n_groups = None
    for s, entry in enumerate(groups):
        for path, stacked in params_from_jax(entry).items():
            n_groups = stacked.shape[0] if n_groups is None else n_groups
            if stacked.shape[0] != n_groups:
                raise ValueError(f"blocks[{s}].{path}: {stacked.shape[0]} "
                                 f"groups, expected {n_groups}")
            for g in range(n_groups):
                out[f"blocks.{g * per_group + s}.{path}"] = \
                    stacked[g].clone()
    if n_groups is not None and n_groups * per_group != cfg.num_layers:
        raise ValueError(f"{n_groups} groups of {per_group} blocks, the "
                         f"config has {cfg.num_layers} layers")
    return out
