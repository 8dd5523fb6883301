"""Parameters, gradients and optimizer state carried over from the JAX
package and back (a gradient tree is shaped as the params:
``params_from_jax`` names it too).

The JAX package keeps a model's parameters as a nested dict/list tree;
the port keeps the same names and layouts as ``nn.Module`` attributes,
so the tree's paths joined with ``.`` are the port model's
``state_dict`` keys (``{"layers": [{"w": ...}]}`` -> ``"layers.0.w"``).
The LM zoo's stacked blocks are unrolled by :func:`lm_params_from_jax`.
:func:`params_to_jax` and :func:`opt_state_to_jax` go the other way, for
checkpoints that the reference loads.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch
from torch import nn


def params_from_jax(tree, mesh=None) -> "OrderedDict[str, torch.Tensor]":
    """A ``state_dict`` from the JAX package's params, given as the
    nested dict/list of numpy arrays that
    ``jax.tree_util.tree_map(np.asarray, params)`` returns. With an
    expert-parallel ``mesh`` the MoE expert stacks keep only the
    experts its process holds (:func:`local_experts`)."""
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
    return local_experts(out, mesh)


def local_experts(state: Mapping[str, torch.Tensor], mesh=None
                  ) -> "OrderedDict[str, torch.Tensor]":
    """``state`` with every MoE expert stack (``wi_gate``, ``wi_up`` and
    ``wo`` beside a ``router``) cut to the experts that ``mesh``'s
    process holds (:func:`~repro_torch.arch.moe.expert_range`), as a
    model built over that mesh holds them; unchanged where the
    communicator holds every model rank, or without a mesh."""
    if mesh is None or mesh.comm.count == mesh.model:
        return OrderedDict(state)
    from repro_torch.arch.moe import expert_range
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in state.items():
        head, _, leaf = key.rpartition(".")
        router = f"{head}.router" if head else "router"
        if leaf in ("wi_gate", "wi_up", "wo") and router in state:
            lo, hi = expert_range(state[router].shape[-1], mesh.model,
                                  mesh.comm.start, mesh.comm.count)
            value = value[lo:hi].clone()
        out[key] = value
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


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX package's nested
    params tree, as numpy arrays on the host, from a ``state_dict`` (or
    any mapping of ``state_dict`` names to tensors). A numeric path
    segment indexes a list (``"layers.0.w"`` -> ``{"layers": [{"w":
    ...}]}``), as the reference holds its layers, so a checkpoint of this
    tree records the reference's spec."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy().copy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            if sorted(map(int, node)) != list(range(len(node))):
                raise ValueError(f"list indices {sorted(node)} are not "
                                 "0..n-1")
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def opt_state_to_jax(state: Mapping) -> dict:
    """The reference's optimizer state from the port's: ``{"step": int32
    scalar, "m", "v"}`` (adam, adamw) or ``{"step"[, "mu"]}`` (sgd), each
    moment as a params tree (:func:`params_to_jax`)."""
    out = {"step": np.asarray(state["step"], np.int32)}
    for k in ("m", "v", "mu"):
        if k in state:
            out[k] = params_to_jax(state[k])
    return out


def lm_params_from_jax(cfg, tree, mesh=None
                       ) -> "OrderedDict[str, torch.Tensor]":
    """A :class:`~repro_torch.arch.TransformerLM` ``state_dict`` from the
    JAX package's LM params (``repro/arch/model.py``), given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    Layout mapping: every path but ``blocks`` keeps its name
    (``embed.table``, ``final_norm.scale``, ``lm_head``). The reference
    stacks the blocks: ``params["blocks"]`` is a list with one entry per
    slot of a group (one entry for a dense or RWKV model; jamba's are an
    attention slot and ``attn_every - 1`` Mamba slots), each a
    dict whose leaves carry a leading ``n_groups`` axis, and layer ``g *
    len(blocks) + s`` is entry ``s`` at index ``g``. The port keeps one
    block per layer: leaf ``a[g]`` of entry ``s`` becomes
    ``blocks.<g * len(blocks) + s>.<path>``. Weights keep their
    ``(d_in, d_out)`` layout, an MoE FFN's expert stacks their ``(E,
    d_in, d_out)`` (``ffn.router``, ``ffn.wi_gate``, ...); every array
    arrives as float32 and ``load_state_dict`` casts it to the
    parameter's dtype. The port builds a bf16 model's MoE router and
    Mamba's ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` as float32
    parameters, as the reference keeps them, so they stay float32.

    Whisper's ``encoder`` is one block dict whose leaves carry a leading
    ``encoder_layers`` axis: leaf ``a[i]`` becomes ``encoder.<i>.<path>``;
    ``enc_norm``, the decoder blocks' ``norm_x`` and ``xattn``, the
    LayerNorms' ``bias`` and the GELU MLP's ``wi``/``wo`` (``w``, ``b``)
    keep their names. With an expert-parallel ``mesh`` the expert stacks
    keep the experts its process holds (:func:`local_experts`)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    groups = tree["blocks"]
    per_group = len(groups)
    for key, value in params_from_jax(
            {k: v for k, v in tree.items()
             if k not in ("blocks", "encoder")}).items():
        out[key] = value
    if "encoder" in tree:
        for path, stacked in params_from_jax(tree["encoder"]).items():
            if stacked.shape[0] != cfg.encoder_layers:
                raise ValueError(f"encoder.{path}: {stacked.shape[0]} "
                                 f"layers, the config has "
                                 f"{cfg.encoder_layers}")
            for i in range(stacked.shape[0]):
                out[f"encoder.{i}.{path}"] = stacked[i].clone()
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
    return local_experts(out, mesh)
