"""NN-TGAR: the paper's graph-learning compute pattern (§3).

One GNN encoding layer = NN-Transform -> NN-Gather -> Sum -> NN-Apply.
A :class:`TGARLayer` is an ``nn.Module`` that owns its parameters and
implements the three neural stages; the Sum stage is
:func:`repro_torch.core.aggregate.combine`, chosen by ``combine``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core import aggregate as agg
from repro_torch.graph.csr import GraphBlock
from repro_torch.kernels import ops
from repro_torch.kernels.plan import CSCPlan


class TGARLayer(nn.Module):
    """One encoding layer in the NN-TGAR pattern.

    transform(h) -> n                                  # NN-T, per node
    gather(n_src, n_dst, edge_attr, edge_w, edge_mask) -> msg   # NN-G
        msg is {"value": (E, H, D)} and, for combine == "softmax",
        additionally {"logit": (E, H)}.
    node_apply(h, M) -> h_next                         # NN-A, per node
        (the reference's ``apply``, renamed: ``nn.Module.apply`` is taken)
    """
    combine: str = "sum"

    def __init__(self, name: str, out_dim: int, heads: int = 1):
        super().__init__()
        self.name = name
        self.out_dim = int(out_dim)
        self.heads = int(heads)

    def transform(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def gather(self, n_src, n_dst, edge_attr, edge_w, edge_mask):
        raise NotImplementedError

    def node_apply(self, h: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _PlannedGather(torch.autograd.Function):
    """``v[idx]`` whose backward is a segment sum over ``plan``, the plan
    over ``idx`` (``d_v[i]`` sums ``g`` over the edges with ``idx == i``,
    in plan order). torch's own backward of ``index_select`` is an
    ``index_add_``, atomic on CUDA and so not the same from run to run;
    this one is the ``segment_sum`` kernel: no atomics, the same bits on
    every run. Pad edges join no row of the plan: the combine masks
    their messages, so their cotangent is 0 and dropping it changes
    nothing."""

    @staticmethod
    def forward(ctx, v, idx, plan: CSCPlan):
        ctx.plan = plan
        return v.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        # autograd may hand the cotangent over expanded (stride 0)
        return ops.segment_sum_op(g.contiguous(), ctx.plan), None, None


def tree_take(tree: Dict[str, torch.Tensor], idx: torch.Tensor,
              plan: Optional[CSCPlan] = None):
    """Index the leading axis of every entry (edge-endpoint lookup).
    ``plan`` — the plan over ``idx`` (a block's ``src_plan`` for its
    ``src``, ``csc_plan`` for its ``dst``) — makes the backward the
    deterministic segment sum of :class:`_PlannedGather`; without one
    (or with no gradient to take) it is plain ``index_select``."""
    out = {}
    for k, v in tree.items():
        if plan is not None and v.requires_grad and torch.is_grad_enabled():
            out[k] = _PlannedGather.apply(v, idx, plan)
        else:
            out[k] = v.index_select(0, idx)
    return out


def layer_forward_block(layer: TGARLayer, h: torch.Tensor, block: GraphBlock,
                        layer_idx: int, num_nodes: int, backend=None):
    """Forward one TGAR layer on a GraphBlock, applying the per-layer
    active sets (paper §4.2) so a view computes exactly its K-hop
    neighbourhood. ``backend`` picks the Sum-stage backend; the block's
    plan feeds the ``"csc"`` kernels."""
    edge_mask = block.edge_mask
    node_act = None
    if block.edge_active is not None:
        edge_mask = edge_mask * block.edge_active[layer_idx]
    if block.node_active is not None:
        node_act = block.node_active[layer_idx]

    n = layer.transform(h)                                # NN-T
    n_src = tree_take(n, block.src, block.src_plan)
    n_dst = tree_take(n, block.dst, block.csc_plan)
    msg = layer.gather(n_src, n_dst, block.edge_attr, block.edge_weight,
                       edge_mask)                         # NN-G
    M = agg.combine(layer.combine, msg, block.dst, num_nodes, edge_mask,
                    backend=backend, plan=block.csc_plan)  # Sum
    h_next = layer.node_apply(h, M)                       # NN-A
    if node_act is not None:
        h_next = h_next * node_act[:, None]
    return h_next * block.node_mask[:, None]
