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
from repro_torch.core.aggregate import _PlannedGather  # noqa: F401
from repro_torch.graph.csr import GraphBlock
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


def tree_take(tree: Dict[str, torch.Tensor], idx: torch.Tensor,
              plan: Optional[CSCPlan] = None):
    """Index the leading axis of every entry (edge-endpoint lookup).
    ``plan`` — the plan over ``idx`` (a block's ``src_plan`` for its
    ``src``, ``csc_plan`` for its ``dst``) — makes the backward the
    deterministic segment sum of :class:`_PlannedGather`; without one
    (or with no gradient to take) it is plain ``index_select``
    (:func:`repro_torch.core.aggregate.take`)."""
    return {k: agg.take(v, idx, plan) for k, v in tree.items()}


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
