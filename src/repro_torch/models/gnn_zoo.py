"""GNN models as TGAR layers (the counterpart of ``repro/models/gnn_zoo.py``).

- :class:`GCNLayer`  — Proj = h·W, Prop = L(i,j)·n_j, Agg = Σ.
- :class:`SAGELayer` — Prop = n_j, Agg = mean / sum / max,
  Apy = act(h·W_self + M·W_neigh).
- :class:`GATLayer`  — attention logits from (n_i, n_j), Agg = softmax Σ.
- :class:`GATELayer` — GAT-E, the paper's Alipay model (§5.2.2): edge
  attributes join the attention logit and the message value.

Parameters keep the reference's names and layouts, so
:func:`repro_torch.weights.params_from_jax` maps one onto the other.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.tgar import TGARLayer
from repro_torch.nn.layers import Dense, _fan_in_init, matmul


def _leaky_relu(x):
    return F.leaky_relu(x, 0.2)


class GCNLayer(TGARLayer):
    combine = "sum"

    def __init__(self, gen: torch.Generator, in_dim: int, out_dim: int,
                 activation: bool = True, name: str = "gcn"):
        super().__init__(name, out_dim, heads=1)
        self.activation = activation
        self.w = nn.Parameter(_fan_in_init(gen, (in_dim, out_dim)))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def transform(self, h):                    # Proj_k: n = h W
        return {"n": matmul(h, self.w)}

    def gather(self, n_src, n_dst, edge_attr, edge_w, edge_mask):
        # Prop_k: m_{j->i} = L(i,j) * n_j   (edge_w carries the GCN norm)
        return {"value": (n_src["n"] * edge_w[:, None])[:, None, :]}

    def node_apply(self, h, M):                # Apy_k
        out = M[:, 0, :] + self.b
        return F.relu(out) if self.activation else out


class SAGELayer(TGARLayer):
    """GraphSAGE with a pluggable neighbour aggregator: ``aggregate`` is
    "mean", "max" (max-pooling SAGE) or "sum"."""

    def __init__(self, gen: torch.Generator, in_dim: int, out_dim: int,
                 activation: bool = True, name: str = "sage",
                 aggregate: str = "mean"):
        if aggregate not in ("mean", "max", "sum"):
            raise ValueError(f"unknown aggregate {aggregate!r}: expected "
                             "'mean', 'max' or 'sum'")
        super().__init__(name, out_dim, heads=1)
        self.combine = aggregate
        self.activation = activation
        self.w_self = Dense(gen, in_dim, out_dim)
        self.w_neigh = Dense(gen, in_dim, out_dim)

    def transform(self, h):
        return {"n": h}                        # Proj = identity; W in Apy

    def gather(self, n_src, n_dst, edge_attr, edge_w, edge_mask):
        return {"value": n_src["n"][:, None, :]}

    def node_apply(self, h, M):
        out = self.w_self(h) + self.w_neigh(M[:, 0, :])
        return F.relu(out) if self.activation else out


def _head_dot(n: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(N, H, D) . (H, D) -> (N, H): each head's part of a node's row
    against that head's row of ``a``, a product and a sum over D for each
    (node, head) on its own, so that a node's result does not depend on
    how many nodes came with it (a served cache hit's small block against
    a full recompute's large one), where an ``einsum`` over the N rows
    takes a kernel chosen by N."""
    return (n * a).sum(-1)


class GATLayer(TGARLayer):
    combine = "softmax"

    def __init__(self, gen: torch.Generator, in_dim: int, out_dim: int,
                 heads: int = 4, activation: bool = True, name: str = "gat"):
        hd = out_dim // heads
        if hd * heads != out_dim:
            raise ValueError(f"out_dim {out_dim} must be divisible by "
                             f"heads {heads}")
        super().__init__(name, out_dim, heads=heads)
        self.hd = hd
        self.activation = activation
        self.w = nn.Parameter(_fan_in_init(gen, (in_dim, heads * hd)))
        self.a_src = nn.Parameter(_fan_in_init(gen, (heads, hd)))
        self.a_dst = nn.Parameter(_fan_in_init(gen, (heads, hd)))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def transform(self, h):
        n = matmul(h, self.w).reshape(h.shape[0], self.heads, self.hd)
        # per-node halves of the attention logit (NN-T owns node math)
        return {"n": n, "as": _head_dot(n, self.a_src),
                "ad": _head_dot(n, self.a_dst)}

    def gather(self, n_src, n_dst, edge_attr, edge_w, edge_mask):
        logit = _leaky_relu(n_src["as"] + n_dst["ad"])
        return {"logit": logit, "value": n_src["n"]}

    def node_apply(self, h, M):
        out = M.reshape(M.shape[0], self.heads * self.hd) + self.b
        return F.elu(out) if self.activation else out


class GATELayer(GATLayer):
    """Edge-attributed attention (a simplified GIPA)."""

    def __init__(self, gen: torch.Generator, in_dim: int, out_dim: int,
                 edge_dim: int, heads: int = 4, activation: bool = True,
                 name: str = "gat_e"):
        super().__init__(gen, in_dim, out_dim, heads, activation, name)
        self.w_e_att = nn.Parameter(_fan_in_init(gen, (edge_dim, heads)))
        self.w_e_val = nn.Parameter(
            _fan_in_init(gen, (edge_dim, heads * self.hd)))

    def gather(self, n_src, n_dst, edge_attr, edge_w, edge_mask):
        # edge attributes join both the attention logit and the value
        e_att = matmul(edge_attr, self.w_e_att)             # (E, H)
        e_val = matmul(edge_attr, self.w_e_val).reshape(
            edge_attr.shape[0], self.heads, self.hd)
        logit = _leaky_relu(n_src["as"] + n_dst["ad"] + e_att)
        return {"logit": logit, "value": n_src["n"] + e_val}


def make_gnn(cfg, feature_dim: Optional[int] = None, seed: int = 0):
    """An :class:`~repro_torch.core.mpgnn.MPGNNModel` from a GNNConfig,
    with weights drawn from a ``torch.Generator`` seeded by ``seed``."""
    from repro_torch.core.mpgnn import MPGNNModel

    gen = torch.Generator().manual_seed(int(seed))
    f = feature_dim if feature_dim is not None else cfg.feature_dim
    dims = [f] + [cfg.hidden_dim] * cfg.num_layers
    layers = []
    for k in range(cfg.num_layers):
        act = k != cfg.num_layers - 1
        if cfg.model == "gcn":
            layers.append(GCNLayer(gen, dims[k], dims[k + 1], act,
                                   name=f"gcn{k}"))
        elif cfg.model == "sage":
            layers.append(SAGELayer(
                gen, dims[k], dims[k + 1], act, name=f"sage{k}",
                aggregate="mean" if cfg.mean_aggregate else "sum"))
        elif cfg.model == "sage_max":
            layers.append(SAGELayer(gen, dims[k], dims[k + 1], act,
                                    name=f"sage_max{k}", aggregate="max"))
        elif cfg.model == "gat":
            layers.append(GATLayer(gen, dims[k], dims[k + 1], cfg.num_heads,
                                   act, name=f"gat{k}"))
        elif cfg.model == "gat_e":
            layers.append(GATELayer(gen, dims[k], dims[k + 1],
                                    cfg.edge_feature_dim, cfg.num_heads,
                                    act, name=f"gat_e{k}"))
        else:
            raise ValueError(f"unknown GNN model {cfg.model!r}")
    return MPGNNModel(layers, cfg.num_classes, gen,
                      aggregate_backend=cfg.aggregate_backend)
