"""GNN model and training configuration (the counterpart of
``repro/config.py``'s ``GNNConfig`` and ``TrainConfig``)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"              # gcn | sage | sage_max | gat | gat_e
    num_layers: int = 2
    hidden_dim: int = 16
    num_classes: int = 7
    feature_dim: int = 64
    edge_feature_dim: int = 0       # >0 enables edge-attributed models (GAT-E)
    num_heads: int = 1              # GAT heads
    dropout: float = 0.5
    residual: bool = False
    mean_aggregate: bool = True     # mean vs sum neighbor aggregation
    # Sum-stage aggregation backend: "csc" (the CUDA kernels, their plain
    # versions on the CPU) or "reference" (plain segment ops, CPU only);
    # see repro_torch.core.aggregate
    aggregate_backend: str = "csc"


@dataclass(frozen=True)
class TrainConfig:
    strategy: str = "global"        # global | mini | cluster
    lr: float = 1e-2
    weight_decay: float = 5e-4
    optimizer: str = "adam"         # sgd | adam | adamw
    steps: int = 200
    batch_nodes: int = 0            # mini-batch: #target nodes (0 = 1%)
    batch_clusters: int = 0         # cluster-batch: #clusters per step
    cluster_halo_hops: int = 0      # boundary halo (paper's optional feature)
    seed: int = 0
    grad_clip: float = 0.0


def get_gnn_config(name: str):
    """``(CONFIG, DATASET)`` of a config module under
    ``repro_torch.configs`` (e.g. ``"gnn_gat_e_alipay"``)."""
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG, mod.DATASET
