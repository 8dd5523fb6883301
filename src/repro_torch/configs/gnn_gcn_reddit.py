"""The paper's Table-3 / §5.3 configuration: GCN hidden 128 on the dense
co-comment graph (Reddit stand-in, served with self-loops). Widths as in
``repro/configs/gnn_gcn_reddit.py``."""
from repro_torch.config import GNNConfig

CONFIG = GNNConfig(model="gcn", num_layers=2, hidden_dim=128,
                   num_classes=8, feature_dim=64)
DATASET = "reddit_like"
