"""The paper's Table-3 / §5.3 configuration: GCN hidden 128 on the dense
co-comment graph (Reddit stand-in, with self-loops), all three
strategies. Widths and training settings as in
``repro/configs/gnn_gcn_reddit.py``."""
from repro_torch.config import GNNConfig, TrainConfig

CONFIG = GNNConfig(model="gcn", num_layers=2, hidden_dim=128,
                   num_classes=8, feature_dim=64)
TRAIN = {
    "global": TrainConfig(strategy="global", lr=1e-2, steps=500),
    "mini": TrainConfig(strategy="mini", lr=1e-2, steps=600),
    "cluster": TrainConfig(strategy="cluster", lr=1e-2, steps=600,
                           cluster_halo_hops=1),
}
DATASET = "reddit_like"
