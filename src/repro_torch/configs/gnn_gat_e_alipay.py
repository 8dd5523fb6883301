"""The paper's §5.2.2 configuration: GAT-E (edge-attributed attention, a
simplified GIPA) on the Alipay graph's power-law edge-attributed
stand-in, trained with all three strategies (Table 4). Widths and
training settings as in ``repro/configs/gnn_gat_e_alipay.py``; the
generator's node features are 32 wide."""
from repro_torch.config import GNNConfig, TrainConfig

CONFIG = GNNConfig(model="gat_e", num_layers=2, hidden_dim=32,
                   num_classes=2, feature_dim=32, edge_feature_dim=8,
                   num_heads=4)
TRAIN = {
    "global": TrainConfig(strategy="global", lr=5e-3, steps=400),
    "mini": TrainConfig(strategy="mini", lr=5e-3, steps=3000),
    "cluster": TrainConfig(strategy="cluster", lr=5e-3, steps=3000,
                           cluster_halo_hops=1),
}
DATASET = "alipay_like"
