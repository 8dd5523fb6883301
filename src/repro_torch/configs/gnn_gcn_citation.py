"""The paper's Table-2 configuration: 2-layer GCN, hidden 16, on the
citation networks (Cora/Citeseer/Pubmed stand-ins). Widths and training
settings as in ``repro/configs/gnn_gcn_citation.py``; ``DATASET`` is the
first of ``DATASETS``, the graph :func:`repro_torch.config.get_gnn_config`
names."""
from repro_torch.config import GNNConfig, TrainConfig

CONFIG = GNNConfig(model="gcn", num_layers=2, hidden_dim=16, num_classes=7,
                   dropout=0.5)
TRAIN = {
    "global": TrainConfig(strategy="global", lr=1e-2, weight_decay=5e-4,
                          steps=200),
    "mini": TrainConfig(strategy="mini", lr=1e-2, weight_decay=5e-4,
                        steps=300),
}
DATASETS = ("cora", "citeseer", "pubmed")
DATASET = DATASETS[0]
