"""Host-side batch staging (the counterpart of ``repro/data``): the GNN
feature batches and the LM zoo's synthetic token stream."""
from repro_torch.data.graphs import graph_feature_batch
from repro_torch.data.tokens import SyntheticLMDataset, token_batches

__all__ = ["SyntheticLMDataset", "token_batches", "graph_feature_batch"]
