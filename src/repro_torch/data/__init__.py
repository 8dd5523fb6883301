"""Host-side batch staging (the counterpart of ``repro/data``). The
token streams of ``repro/data/tokens.py`` wait for LM training (ROADMAP
A.12)."""
from repro_torch.data.graphs import graph_feature_batch

__all__ = ["graph_feature_batch"]
