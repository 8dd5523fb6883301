from repro_torch.models.gnn_zoo import make_gnn

__all__ = ["make_gnn"]
