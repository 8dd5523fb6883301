"""FLOPs of one GCN layer's forward pass."""


def layer_flops(N: int, E: int, F: int, cfg: dict) -> tuple:
    """(the input transform's, the rest's) on N nodes, E edges (the
    self-loops among them) and F input features."""
    D = cfg["hidden_dim"]
    transform = 2 * N * F * D
    rest = 2 * E * D + 2 * N * D                   # norm x, sum; bias, ReLU
    return transform, rest
