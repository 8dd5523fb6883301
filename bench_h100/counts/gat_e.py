"""FLOPs of one GAT-E layer's forward pass."""


def layer_flops(N: int, E: int, F: int, cfg: dict) -> tuple:
    """(the input transform's, the rest's) on N nodes, E edges and F
    input features."""
    D, H, De = cfg["hidden_dim"], cfg["num_heads"], cfg["edge_feature_dim"]
    transform = 2 * N * F * D                      # h W
    rest = (2 * 2 * N * D                          # the two attention halves
            + 2 * E * De * H + 2 * E * De * D      # edge attribute products
            + 3 * E * H                            # logit sums, leaky ReLU
            + E * D                                # value = n_src + e_val
            + E * H * 4 + 2 * E * D + N * D        # softmax, weighted sum
            + 2 * N * D)                           # bias, ELU
    return transform, rest
