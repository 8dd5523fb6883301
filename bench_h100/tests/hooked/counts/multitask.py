"""FLOPs of the test model's whole training step
(``reference/multitask.py``)."""


def train_step_flops(cfg: dict, N: int, E: int) -> float:
    """Forward, and twice it for the backward, except the encoder's input
    transform, which needs no input gradient (once)."""
    F, D = cfg["feature_dim"], cfg["hidden_dim"]
    De, T = cfg["edge_feature_dim"], cfg["num_tasks"]
    transform = 2 * N * F * D
    rest = (N * D                                   # encoder bias
            + 2 * E * De * D + 4 * E * D            # message
            + 7 * E * D + N * D                     # softmax, weighted sum
            + N * D + 2 * N * D * D + N * D         # h + M, the MLP
            + 8 * N * D + 2 * N * D                 # LayerNorm, ReLU, residual
            + 2 * N * D * T + N * T                 # decoder
            + 5 * N * T)                            # loss
    return float(2 * transform + 3 * rest)
