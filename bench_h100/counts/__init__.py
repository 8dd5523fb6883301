"""Operations and bytes worked out from shapes, frozen with the benchmark
so that a change to the program cannot move the yardstick: the Sum-stage
kernels' (``kernels.py``), the card's peaks (``peaks.py``), and one
file a model (``<model>.py``) with the FLOPs of its whole step
(``train_step_flops(cfg, N, E)``) or, for a stack of layers and a
decoder, of one of its layers (``layer_flops(N, E, F, cfg)``)."""
from __future__ import annotations


def train_step_flops(cfg: dict, num_nodes: int, num_edges: int) -> float:
    """The model FLOPs of one training step, forward and backward, on a
    graph of ``num_nodes`` nodes and ``num_edges`` edges (self-loops
    included where the model adds them), every node and edge active:
    every multiply, add, comparison and exponential the model's
    equations ask for. The backward counts twice the forward's work (a
    gradient for the inputs and one for the weights), except the first
    layer's input transform, which needs no input gradient (once). The
    optimizer's few operations a parameter are left out. The model's
    own ``train_step_flops`` where it has one, else the stack's sum over
    its ``layer_flops``."""
    from bench_h100.spec import piece
    counts = piece("counts", cfg["model"])
    if hasattr(counts, "train_step_flops"):
        return float(counts.train_step_flops(cfg, num_nodes, num_edges))
    layer = counts.layer_flops
    N, E = num_nodes, num_edges
    dims = [cfg["feature_dim"]] + [cfg["hidden_dim"]] * cfg["num_layers"]
    total = 0.0
    for k in range(cfg["num_layers"]):
        transform, rest = layer(N, E, dims[k], cfg)
        total += transform * (2 if k == 0 else 3) + 3 * rest
    C = cfg["num_classes"]
    decoder = 2 * N * cfg["hidden_dim"] * C + N * C
    loss = 4 * N * C
    return float(total + 3 * decoder + 3 * loss)
