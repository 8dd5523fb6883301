"""Full-graph training: every step is the whole graph, its loss over the
training nodes."""
import numpy as np


def step_graphs(g: dict, mix: dict, seed: int, steps: int) -> list:
    """The graphs of the program's first ``steps`` steps, worked out again
    from the input graph: the whole graph each time."""
    full = {**g, "loss_mask": g["train_mask"].astype(np.float32)}
    return [full] * steps


def warmup_steps(mix: dict, done: int) -> int:
    """Steps the warm-up runs after the ``done`` first ones, before the
    steps that size the window: the traffic's ``warmup_steps`` (the one
    view is staged and captured by the first step)."""
    return int(mix.get("warmup_steps", 0))
