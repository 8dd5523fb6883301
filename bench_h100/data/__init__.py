"""The benchmark's graph generators, one file a generator
(``data/<generator>.py``, a function ``make(cfg, params, seed,
device)``), found by the traffic file's ``graph.generator``. They import
nothing of the program."""
from __future__ import annotations


def make_graph(cfg: dict, mix: dict, seed: int, device="cpu") -> dict:
    """The cell's graph as a dict of numpy arrays: ``src``, ``dst``
    (int32), ``num_nodes``, ``x`` (N, F) float32, ``y`` (N,) int32, a
    class a node, or (N, T) float32, a node's 0/1 targets of T binary
    tasks (the reference takes the one as ``long``, the other as float32,
    by its number of axes), ``edge_attr`` (E, De) float32 or None,
    ``train_mask``, ``val_mask``, ``test_mask`` (bool). Sizes and widths
    come from the configuration, the generator's own parameters from the
    traffic mix."""
    from bench_h100.spec import piece
    params = dict(mix["graph"])
    return piece("data", params.pop("generator")).make(cfg, params, seed,
                                                      device)
