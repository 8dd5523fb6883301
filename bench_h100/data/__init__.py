"""The benchmark's graph generators, one file a generator
(``data/<generator>.py``, a function ``make(cfg, params, seed,
device)``), found by the traffic file's ``graph.generator``. They import
nothing of the program."""
from __future__ import annotations


def make_graph(cfg: dict, mix: dict, seed: int, device="cpu") -> dict:
    """The cell's graph as a dict of numpy arrays: ``src``, ``dst``
    (int32), ``num_nodes``, ``x`` (N, F) float32, ``y`` int32,
    ``edge_attr`` (E, De) float32 or None, ``train_mask``, ``val_mask``,
    ``test_mask`` (bool). Sizes and widths come from the configuration,
    the generator's own parameters from the traffic mix."""
    from bench_h100.spec import piece
    params = dict(mix["graph"])
    return piece("data", params.pop("generator")).make(cfg, params, seed,
                                                      device)
