"""What a model's own files may declare in place of the yardstick's
defaults: its parameters, their starting values, its forward pass and
loss (``reference/<model>.py``) and its step's FLOPs
(``counts/<model>.py``). A test model kept with the tests
(``hooked/reference/multitask.py``, ``hooked/counts/multitask.py``:
an input encoder, a LayerNorm gain and a temperature that start at 1, a
decoder to 5 tasks, a masked binary cross-entropy) goes through the
harness's functions by its files alone; and the models that declare
none of it keep the values that the yardstick gave them before there
was any hook (``default_path.json``)."""
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100 import check, counts, spec as specs
from bench_h100.data import make_graph
from bench_h100.reference import train
from bench_h100.tests.cells import SMALL

HERE = Path(__file__).resolve().parent
CFG = {"model": "multitask", "feature_dim": 6, "edge_feature_dim": 3,
       "hidden_dim": 8, "num_tasks": 5, "lr": 0.01, "weight_decay": 0.0}
SHAPES = {"encoder.w": (6, 8), "encoder.b": (8,),
          "layers.0.edge.w": (3, 8), "layers.0.edge.b": (8,),
          "layers.0.t": (), "layers.0.mlp.w": (8, 8), "layers.0.mlp.b": (8,),
          "layers.0.norm.gain": (8,), "layers.0.norm.bias": (8,),
          "decoder.w": (8, 5), "decoder.b": (5,)}
ONES = {"layers.0.norm.gain", "layers.0.t"}
DEFAULT = json.loads((HERE / "default_path.json").read_text())


@pytest.fixture
def hooked(monkeypatch):
    """The pieces' lookup pointed at the test model's folder."""
    monkeypatch.setattr(specs, "BENCH", HERE / "hooked")
    return specs.piece("reference", CFG["model"])


def _graph(seed: int, N: int = 12, fan_in: int = 3) -> dict:
    """``fan_in`` distinct sources into every node, 5 binary targets a
    node, two nodes out of the loss."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.choice(np.delete(np.arange(N), i), fan_in,
                                     replace=False) for i in range(N)])
    dst = np.repeat(np.arange(N), fan_in)
    mask = np.ones(N, np.float32)
    mask[[1, 5]] = 0.0
    return {"num_nodes": N, "src": src.astype(np.int32),
            "dst": dst.astype(np.int32),
            "x": rng.standard_normal((N, 6)).astype(np.float32),
            "edge_attr": rng.standard_normal((N * fan_in, 3)).astype(
                np.float32),
            "y": (rng.random((N, 5)) < 0.4).astype(np.float32),
            "loss_mask": mask}


def test_param_shapes_holds_every_tensor_the_model_declares(hooked):
    assert train.param_shapes(CFG) == SHAPES


def test_make_params_starts_each_tensor_as_the_model_says(hooked):
    p = train.make_params(CFG, 3000000019, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == SHAPES
    # the one draw over the sorted names, as if no tensor were constant
    names = sorted(SHAPES)
    sizes = [math.prod(SHAPES[n]) for n in names]
    gen = torch.Generator().manual_seed(3000000019)
    flat = dict(zip(names, torch.randn(sum(sizes), generator=gen)
                    .split(sizes)))
    for n in names:
        how = hooked.initial(n, SHAPES[n])
        assert (how == 1.0) == (n in ONES)
        if how == "normal":
            want = flat[n].reshape(SHAPES[n]) / math.sqrt(SHAPES[n][0])
            assert torch.equal(p[n], want), n
        else:
            assert torch.equal(p[n], torch.full(SHAPES[n], float(how))), n


def test_train_steps_move_every_leaf(hooked):
    p = train.make_params(CFG, 11, "cpu")
    out = train.train_steps(CFG, p, [_graph(s) for s in (1, 2, 3)], "cpu")
    assert len(out["losses"]) == 3 and all(map(math.isfinite,
                                               out["losses"]))
    assert set(out["grad1"]) == set(SHAPES)
    for k, g in out["grad1"].items():
        assert float(g.norm()) > 0, k
        assert float(out["change"][k].norm()) > 0, k


def test_the_first_loss_is_the_binary_cross_entropy_of_the_logits(hooked):
    p = train.make_params(CFG, 12, "cpu")
    g = _graph(4)
    gd = train.to_device(CFG, g, "cpu")
    assert gd["y"].dtype == torch.float32 and gd["y"].shape == (12, 5)
    with torch.no_grad():
        z = hooked.logits(CFG, p, gd)
    s = torch.sigmoid(z.double())
    y = torch.as_tensor(g["y"]).double()
    bce = -(y * torch.log(s) + (1 - y) * torch.log(1 - s)).mean(1)
    m = torch.as_tensor(g["loss_mask"]).double()
    want = float((bce * m).sum() / m.sum())
    got = train.train_steps(CFG, p, [g], "cpu")["losses"][0]
    assert got == pytest.approx(want, rel=1e-6)


def test_the_step_flops_are_the_models_own(hooked):
    N, E, F, D, De, T = 4, 10, 6, 8, 3, 5
    rest = (N * D + 2 * E * De * D + 4 * E * D + 7 * E * D + N * D
            + N * D + 2 * N * D * D + N * D + 8 * N * D + 2 * N * D
            + 2 * N * D * T + N * T + 5 * N * T)
    assert counts.train_step_flops(CFG, N, E) == float(
        2 * 2 * N * F * D + 3 * rest)


@pytest.mark.parametrize("workload", sorted(DEFAULT["cells"]))
def test_a_model_that_declares_nothing_keeps_its_values(workload):
    """Parameters bit for bit, their shapes, the reference's three losses
    on the CPU bit for bit (one thread, so the sums' order is fixed) and
    the step's FLOPs, at the cell's test size and one seed."""
    want, seed = DEFAULT["cells"][workload], DEFAULT["seed"]
    c = specs.load_cell(specs.load_benchmark(), workload, SMALL[workload])
    cfg, mix = c["cfg"], c["mix"]
    assert {k: list(v) for k, v in train.param_shapes(cfg).items()} \
        == want["param_shapes"]
    params = train.make_params(cfg, seed, "cpu")
    assert {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16]
            for k, v in params.items()} == want["digest"]
    g = make_graph(cfg, mix, seed, "cpu")
    assert (g["num_nodes"], len(g["src"])) == (want["N"], want["E"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train.train_steps(cfg, params,
                                check.step_graphs(mix, g, seed, 3), "cpu")
    finally:
        torch.set_num_threads(threads)
    assert [x.hex() for x in out["losses"]] == want["losses"]
    assert counts.train_step_flops(cfg, want["N"], want["E"]).hex() \
        == want["flops"]
