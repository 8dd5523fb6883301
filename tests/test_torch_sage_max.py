"""SAGE-max (max-pooling GraphSAGE) end to end against the JAX package,
on the CPU.

The JAX side runs its ``csc`` backend, the Pallas segment-max pair in
interpret mode: the port's ``csc`` kernels keep that backend's tie rule
(every tied maximum gets the full cotangent, ROADMAP C.1), and ties are
common here — layer 1 pools ReLU outputs, many of them 0. The JAX
``reference`` backend splits ties evenly, so it is not the oracle for the
port's kernels. The same numpy graph and the JAX-initialised parameters
(carried over by ``params_from_jax``) go through both packages:

- the loss and the ``loss_block`` gradients on a compact block and on
  the global block, rel 1e-5;
- ``CompactTrainer`` over 5 global and 5 mini-batch steps: per-step losses
  and final parameters within 1e-4 (float32 sums in another order, grown
  over the steps);
- ``api.train`` / ``infer`` / ``serve`` and the training and serving
  entry points with ``--model sage_max``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.config import GNNConfig as JaxConfig
from repro.core.mpgnn import loss_block as jax_loss_block
from repro.core.strategies import global_batch_view as jax_global_view
from repro.core.strategies import strategy_views as jax_strategy_views
from repro.core.trainer import CompactTrainer as JaxTrainer
from repro.core.views import CompactBlockBuilder as JaxStager
from repro.core.views import ViewBuilder as JaxViewBuilder
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
import repro_torch.optim as topt
from repro_torch.config import GNNConfig
from repro_torch.core.mpgnn import loss_block
from repro_torch.core.strategies import global_batch_view, strategy_views
from repro_torch.core.trainer import CompactTrainer
from repro_torch.core.views import CompactBlockBuilder, ViewBuilder
from repro_torch.graph import make_dataset
from repro_torch.kernels import ops
from repro_torch.models import make_gnn
from repro_torch.weights import (load_jax_params, opt_state_from_jax,
                                 params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
GRAD_REL = 1e-5
TRAIN_TOL = 1e-4
N = 300


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX graph, port graph, JAX model on csc, its params, config
    kwargs) at the Reddit config's shape cut to 300 nodes and hidden 16."""
    jg = jax_dataset("reddit_like", seed=0, num_nodes=N)
    pg = make_dataset("reddit_like", seed=0, num_nodes=N)
    common = dict(model="sage_max", num_layers=2, hidden_dim=16,
                  num_classes=int(pg.labels.max()) + 1,
                  feature_dim=pg.node_features.shape[1])
    jmodel = jax_make_gnn(JaxConfig(aggregate_backend="csc", **common))
    params = jmodel.init(jax.random.PRNGKey(5), common["feature_dim"])
    return jg, pg, jmodel, params, common


def _port_model(setup):
    *_, params, common = setup
    return load_jax_params(make_gnn(GNNConfig(**common)), _np(params))


def _assert_rel(got: torch.Tensor, want: np.ndarray, rel: float, what=""):
    """max |got - want| within ``rel`` of the tensor's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("block", ["compact", "global"])
def test_sage_max_loss_and_gradients_match_jax_csc(setup, block):
    jg, pg, jmodel, params, _ = setup
    if block == "compact":
        targets = np.random.default_rng(4).choice(N, 12, replace=False)
        jb = JaxStager(jg, 2, gcn_norm=False, csc_plan=True).stage(
            JaxViewBuilder(jg, 2, compact=True).khop_compact(targets))
        pb = CompactBlockBuilder(pg, 2, gcn_norm=False, csc_plan=True,
                                 src_plan=True).stage(
            ViewBuilder(pg, 2).khop_compact(targets))
    else:
        jb = jax_global_view(jg, 2).as_block(gcn_norm=False, csc_plan=True)
        pb = global_batch_view(pg, 2).as_block(gcn_norm=False,
                                               csc_plan=True)
    assert pb.src_plan is not None
    model = _port_model(setup)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_loss_block(jmodel, p, jb))(params)
    before = dict(ops.launches)
    loss = loss_block(model, pb)
    loss.backward()
    assert ops.launches == before       # the CPU runs the plain versions
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_REL)
    want = params_from_jax(_np(jgrads))
    assert set(want) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        _assert_rel(p.grad, want[k].numpy(), GRAD_REL, k)


@pytest.mark.parametrize("strategy", ["global", "mini"])
def test_sage_max_trainer_matches_jax_trainer(setup, strategy):
    jg, pg, jmodel, params, _ = setup
    vkw = dict(seed=2, batch_nodes=16, compact=True)
    jo = jopt.adam(1e-2, weight_decay=5e-4)
    jtrainer = JaxTrainer(jmodel, jg, jo, params=params, gcn_norm=False)
    want = jtrainer.fit(jax_strategy_views(jg, strategy, 2, **vkw),
                        steps=5)["losses"]
    model = _port_model(setup)
    trainer = CompactTrainer(model, pg, topt.adam(1e-2, weight_decay=5e-4),
                             gcn_norm=False, device="cpu")
    trainer.opt_state = opt_state_from_jax(_np(jo.init(params)))
    got = trainer.fit(strategy_views(pg, strategy, 2, **vkw),
                      steps=5)["losses"]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for k, w in params_from_jax(_np(jtrainer.params)).items():
        _assert_rel(model.state_dict()[k], w.numpy(), TRAIN_TOL, k)
    assert trainer.buckets_touched == jtrainer.buckets_touched


def test_sage_max_api_train_infer_serve_on_cpu():
    import repro_torch.api as api
    result = api.train(api.TrainJob(dataset="reddit_like", model="sage_max",
                                    hidden=16, strategy="cluster",
                                    compact=True, halo_hops=1, steps=3,
                                    eval_every=0, device="cpu"),
                       log=lambda *_: None)
    assert result.model.aggregate_backend == "csc"
    logits = api.infer(result, nodes=[0, 3, 9])
    assert logits.shape == (3, 8) and np.isfinite(logits).all()
    server = api.serve(result, api.ServeConfig(max_batch=4))
    np.testing.assert_allclose(server.submit([0, 3, 9]), logits, rtol=1e-4,
                               atol=1e-5)


def _run(module: str, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_sage_max_entry_points_run_on_cpu():
    proc = _run("repro_torch.launch.train", "gnn", "--dataset",
                "reddit_like", "--model", "sage_max", "--hidden", "16",
                "--strategy", "mini", "--compact", "--steps", "3",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[cpu] final test acc:" in proc.stdout
    proc = _run("repro_torch.launch.serve_gnn", "--dataset", "reddit_like",
                "--model", "sage_max", "--hidden", "16", "--requests",
                "24", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[cpu] served 24 requests" in proc.stdout
