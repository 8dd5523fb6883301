"""The port's model path against the JAX package's on one staged block.

Each model of the zoo runs one layer and the whole two-layer model on a
bucket-padded compact block (with its per-layer ``edge_active`` /
``node_active`` masks) through the JAX ``forward_block`` and the port's,
with the JAX params carried over by ``params_from_jax``. Tolerance rtol
1e-4 / atol 1e-5: float32 sums taken in another order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import GNNConfig as JaxConfig
from repro.core.mpgnn import forward_block as jax_forward_block
from repro.core.tgar import layer_forward_block as jax_layer_forward
from repro.core.views import CompactBlockBuilder as JaxStager
from repro.core.views import ViewBuilder as JaxViewBuilder
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
from repro_torch.config import GNNConfig
from repro_torch.core.mpgnn import forward_block
from repro_torch.core.tgar import layer_forward_block
from repro_torch.core.views import CompactBlockBuilder, ViewBuilder
from repro_torch.graph import make_dataset
from repro_torch.models import make_gnn
from repro_torch.weights import load_jax_params, params_from_jax

RTOL, ATOL = 1e-4, 1e-5

# model -> (dataset, config kwargs); gat_e at its published widths
MODELS = {
    "gcn": ("reddit_like", dict(model="gcn", hidden_dim=16)),
    "sage_mean": ("reddit_like", dict(model="sage", hidden_dim=16)),
    "sage_sum": ("reddit_like", dict(model="sage", hidden_dim=16,
                                     mean_aggregate=False)),
    "gat": ("reddit_like", dict(model="gat", hidden_dim=16, num_heads=4)),
    "gat_e": ("alipay_like", dict(model="gat_e", hidden_dim=32,
                                  num_heads=4, edge_feature_dim=8)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(key: str, n_targets: int = 12, jax_backend: str = "reference"):
    dataset, kw = MODELS[key]
    jg = jax_dataset(dataset, seed=0, num_nodes=300)
    pg = make_dataset(dataset, seed=0, num_nodes=300)
    if kw["model"] == "gcn":
        jg, pg = jg.add_self_loops(), pg.add_self_loops()
    common = dict(num_layers=2, num_classes=int(pg.labels.max()) + 1,
                  feature_dim=pg.node_features.shape[1], **kw)
    jmodel = jax_make_gnn(JaxConfig(aggregate_backend=jax_backend, **common))
    params = jmodel.init(jax.random.PRNGKey(3), common["feature_dim"])
    model = load_jax_params(make_gnn(GNNConfig(**common)),
                            jax.tree_util.tree_map(np.asarray, params))
    targets = np.random.default_rng(4).choice(300, n_targets, replace=False)
    gcn = kw["model"] == "gcn"
    jb = JaxStager(jg, 2, gcn_norm=gcn, csc_plan=True).stage(
        JaxViewBuilder(jg, 2, compact=True).khop_compact(targets))
    pb = CompactBlockBuilder(pg, 2, gcn_norm=gcn, csc_plan=True).stage(
        ViewBuilder(pg, 2).khop_compact(targets))
    return jmodel, params, jb, model, pb


@pytest.mark.parametrize("backend", ["csc", "reference"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_one_layer_matches_jax(key, backend):
    jmodel, params, jb, model, pb = _setup(key)
    n = pb.num_nodes_padded
    want = jax_layer_forward(jmodel.layers[0], params["layers"][0], jb.x,
                             jb, 0, n, backend="reference")
    with torch.no_grad():
        got = layer_forward_block(model.layers[0], pb.x, pb, 0, n,
                                  backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["csc", "reference"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_two_layer_model_matches_jax(key, backend):
    jmodel, params, jb, model, pb = _setup(key)
    want = np.asarray(jax_forward_block(jmodel, params, jb))
    model.aggregate_backend = backend
    with torch.no_grad():
        got = forward_block(model, pb).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gat_e_matches_jax_pallas_kernel_path():
    """The JAX side on its ``csc`` backend (the Pallas kernels in
    interpret mode) on a tiny view; the port on its kernels' plain
    versions."""
    jmodel, params, jb, model, pb = _setup("gat_e", n_targets=2,
                                           jax_backend="csc")
    want = np.asarray(jax_forward_block(jmodel, params, jb))
    with torch.no_grad():
        got = forward_block(model, pb).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_params_from_jax_names_every_parameter():
    jmodel, params, _, model, _ = _setup("gat_e")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    assert "layers.1.w_e_val" in sd and "decoder.b" in sd
    with pytest.raises(RuntimeError):
        make_gnn(GNNConfig(model="gat", hidden_dim=32, num_heads=4,
                           num_classes=2, feature_dim=32)).load_state_dict(sd)


def test_make_gnn_is_seeded():
    cfg = GNNConfig(model="gat_e", hidden_dim=32, num_heads=4,
                    num_classes=2, feature_dim=32, edge_feature_dim=8)
    a, b = make_gnn(cfg, seed=1), make_gnn(cfg, seed=1)
    c = make_gnn(cfg, seed=2)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.layers[0].w, c.layers[0].w)


@pytest.mark.parametrize("name", ["gnn_gat_e_alipay", "gnn_gcn_reddit"])
def test_served_model_is_the_config(name):
    """The model the serving entry point builds on the config's dataset
    is the config module's CONFIG, widths and all."""
    from repro_torch.config import get_gnn_config
    from repro_torch.launch.serve_gnn import config_for, resolve_graph
    cfg, dataset = get_gnn_config(name)
    g = resolve_graph(dataset, cfg.model)
    assert config_for(g, cfg.model, cfg.num_layers, cfg.hidden_dim) == cfg


@pytest.mark.parametrize("name", ["gnn_gat_e_alipay", "gnn_gcn_reddit"])
def test_train_configs_match_reference(name):
    """The config modules' ``TRAIN`` dicts equal the reference configs',
    strategy by strategy and field by field."""
    import dataclasses
    import importlib
    want = importlib.import_module(f"repro.configs.{name}").TRAIN
    got = importlib.import_module(f"repro_torch.configs.{name}").TRAIN
    assert set(got) == set(want)
    for strategy, cfg in want.items():
        assert (dataclasses.asdict(got[strategy])
                == dataclasses.asdict(cfg)), strategy
