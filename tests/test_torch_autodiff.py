"""The paper's backward equivalence (App. A.2) in the port: the explicitly
scheduled reverse NN-TGAR passes of ``repro_torch.core.autodiff`` give
the gradients of the port's own autograd, and the JAX package's explicit
schedule's, for every model of ``tests/test_autodiff.py`` and SAGE-max,
on a global block and a compact mini-batch block.

The JAX schedule runs the ``reference`` Sum stage, so the port is held
against it on its ``reference`` backend (the two share the even split of
tied maxima, ROADMAP C.1); on its ``csc`` kernels it is held against its
own autograd. Tolerances are those of ``tests/test_autodiff.py``: rtol
1e-5, atol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import GNNConfig as JaxConfig
from repro.core.autodiff import explicit_loss_and_grad as jax_explicit
from repro.core.strategies import global_batch_view as jax_global_view
from repro.core.views import CompactBlockBuilder as JaxStager
from repro.core.views import ViewBuilder as JaxViewBuilder
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
from repro_torch.config import GNNConfig
from repro_torch.core.autodiff import explicit_loss_and_grad
from repro_torch.core.mpgnn import loss_block
from repro_torch.core.strategies import global_batch_view
from repro_torch.core.views import CompactBlockBuilder, ViewBuilder
from repro_torch.graph import make_dataset
from repro_torch.models import make_gnn
from repro_torch.weights import load_jax_params, params_from_jax

RTOL, ATOL = 1e-5, 1e-6
MODELS = ["gcn", "sage", "sage_max", "gat", "gat_e"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(name: str, block: str, backend: str):
    """(JAX model, its params, JAX block, port model on ``backend``, port
    block), as ``tests/test_autodiff.py`` builds them."""
    if name == "gat_e":
        jg = jax_dataset("alipay_like", num_nodes=500, seed=0)
        pg = make_dataset("alipay_like", num_nodes=500, seed=0)
    else:
        jg = jax_dataset("cora", seed=0).add_self_loops()
        pg = make_dataset("cora", seed=0).add_self_loops()
    edim = pg.edge_features.shape[1] if pg.edge_features is not None else 0
    common = dict(model=name, num_layers=2, hidden_dim=16,
                  num_classes=int(pg.labels.max()) + 1,
                  feature_dim=pg.node_features.shape[1], num_heads=4,
                  edge_feature_dim=edim)
    jmodel = jax_make_gnn(JaxConfig(**common))
    params = jmodel.init(jax.random.PRNGKey(0), common["feature_dim"])
    model = load_jax_params(
        make_gnn(GNNConfig(aggregate_backend=backend, **common)),
        _np(params))
    gcn = name == "gcn"
    if block == "global":
        jb = jax_global_view(jg, 2).as_block(gcn_norm=gcn)
        pb = global_batch_view(pg, 2).as_block(gcn_norm=gcn, csc_plan=True)
    else:
        targets = np.random.default_rng(1).choice(pg.num_nodes, 16,
                                                  replace=False)
        jb = JaxStager(jg, 2, gcn_norm=gcn).stage(
            JaxViewBuilder(jg, 2, compact=True).khop_compact(targets))
        pb = CompactBlockBuilder(pg, 2, gcn_norm=gcn, csc_plan=True,
                                 src_plan=True).stage(
            ViewBuilder(pg, 2).khop_compact(targets))
    return jmodel, params, jb, model, pb


@pytest.mark.parametrize("block", ["global", "compact"])
@pytest.mark.parametrize("name", MODELS)
def test_explicit_backward_equals_autograd(name, block):
    *_, model, pb = _setup(name, block, "csc")
    loss, grads = explicit_loss_and_grad(model, pb)
    model.zero_grad(set_to_none=True)
    ref = loss_block(model, pb)
    ref.backward()
    assert abs(float(loss) - float(ref.detach())) < 1e-6
    assert set(grads) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        torch.testing.assert_close(grads[k], p.grad, rtol=RTOL, atol=ATOL,
                                   msg=k)


@pytest.mark.parametrize("block", ["global", "compact"])
@pytest.mark.parametrize("name", MODELS)
def test_explicit_backward_matches_jax_schedule(name, block):
    jmodel, params, jb, model, pb = _setup(name, block, "reference")
    jloss, jgrads = jax_explicit(jmodel, params, jb)
    loss, grads = explicit_loss_and_grad(model, pb)
    assert abs(float(loss) - float(jloss)) < 1e-6
    for k, want in params_from_jax(_np(jgrads)).items():
        np.testing.assert_allclose(grads[k].numpy(), want.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
