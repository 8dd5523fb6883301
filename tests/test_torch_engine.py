"""The port's hybrid-parallel engine against the JAX package's, on the CPU.

- The halo exchange: float64 gradchecks of the broadcast and both
  reduces; the halo max's tie gradients against ``jax.grad`` of the
  reference's scatter-max (ROADMAP C.20); two runs bit for bit.
- The engine (``LocalComm``, P=4) against JAX ``loss_block`` on one
  block, the same params through ``params_from_jax``, for every GNN
  model, strategy and Sum-stage backend: loss and gradients within 1e-4,
  the reference's own tolerance (``tests/test_engine_distributed.py``).
- Against the JAX engine itself at P=4 (a subprocess with four host
  devices): step 1 within 1e-5, a 20-step Adam trajectory within 1e-4.
- Worker-count invariance, P in {1, 2, 4, 8}.
- ``ProcessGroupComm`` over gloo, four processes, against ``LocalComm``
  within 1e-6, and a 10-step run on it.
- The engine ``Trainer``: bitwise across staging modes and worker
  counts, its checkpoint into ``CompactTrainer``, ``evaluate`` against
  ``infer``, a strategy switch, parity with ``CompactTrainer`` on the
  same views, the chaos scenarios and the capture contract.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.config import GNNConfig as JaxConfig
from repro.core.clustering import label_propagation_clusters as jax_lp
from repro.core.mpgnn import loss_block as jax_loss_block
from repro.core.strategies import cluster_batch_views as jax_cluster_views
from repro.core.strategies import global_batch_view as jax_global_view
from repro.core.strategies import mini_batch_views as jax_mini_views
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
from repro_torch.config import GNNConfig
from repro_torch.core.aggregate import ShardContext, _finalize
from repro_torch.core.clustering import label_propagation_clusters
from repro_torch.core.comm import LocalComm
from repro_torch.core.engine import (HybridParallelEngine, _bcast_array,
                                     _reduce_array)
from repro_torch.core.mpgnn import loss_block
from repro_torch.core.partition import build_partitions
from repro_torch.core.strategies import (cluster_batch_views,
                                         global_batch_view,
                                         mini_batch_views, shard_view,
                                         strategy_views)
from repro_torch.core.trainer import CompactTrainer, RetraceError, Trainer
from repro_torch.graph import make_dataset
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models import make_gnn
from repro_torch.optim import adam
from repro_torch.runtime import chaos
from repro_torch.weights import load_jax_params, params_from_jax

import torch_engine_workers as workers

TOL = 1e-4          # engine vs one block: the reference's own
STEP1_TOL = 1e-5    # engine vs the JAX engine, step 1
TRAIN_TOL = 1e-4    # over a trajectory
GLOO_TOL = 1e-6     # ProcessGroupComm vs LocalComm
MODELS = ("gcn", "sage", "sage_max", "gat", "gat_e")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(model: str):
    """(JAX graph, port graph): cora for the homogeneous models (GCN with
    self-loops), a 400-node alipay_like graph for GAT-E."""
    if model == "gat_e":
        return (jax_dataset("alipay_like", seed=0, num_nodes=400),
                make_dataset("alipay_like", seed=0, num_nodes=400))
    jg, pg = jax_dataset("cora", seed=0), make_dataset("cora", seed=0)
    if model == "gcn":
        jg, pg = jg.add_self_loops(), pg.add_self_loops()
    return jg, pg


def _config(model: str, g, **kw):
    ed = g.edge_features.shape[1] if g.edge_features is not None else 0
    return dict(model=model, num_layers=2, hidden_dim=16,
                num_classes=int(g.labels.max()) + 1,
                feature_dim=g.node_features.shape[1], num_heads=4,
                edge_feature_dim=ed, **kw)


@functools.lru_cache(maxsize=None)
def _oracle(model: str, strategy: str):
    """The JAX single-block loss and gradients (``reference`` backend)
    over one view, with the port graph, view and the params."""
    jg, pg = _graphs(model)
    jmodel = jax_make_gnn(JaxConfig(aggregate_backend="reference",
                                    **_config(model, pg)))
    params = jmodel.init(jax.random.PRNGKey(0), pg.node_features.shape[1])
    if strategy == "global":
        jv, pv = jax_global_view(jg, 2), global_batch_view(pg, 2)
    elif strategy == "mini":
        jv = next(jax_mini_views(jg, 2, batch_nodes=24, seed=1))
        pv = next(mini_batch_views(pg, 2, batch_nodes=24, seed=1))
    else:
        jc = jax_lp(jg, max_cluster_size=150, iters=2)
        pc = label_propagation_clusters(pg, max_cluster_size=150, iters=2)
        jv = next(jax_cluster_views(jg, 2, jc, clusters_per_batch=4,
                                    halo_hops=1, seed=2))
        pv = next(cluster_batch_views(pg, 2, pc, clusters_per_batch=4,
                                      halo_hops=1, seed=2))
    gcn = model == "gcn"
    loss, grads = jax.value_and_grad(
        lambda p: jax_loss_block(jmodel, p, jv.as_block(gcn_norm=gcn)))(
        params)
    return (float(loss), params_from_jax(_np(grads)), _np(params), pg, pv)


def _engine(model: str, pg, params, P=4, backend="csc", **kw):
    net = load_jax_params(
        make_gnn(GNNConfig(aggregate_backend=backend, **_config(model, pg))),
        params)
    sg = build_partitions(pg, P, gcn_norm=model == "gcn", **kw)
    return HybridParallelEngine(net, sg, device="cpu")


def _max_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max()) for k in want)


# -- the halo exchange --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _small_engine(P: int = 3):
    g = sbm_graph(num_nodes=60, num_classes=3, feature_dim=4, p_in=0.2,
                  p_out=0.05, seed=1)
    net = make_gnn(GNNConfig(model="gcn", num_layers=1, hidden_dim=4,
                             num_classes=3, feature_dim=4), seed=0)
    return HybridParallelEngine(net, build_partitions(g, P), device="cpu")


@pytest.mark.parametrize("op", ["bcast", "sum", "max"])
def test_halo_exchange_gradcheck_float64(op):
    eng = _small_engine()
    shard, comm, plan = eng._device_data, eng.comm, eng.plan
    assert plan.send_mask.sum() > 0
    rng = np.random.default_rng(0)
    rows = shard.L * (plan.n_m_pad if op == "bcast" else plan.n_mir_pad)
    x = torch.from_numpy(rng.normal(size=(rows, 3))).requires_grad_()
    if op == "bcast":
        fn = lambda a: _bcast_array(a, shard, comm)           # noqa: E731
    else:
        fn = lambda a: _reduce_array(a, shard, comm, op)      # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))


def _holders(plan):
    """{(owner p, master slot): [(holder q, mirror slot), ...]} of every
    mirrored master."""
    out = {}
    for p in range(plan.P):
        for q in range(plan.P):
            for i in np.flatnonzero(plan.send_mask[p, q] > 0):
                out.setdefault((p, int(plan.send_idx[p, q, i])), []).append(
                    (q, int(plan.recv_slot[q, p, i])))
    return out


def _jax_halo_max_grads(plan, local, mir, g):
    """``jax.grad`` of the reference's own halo max, finalized as its
    ``_finalize`` does (``jnp.maximum`` of the local partial and the
    scatter-max ``repro/core/engine.py:_reduce_array``), one shard per
    ``vmap`` lane over the same plan arrays: (d local, d mir) as numpy,
    shard-major."""
    from repro.core.aggregate import ShardContext as JaxShardContext
    from repro.core.aggregate import _finalize as jax_finalize
    from repro.core.engine import _reduce_array as jax_reduce
    P, n_m, n_mir = plan.P, plan.n_m_pad, plan.n_mir_pad

    def shard_out(lo, mi, send_idx, send_mask, recv_slot, recv_mask):
        ctx = JaxShardContext(
            n_master=n_m, bcast=None,
            reduce=lambda a, op: jax_reduce(a, send_idx, send_mask,
                                            recv_slot, recv_mask, n_m,
                                            "p", op))
        return jax_finalize(jnp.concatenate([lo, mi]), ctx, "max")

    def total(lo, mi):
        out = jax.vmap(shard_out, axis_name="p")(
            lo, mi, plan.send_idx, plan.send_mask, plan.recv_slot,
            plan.recv_mask)
        return jnp.sum(out * g.reshape(out.shape))

    dl, dm = jax.grad(total, argnums=(0, 1))(
        jnp.asarray(local.reshape(P, n_m, -1)),
        jnp.asarray(mir.reshape(P, n_mir, -1)))
    return np.asarray(dl).reshape(local.shape), \
        np.asarray(dm).reshape(mir.shape)


def _tie_layout(plan, layout: str, rng):
    """(local (P * n_m, 2), mir (P * n_mir, 2)) partials over small
    integers, so that many rows tie, with ``layout``'s master set up on
    top: its holders (two or three) tied at the row's max above the
    owner's partial, or tied with it, or every partial ``NEG``."""
    from repro_torch.core.aggregate import NEG
    P, n_m, n_mir = plan.P, plan.n_m_pad, plan.n_mir_pad
    local = rng.integers(0, 3, (P * n_m, 2)).astype(np.float32)
    mir = rng.integers(0, 3, (P * n_mir, 2)).astype(np.float32)
    if layout == "all_neg":
        # masked entries scatter NEG onto slot 0 of each shard, so those
        # rows count them among the ties too
        return np.full_like(local, NEG), np.full_like(mir, NEG)
    want = 3 if layout == "three_holders" else 2
    (p, slot), hs = next((k, v) for k, v in _holders(plan).items()
                         if len(v) == want)
    local[p * n_m + slot] = 5.0 if layout == "local_tie" else 1.0
    for q, ms in hs:
        mir[q * n_mir + ms] = 5.0
    return local, mir


@pytest.mark.parametrize("layout", ["two_holders", "three_holders",
                                    "local_tie", "all_neg"])
def test_halo_max_tie_rule(layout):
    """ROADMAP C.20. The halo max's gradients are ``jax.grad`` of the
    reference's scatter-max and ``jnp.maximum`` on the same plan and
    partials, over every row at once: k tied holders share a master's
    cotangent (1/k each), a tie with the owner's partial halves it
    first (two holders tied with it: 0.5 to it, 0.25 to each), and a
    ``NEG`` row shares it with the reference's ``NEG`` operand and the
    masked entries scattered there."""
    eng = _small_engine(4)
    shard, comm, plan = eng._device_data, eng.comm, eng.plan
    n_m, n_mir = plan.n_m_pad, plan.n_mir_pad
    rng = np.random.default_rng(3)
    local_np, mir_np = _tie_layout(plan, layout, rng)
    g = rng.normal(size=local_np.shape).astype(np.float32)
    want_local, want_mir = _jax_halo_max_grads(plan, local_np, mir_np, g)

    local = torch.from_numpy(local_np).requires_grad_()
    mir = torch.from_numpy(mir_np).requires_grad_()
    ctx = ShardContext(n_m, n_mir,
                       reduce=lambda a, op: _reduce_array(a, shard, comm,
                                                          op),
                       bcast=lambda a: _bcast_array(a, shard, comm))
    out = _finalize(ctx.join(local, mir), ctx, "max")
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(local.grad.numpy(), want_local)
    np.testing.assert_array_equal(mir.grad.numpy(), want_mir)

    if layout == "all_neg":
        return
    want = 3 if layout == "three_holders" else 2
    (p, slot), hs = next((k, v) for k, v in _holders(plan).items()
                         if len(v) == want)
    share = 0.5 / want if layout == "local_tie" else 1.0 / want
    got = [float(mir.grad[q * n_mir + ms, 0]) for q, ms in hs]
    gp = float(g[p * n_m + slot, 0])
    assert got == pytest.approx([gp * share] * want, rel=1e-6)
    assert float(local.grad[p * n_m + slot, 0]) == pytest.approx(
        gp * 0.5 if layout == "local_tie" else 0.0, rel=1e-6)


@pytest.mark.parametrize("model", ["gat_e", "sage_max"])
def test_engine_repeats_bitwise(model):
    _, _, params, pg, pv = _oracle(model, "mini")
    eng = _engine(model, pg, params)
    view = eng.stage_view(shard_view(eng.plan, pv))
    lg = eng.make_loss_and_grad()
    l1, g1 = lg(view)
    g1 = {k: v.clone() for k, v in g1.items()}
    l2, g2 = lg(view)
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


# -- the engine against the reference -----------------------------------------


@pytest.mark.parametrize("backend", ["reference", "csc"])
@pytest.mark.parametrize("strategy", ["global", "mini", "cluster"])
@pytest.mark.parametrize("model", MODELS)
def test_engine_matches_jax_loss_block(model, strategy, backend):
    want_loss, want_grads, params, pg, pv = _oracle(model, strategy)
    eng = _engine(model, pg, params, backend=backend)
    loss, grads = eng.make_loss_and_grad()(
        eng.stage_view(shard_view(eng.plan, pv)))
    assert abs(float(loss) - want_loss) < TOL, (float(loss), want_loss)
    assert _max_err(grads, want_grads) < TOL


_JAX_ENGINE = r"""
import re
import numpy as np, jax
from repro.graph import make_dataset
from repro.config import GNNConfig
from repro.models import make_gnn
from repro.core.strategies import (global_batch_view, mini_batch_views,
                                   shard_view)
from repro.core.partition import build_partitions
from repro.core.engine import HybridParallelEngine
from repro.optim import adam

def name(path):
    key = jax.tree_util.keystr(path)
    return ".".join(re.findall(r"\['?([^'\]]+)'?\]", key))

out = {}
ga = make_dataset("alipay_like", num_nodes=400, seed=0)
gr = make_dataset("reddit_like", num_nodes=300, seed=0)
for tag, g in (("gat_e", ga), ("sage_max", gr)):
    ed = g.edge_features.shape[1] if g.edge_features is not None else 0
    cfg = GNNConfig(model=tag, num_layers=2, hidden_dim=16,
                    num_classes=int(g.labels.max()) + 1,
                    feature_dim=g.node_features.shape[1], num_heads=4,
                    edge_feature_dim=ed)
    m = make_gnn(cfg)
    params = m.init(jax.random.PRNGKey(0), cfg.feature_dim)
    sg = build_partitions(g, 4, gcn_norm=False)
    eng = HybridParallelEngine(m, sg)
    views = (global_batch_view(g, 2),
             next(mini_batch_views(g, 2, batch_nodes=24, seed=1)))
    for i, view in enumerate(views):
        staged = eng.stage_view(shard_view(sg.plan, view))
        loss, grads = eng.make_loss_and_grad()(params, eng._device_data,
                                               staged)
        out[f"{tag}/{i}/loss"] = np.asarray(loss)
        for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
            out[f"{tag}/{i}/grad/" + name(path)] = np.asarray(leaf)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out[f"{tag}/param/" + name(path)] = np.asarray(leaf)
g = gr.add_self_loops()
cfg = GNNConfig(model="gcn", num_layers=2, hidden_dim=16,
                num_classes=int(g.labels.max()) + 1,
                feature_dim=g.node_features.shape[1])
m = make_gnn(cfg)
params = m.init(jax.random.PRNGKey(0), cfg.feature_dim)
for path, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["gcn/param/" + name(path)] = np.asarray(leaf)
sg = build_partitions(g, 4)
eng = HybridParallelEngine(m, sg)
opt = adam(1e-2)
st = opt.init(params)
step = eng.make_train_step(opt)
va = shard_view(sg.plan, global_batch_view(g, 2))
losses = []
for _ in range(20):
    params, st, loss = step(params, st, va)
    losses.append(float(loss))
out["gcn/losses"] = np.asarray(losses)
np.savez(OUT, **out)
print("ALL_OK")
"""


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX engine's P=4 results, from a subprocess with four host
    devices."""
    path = tmp_path_factory.mktemp("jax_engine") / "out.npz"
    out = run_with_devices(f"OUT = {str(path)!r}\n" + _JAX_ENGINE,
                           n_devices=4, timeout=600)
    assert "ALL_OK" in out
    return dict(np.load(path))


def _params_of(npz: dict, tag: str) -> dict:
    pre = f"{tag}/param/"
    return {k[len(pre):]: torch.from_numpy(v.copy())
            for k, v in npz.items() if k.startswith(pre)}


@pytest.mark.parametrize("model", ["gat_e", "sage_max"])
def test_engine_matches_jax_engine_step1(jax_engine, model):
    g = make_dataset("alipay_like" if model == "gat_e" else "reddit_like",
                     seed=0, num_nodes=400 if model == "gat_e" else 300)
    net = make_gnn(GNNConfig(**_config(model, g)))
    net.load_state_dict(_params_of(jax_engine, model))
    eng = HybridParallelEngine(net, build_partitions(g, 4, gcn_norm=False),
                               device="cpu")
    views = (global_batch_view(g, 2),
             next(mini_batch_views(g, 2, batch_nodes=24, seed=1)))
    for i, view in enumerate(views):
        loss, grads = eng.make_loss_and_grad()(
            eng.stage_view(shard_view(eng.plan, view)))
        want = float(jax_engine[f"{model}/{i}/loss"])
        assert abs(float(loss) - want) < STEP1_TOL, (i, float(loss), want)
        pre = f"{model}/{i}/grad/"
        want_g = {k[len(pre):]: torch.from_numpy(v)
                  for k, v in jax_engine.items() if k.startswith(pre)}
        assert _max_err(grads, want_g) < STEP1_TOL


def test_engine_train_step_matches_jax_engine(jax_engine):
    g = make_dataset("reddit_like", seed=0, num_nodes=300).add_self_loops()
    net = make_gnn(GNNConfig(**_config("gcn", g)))
    net.load_state_dict(_params_of(jax_engine, "gcn"))
    eng = HybridParallelEngine(net, build_partitions(g, 4), device="cpu")
    opt = adam(1e-2)
    state = opt.init(eng.params)
    step = eng.make_train_step(opt)
    arrays = shard_view(eng.plan, global_batch_view(g, 2))
    got = [float(step(state, arrays)) for _ in range(20)]
    want = jax_engine["gcn/losses"]
    assert abs(got[0] - want[0]) < STEP1_TOL
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert got[-1] < 0.5 * got[0]


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_engine_worker_count_invariance(P):
    """The same loss for any worker-group size (a 3-layer GCN), as one
    block's."""
    g = sbm_graph(num_nodes=500, num_classes=4, feature_dim=16, p_in=0.05,
                  p_out=0.01, seed=2).add_self_loops()
    cfg = GNNConfig(model="gcn", num_layers=3, hidden_dim=16, num_classes=4,
                    feature_dim=16)
    view = global_batch_view(g, 3)
    with torch.no_grad():
        want = float(loss_block(make_gnn(cfg, seed=0),
                                view.as_block(csc_plan=True)))
    eng = HybridParallelEngine(make_gnn(cfg, seed=0), build_partitions(g, P),
                               device="cpu")
    loss, _ = eng.make_loss_and_grad()(
        eng.stage_view(shard_view(eng.plan, view)))
    assert abs(float(loss) - want) < TOL, (P, float(loss), want)


# -- ProcessGroupComm over gloo -----------------------------------------------

GLOO_STEPS = 10


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Four processes, one partition each, over gloo: every rank's
    results (the worker is :func:`torch_engine_workers.gloo_worker`)."""
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("gloo")
    mp.spawn(workers.gloo_worker,
             args=(4, str(d / "init"), str(d), GLOO_STEPS), nprocs=4,
             join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def local_run():
    model, sg, views = workers.engine_case(4)
    eng = HybridParallelEngine(model, sg, comm=LocalComm(4), device="cpu")
    out = workers.run_case(eng, views, GLOO_STEPS)
    out["logits"] = eng.make_infer()(shard_view(sg.plan, views[0])).numpy()
    return out


def test_gloo_engine_matches_local_comm(gloo_run, local_run):
    """Loss, gradients and logits of ``ProcessGroupComm`` at P=4 against
    ``LocalComm``'s, within 1e-6, on every rank."""
    for rank, got in enumerate(gloo_run):
        for i in (0, 1):
            assert abs(float(got[f"{i}/loss"])
                       - float(local_run[f"{i}/loss"])) < GLOO_TOL, rank
            for k in local_run:
                if k.startswith(f"{i}/grad/"):
                    np.testing.assert_allclose(got[k], local_run[k],
                                               rtol=0, atol=GLOO_TOL,
                                               err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["logits"], local_run["logits"],
                                   rtol=0, atol=GLOO_TOL)


def test_gloo_train_steps(gloo_run, local_run):
    """Ten Adam steps over gloo: every rank holds the same trajectory,
    the local one's within ``TRAIN_TOL``, and the loss falls."""
    first = gloo_run[0]["losses"]
    assert len(first) == GLOO_STEPS and np.isfinite(first).all()
    for got in gloo_run[1:]:
        np.testing.assert_array_equal(got["losses"], first)
    np.testing.assert_allclose(first, local_run["losses"], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    assert first[-1] < first[0]


# -- the engine Trainer -------------------------------------------------------


def _chaos_graph():
    return sbm_graph(num_nodes=160, num_classes=4, feature_dim=8, p_in=0.05,
                     p_out=0.005, seed=0).add_self_loops()


def _trainer(g, P=2, **kw):
    net = make_gnn(GNNConfig(model="gcn", num_layers=2, hidden_dim=16,
                             num_classes=4, feature_dim=8), seed=0)
    eng = HybridParallelEngine(net, build_partitions(g, P), device="cpu")
    return Trainer(eng, adam(1e-2), **kw)


def _mini(g, compact=True):
    return strategy_views(g, "mini", 2, seed=0, batch_nodes=24,
                          compact=compact)


def _state(tr):
    return {k: p.detach().clone() for k, p in tr.params.items()}


@pytest.mark.parametrize("mode,workers_", [("thread", 1), ("thread", 3),
                                           ("process", 2)])
def test_engine_trainer_bitwise_across_staging(mode, workers_):
    g = _chaos_graph()
    base = _trainer(g)
    want = base.fit(_mini(g), steps=6, prefetch=False)["losses"]
    tr = _trainer(g)
    got = tr.fit(_mini(g), steps=6, prefetch_workers=workers_,
                 prefetch_mode=mode)["losses"]
    assert got == want
    assert all(torch.equal(a, b) for a, b in
               zip(_state(tr).values(), _state(base).values()))
    tr.assert_compiled_once()


def test_engine_trainer_checkpoint_restores_into_compact_trainer(tmp_path):
    g = _chaos_graph()
    tr = _trainer(g)
    tr.fit(_mini(g), steps=4, checkpoint_dir=str(tmp_path),
           checkpoint_every=4)
    net = make_gnn(GNNConfig(model="gcn", num_layers=2, hidden_dim=16,
                             num_classes=4, feature_dim=8), seed=5)
    ct = CompactTrainer(net, g, adam(1e-2), device="cpu")
    assert ct.restore(str(tmp_path)) == 4
    assert all(torch.equal(ct.params[k], p) for k, p in _state(tr).items())
    assert ct.opt_state["step"] == tr.opt_state["step"] == 4
    assert all(torch.equal(ct.opt_state["m"][k], tr.opt_state["m"][k])
               for k in tr.params)


def test_engine_trainer_evaluate_matches_infer():
    g = _chaos_graph()
    tr = _trainer(g, P=3)
    tr.fit(_mini(g), steps=5)
    view = global_batch_view(g, 2)
    acc = tr.evaluate(view)
    logits = tr._infer(shard_view(tr.plan, view))
    assert tuple(logits.shape) == (3, tr.plan.n_m_pad, 4)
    preds = tr.engine.gather_predictions(logits).argmax(-1)
    m = g.test_mask
    assert acc == float((preds[m] == g.labels[m]).mean())
    assert tr.evaluate(view) == acc and tr._eval_cache[0] is view
    with torch.no_grad():
        want = CompactTrainer(tr.model, g, adam(), device="cpu").evaluate(
            view)
    assert acc == want


def test_engine_trainer_strategy_switch_and_contract():
    g = _chaos_graph()
    tr = _trainer(g)
    with pytest.raises(RetraceError, match="never ran"):
        tr.assert_compiled_once()
    clusters = label_propagation_clusters(g, max_cluster_size=40, seed=0)
    for strategy, kw in (("global", {}), ("mini", {"batch_nodes": 24}),
                         ("cluster", {"clusters": clusters,
                                      "clusters_per_batch": 2})):
        for compact in (False, True):
            out = tr.fit(strategy_views(g, strategy, 2, seed=1,
                                        compact=compact, **kw), steps=3)
            assert np.isfinite(out["losses"]).all()
    tr.assert_compiled_once()
    assert tr.steps_run == 18 and tr.trace_counts["train_step"] == 0


def test_engine_trainer_matches_compact_trainer():
    """The engine at P=4 and one block train the same model on the same
    dense views, within ``TRAIN_TOL`` over 10 steps."""
    g = _chaos_graph()
    want = CompactTrainer(
        make_gnn(GNNConfig(model="gcn", num_layers=2, hidden_dim=16,
                           num_classes=4, feature_dim=8), seed=0),
        g, adam(1e-2), device="cpu").fit(_mini(g, compact=False),
                                         steps=10)["losses"]
    got = _trainer(g, P=4).fit(_mini(g, compact=False), steps=10)["losses"]
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)


@pytest.mark.parametrize("scenario", ["combined", "rollback", "skip_view"])
def test_engine_chaos_scenarios(scenario):
    quiet = lambda *_: None                                   # noqa: E731
    if scenario == "combined":
        ok = chaos.run_scenario("combined/engine", chaos.SMOKE_PLAN,
                                "engine", device="cpu", verbose=quiet)
    else:
        ok = chaos.run_divergence(f"diverge/{scenario}/engine", scenario,
                                  "engine", device="cpu", verbose=quiet)
    assert ok


def test_engine_needs_a_group_of_the_plans_size():
    g = _chaos_graph()
    with pytest.raises(ValueError, match="partitions"):
        HybridParallelEngine(make_gnn(GNNConfig(feature_dim=8)),
                             build_partitions(g, 2), comm=LocalComm(3),
                             device="cpu")



def test_default_view_arrays_are_the_whole_graph():
    """Every valid master and edge active in every layer, the loss on
    every master: the global view's masks with every node labeled."""
    g = _chaos_graph()
    eng = _trainer(g, P=3).engine
    got = eng.default_view_arrays()
    want = shard_view(eng.plan, global_batch_view(g, 2))
    for k in ("node_active", "edge_active"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["loss_mask"], eng.plan.master_mask)
    loss, _ = eng.make_loss_and_grad()(eng.stage_view(got))
    assert np.isfinite(float(loss))
