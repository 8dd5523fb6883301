"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs and the JAX-initialised parameters (carried over by
``params_from_jax``) go through both packages:

- the loss and the ``loss_block`` gradients of every model, rel 1e-5;
- each optimizer and schedule, with and without clipping and decay, over
  5 steps, 1e-6;
- the strategy streams' views and the label-propagation clusters, bit
  for bit;
- ``CompactTrainer`` under each strategy for 10 steps: per-step losses
  and final parameters within 1e-4 (float32 sums in another order, grown
  over the steps);
- the quickstart loop (GCN on cora, global batch, 100 steps) and its
  test accuracy;
- the training entry point, its runtime flags (prefetch pools, sampler
  processes, checkpoints, divergence policy, resume), the distributed
  engine through the facade and the entry point, and the refusal of
  what is not ported.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.config import GNNConfig as JaxConfig
from repro.core.clustering import label_propagation_clusters as jax_lp
from repro.core.mpgnn import loss_block as jax_loss_block
from repro.core.strategies import global_batch_view as jax_global_view
from repro.core.strategies import strategy_views as jax_strategy_views
from repro.core.trainer import CompactTrainer as JaxTrainer
from repro.core.views import CompactBlockBuilder as JaxStager
from repro.core.views import ViewBuilder as JaxViewBuilder
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
from repro.nn.layers import softmax_cross_entropy as jax_xent
import repro_torch.api as api
import repro_torch.optim as topt
from repro_torch.checkpoint import checkpoint_steps
from repro_torch.config import GNNConfig
from repro_torch.core.clustering import label_propagation_clusters
from repro_torch.core.mpgnn import loss_block
from repro_torch.core.strategies import global_batch_view, strategy_views
from repro_torch.core.trainer import CompactTrainer, RetraceError, Trainer
from repro_torch.core.views import CompactBlockBuilder, ViewBuilder
from repro_torch.graph import make_dataset
from repro_torch.launch.train import main as train_main
from repro_torch.models import make_gnn
from repro_torch.nn.layers import softmax_cross_entropy
from repro_torch.weights import (load_jax_params, opt_state_from_jax,
                                 params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
GRAD_REL = 1e-5
OPT_TOL = 1e-6
TRAIN_TOL = 1e-4

# model -> (dataset, config kwargs), small widths; gat_e at its own
MODELS = {
    "gcn": ("reddit_like", dict(model="gcn", hidden_dim=16)),
    "sage": ("reddit_like", dict(model="sage", hidden_dim=16)),
    "gat": ("reddit_like", dict(model="gat", hidden_dim=16, num_heads=4)),
    "gat_e": ("alipay_like", dict(model="gat_e", hidden_dim=32,
                                  num_heads=4, edge_feature_dim=8)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(dataset: str, model: str, n: int = 300):
    jg = jax_dataset(dataset, seed=0, num_nodes=n)
    pg = make_dataset(dataset, seed=0, num_nodes=n)
    if model == "gcn":
        jg, pg = jg.add_self_loops(), pg.add_self_loops()
    return jg, pg


def _models(key: str, pg, jax_backend="reference", backend="csc"):
    _, kw = MODELS[key]
    common = dict(num_layers=2, num_classes=int(pg.labels.max()) + 1,
                  feature_dim=pg.node_features.shape[1], **kw)
    jmodel = jax_make_gnn(JaxConfig(aggregate_backend=jax_backend, **common))
    params = jmodel.init(jax.random.PRNGKey(3), common["feature_dim"])
    model = load_jax_params(
        make_gnn(GNNConfig(aggregate_backend=backend, **common)),
        _np(params))
    return jmodel, params, model


def _assert_rel(got: torch.Tensor, want: np.ndarray, rel: float, what=""):
    """max |got - want| within ``rel`` of the tensor's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


# -- the loss and its gradients ----------------------------------------------


@pytest.mark.parametrize("masked", ["mask", "none", "empty_mask"])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, 7)).astype(np.float32) * 4
    labels = rng.integers(0, 7, 50).astype(np.int32)
    mask = {"mask": (rng.random(50) < 0.4).astype(np.float32),
            "none": None, "empty_mask": np.zeros(50, np.float32)}[masked]
    want = float(jax_xent(logits, labels, mask))
    got = float(softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("backend", ["csc", "reference"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_loss_block_gradients_match_jax(key, backend):
    dataset, kw = MODELS[key]
    jg, pg = _graphs(dataset, kw["model"])
    jmodel, params, model = _models(key, pg, backend=backend)
    gcn = kw["model"] == "gcn"
    targets = np.random.default_rng(4).choice(300, 12, replace=False)
    jb = JaxStager(jg, 2, gcn_norm=gcn, csc_plan=True).stage(
        JaxViewBuilder(jg, 2, compact=True).khop_compact(targets))
    pb = CompactBlockBuilder(pg, 2, gcn_norm=gcn, csc_plan=True).stage(
        ViewBuilder(pg, 2).khop_compact(targets))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_loss_block(jmodel, p, jb))(params)
    loss = loss_block(model, pb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_REL)
    want = params_from_jax(_np(jgrads))
    assert set(want) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        _assert_rel(p.grad, want[k].numpy(), GRAD_REL, k)


def test_gat_e_gradients_match_jax_pallas_backward():
    """The JAX side on its ``csc`` backend (the Pallas forward and
    backward kernels in interpret mode) on a tiny view; the port through
    its autograd Functions over the kernels' plain versions."""
    jg, pg = _graphs("alipay_like", "gat_e")
    jmodel, params, model = _models("gat_e", pg, jax_backend="csc")
    targets = np.array([5, 17])
    jb = JaxStager(jg, 2, gcn_norm=False, csc_plan=True).stage(
        JaxViewBuilder(jg, 2, compact=True).khop_compact(targets))
    pb = CompactBlockBuilder(pg, 2, gcn_norm=False, csc_plan=True).stage(
        ViewBuilder(pg, 2).khop_compact(targets))
    jgrads = jax.grad(lambda p: jax_loss_block(jmodel, p, jb))(params)
    loss_block(model, pb).backward()
    want = params_from_jax(_np(jgrads))
    for k, p in model.named_parameters():
        _assert_rel(p.grad, want[k].numpy(), GRAD_REL, k)


def test_sage_max_on_csc_trains():
    """The csc max combine trains through its kernel pair's Function:
    the same forward as the reference backend, bit for bit (a max is
    exact), and a finite gradient on every parameter. (The two backends'
    gradients differ where maxima tie, ROADMAP C.1; tests/
    test_torch_sage_max.py holds these against the JAX csc backend.)"""
    jg, pg = _graphs("reddit_like", "sage")
    cfg = dict(model="sage_max", hidden_dim=8,
               num_classes=int(pg.labels.max()) + 1,
               feature_dim=pg.node_features.shape[1])
    model = make_gnn(GNNConfig(**cfg))
    ref = make_gnn(GNNConfig(aggregate_backend="reference", **cfg))
    ref.load_state_dict(model.state_dict())
    pb = CompactBlockBuilder(pg, 2, gcn_norm=False, csc_plan=True,
                             src_plan=True).stage(
        ViewBuilder(pg, 2).khop_compact(np.arange(5)))
    loss = loss_block(model, pb)
    loss.backward()
    assert torch.equal(loss.detach(), loss_block(ref, pb).detach())
    for k, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), k
    assert model.layers[1].w_neigh.w.grad.abs().max() > 0


# -- optimizers and schedules ------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.1),
    "sgd_momentum_decay": lambda o: o.sgd(0.1, momentum=0.9,
                                          weight_decay=1e-2),
    "sgd_clip": lambda o: o.sgd(0.1, grad_clip=0.5),
    "adam": lambda o: o.adam(1e-2),
    "adam_decay_clip": lambda o: o.adam(1e-2, weight_decay=5e-4,
                                        grad_clip=1.0),
    "adamw": lambda o: o.adamw(1e-2),
    "adamw_clip": lambda o: o.adamw(1e-2, weight_decay=0.1, grad_clip=0.3),
    "adam_cosine": lambda o: o.adam(o.cosine_schedule(1e-2, 4)),
    "adamw_warmup_cosine": lambda o: o.adamw(
        o.warmup_cosine_schedule(1e-2, 2, 6)),
    "make_sgd": lambda o: o.make_optimizer("sgd", 0.05, 1e-3, 2.0),
    "make_adam": lambda o: o.make_optimizer("adam", 1e-2, 5e-4),
    "make_adamw": lambda o: o.make_optimizer("adamw", 1e-2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_five_steps(name):
    rng = np.random.default_rng(1)
    shapes = {"layers": [{"w": (6, 4), "b": (4,)}], "decoder": {"w": (4, 3)}}
    jparams = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.normal(size=s).astype(np.float32)),
        shapes, is_leaf=lambda s: isinstance(s, tuple))
    params = {k: v.clone() for k, v in params_from_jax(_np(jparams)).items()}
    jo, po = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jstate = jo.init(jparams)
    state = opt_state_from_jax(_np(jstate))
    for _ in range(5):
        jgrads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(
                np.float32) * 3), jparams)
        jparams, jstate = jo.update(jgrads, jstate, jparams)
        params, state = po.update(dict(params_from_jax(_np(jgrads))), state,
                                  params)
        for k, want in params_from_jax(_np(jparams)).items():
            np.testing.assert_allclose(params[k].numpy(), want.numpy(),
                                       rtol=OPT_TOL, atol=OPT_TOL, err_msg=k)
    want_state = opt_state_from_jax(_np(jstate))
    assert state["step"] == want_state["step"] == 5
    for moment in ("m", "v", "mu"):
        assert (moment in state) == (moment in want_state)
        for k, v in want_state.get(moment, {}).items():
            np.testing.assert_allclose(state[moment][k].numpy(), v.numpy(),
                                       rtol=OPT_TOL, atol=OPT_TOL)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_jax(name):
    make = {"constant": lambda o: o.constant_schedule(3e-3),
            "cosine": lambda o: o.cosine_schedule(1e-2, 7, 0.2),
            "warmup_cosine": lambda o: o.warmup_cosine_schedule(
                1e-2, 3, 10)}[name]
    js, ps = make(jopt), make(topt)
    for step in range(12):
        np.testing.assert_allclose(ps(step), float(js(jnp.int32(step))),
                                   rtol=OPT_TOL, atol=1e-9)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    jclipped, jnorm = jopt.clip_by_global_norm(tree, 0.7)
    clipped, norm = topt.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, 0.7)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(jclipped[k]), rtol=1e-6)


# -- views and clusters --------------------------------------------------------


def _same_view(pv, jv):
    for f in ("nodes", "hop_offsets", "src_local", "dst_local", "edge_ids",
              "loss_local"):
        a, b = getattr(pv, f), getattr(jv, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (pv.K, pv.strategy, pv.meta) == (jv.K, jv.strategy, jv.meta)


def test_label_propagation_clusters_bit_identical():
    jg, pg = _graphs("alipay_like", "gat_e", n=600)
    for size in (0, 40):
        want = jax_lp(jg, max_cluster_size=size, seed=3)
        got = label_propagation_clusters(pg, max_cluster_size=size, seed=3)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy,halo", [("mini", 0), ("cluster", 0),
                                           ("cluster", 1)])
def test_stream_views_bit_identical(strategy, halo):
    jg, pg = _graphs("alipay_like", "gat_e", n=500)
    clusters = label_propagation_clusters(pg, max_cluster_size=40, seed=0)
    kw = dict(seed=5, batch_nodes=20, clusters=clusters,
              clusters_per_batch=3, halo_hops=halo, compact=True)
    jstream = jax_strategy_views(jg, strategy, 2, **kw)
    stream = strategy_views(pg, strategy, 2, **kw)
    for i in (0, 1, 7, 3):
        _same_view(stream.build(i), jstream.build(i))
    # the iterator hands out detached copies, in index order
    _same_view(next(stream), jstream.build(0))
    assert stream.cursor == 1


def test_global_view_block_matches_jax():
    jg, pg = _graphs("reddit_like", "gcn")
    jb = jax_global_view(jg, 2).as_block(csc_plan=True)
    pb = global_batch_view(pg, 2).as_block(csc_plan=True)
    for f in ("src", "dst", "edge_mask", "node_mask", "x", "y", "loss_mask",
              "edge_weight"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert pb.node_active is None and pb.csc_plan is not None


# -- the trainer ---------------------------------------------------------------


@pytest.mark.parametrize("key,strategy,compact", [
    pytest.param(key, strategy, compact,
                 id=f"{key}-{strategy}" + ("" if compact else "-dense"))
    for key in ("gcn", "gat_e")
    for strategy, compact in (("global", True), ("mini", True),
                              ("cluster", True), ("mini", False),
                              ("cluster", False))])
def test_compact_trainer_matches_jax_trainer(key, strategy, compact):
    """Per-step losses and final parameters against the JAX
    ``CompactTrainer`` on the same stream: compact views, and the dense
    mask views (the whole graph, its one bucket)."""
    dataset, kw = MODELS[key]
    jg, pg = _graphs(dataset, kw["model"])
    jmodel, params, model = _models(key, pg)
    clusters = label_propagation_clusters(pg, max_cluster_size=30, seed=0)
    vkw = dict(seed=2, batch_nodes=16, clusters=clusters,
               clusters_per_batch=2, halo_hops=1, compact=compact)
    gcn = kw["model"] == "gcn"
    jo = jopt.adam(1e-2, weight_decay=5e-4)
    jtrainer = JaxTrainer(jmodel, jg, jo, params=params, gcn_norm=gcn)
    jstream = jax_strategy_views(jg, strategy, 2, **vkw)
    want = jtrainer.fit(jstream, steps=10)["losses"]
    trainer = CompactTrainer(model, pg, topt.adam(1e-2, weight_decay=5e-4),
                             gcn_norm=gcn, device="cpu")
    trainer.opt_state = opt_state_from_jax(_np(jo.init(params)))
    stream = strategy_views(pg, strategy, 2, **vkw)
    got = trainer.fit(stream, steps=10)["losses"]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for k, w in params_from_jax(_np(jtrainer.params)).items():
        _assert_rel(model.state_dict()[k], w.numpy(), TRAIN_TOL, k)
    trainer.assert_trace_contract()
    assert trainer.buckets_touched == jtrainer.buckets_touched
    assert trainer.opt_state["step"] == 10
    # accuracy over a view of the stream (a compact one-off block for
    # mini and cluster) on the graph's test mask
    assert trainer.evaluate(stream.build(11)) == pytest.approx(
        jtrainer.evaluate(jstream.build(11)), abs=1e-6)


def test_quickstart_loop_matches_jax():
    """ROADMAP A.5's gate: GCN on cora, global batch, the quickstart's 100
    Adam steps against its jitted JAX loop (every loss within
    ``TRAIN_TOL``, the last under 0.01), and the test accuracy against
    JAX ``accuracy_block`` on the test mask within 1e-6."""
    from repro.core.mpgnn import accuracy_block as jax_accuracy_block
    jg = jax_dataset("cora", seed=0).add_self_loops()
    pg = make_dataset("cora", seed=0).add_self_loops()
    common = dict(model="gcn", num_layers=2, hidden_dim=32, num_classes=7,
                  feature_dim=jg.node_features.shape[1])
    jmodel = jax_make_gnn(JaxConfig(**common))
    params = jmodel.init(jax.random.PRNGKey(0), common["feature_dim"])
    jo = jopt.adam(1e-2, weight_decay=5e-4)
    jblock = jax_global_view(jg, 2).as_block()

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: jax_loss_block(jmodel, p, jblock))(params)
        params, state = jo.update(grads, state, params)
        return params, state, loss

    model = load_jax_params(make_gnn(GNNConfig(**common)), _np(params))
    state, want = jo.init(params), []
    for _ in range(100):
        params, state, loss = step(params, state)
        want.append(float(loss))
    want_acc = float(jax_accuracy_block(
        jmodel, params, jblock, mask=jg.test_mask.astype("float32")))
    trainer = CompactTrainer(model, pg, topt.adam(1e-2, weight_decay=5e-4),
                             device="cpu")
    got = trainer.fit(strategy_views(pg, "global", 2), steps=100)["losses"]
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert got[-1] < 0.01
    acc = trainer.evaluate(global_batch_view(pg, 2))
    assert acc == pytest.approx(want_acc, abs=1e-6)
    assert acc > 0.85


def test_trainer_refuses_what_is_not_ported():
    _, pg = _graphs("reddit_like", "gcn")
    _, _, model = _models("gcn", pg)
    trainer = CompactTrainer(model, pg, topt.adam(), device="cpu")
    with pytest.raises(RetraceError):
        trainer.assert_trace_contract()


# -- the facade and the entry point -------------------------------------------


def test_api_train_infer_serve_on_cpu():
    result = api.train(api.TrainJob(dataset="alipay_like", model="gat_e",
                                    hidden=32, lr=5e-3, strategy="cluster",
                                    compact=True, halo_hops=1, steps=4,
                                    eval_every=2, device="cpu"),
                       log=lambda *_: None)
    assert [h["step"] for h in result.history] == [2, 4]
    assert result.trainer.device.type == "cpu"
    logits = api.infer(result, nodes=[0, 3, 9])
    assert logits.shape == (3, 2) and np.isfinite(logits).all()
    server = api.serve(result, api.ServeConfig(max_batch=4, cache=False))
    np.testing.assert_allclose(server.submit([0, 3, 9]), logits, rtol=1e-4,
                               atol=1e-5)
    # engine_partitions builds the engine Trainer, which fits
    trainer, views, *_ = api.make_trainer(
        api.TrainJob(device="cpu", engine_partitions=2, hidden=16))
    assert isinstance(trainer, Trainer) and trainer.plan.P == 2
    out = trainer.fit(views, steps=3)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    trainer.assert_trace_contract()


def test_train_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "gnn",
         "--dataset", "cora", "--steps", "5", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[cpu] final test acc:" in proc.stdout


@pytest.mark.parametrize("argv,item", [
    (["lm"], "A.12"),
])
def test_train_cli_refuses_unported_flags(argv, item, capsys):
    """The ``lm`` subcommand, refused until ROADMAP ``item`` was ported,
    now trains the reduced LM and prints the reference's ``final loss``
    line."""
    assert train_main(argv + ["--arch", "qwen3-4b", "--steps", "3",
                              "--batch", "2", "--seq", "32", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr()
    assert "[cpu] final loss: " in out.out
    assert f"ROADMAP {item}" not in out.err


def test_train_cli_runs_the_engine(capsys):
    """``--engine-partitions`` trains with the distributed engine."""
    assert train_main(["gnn", "--dataset", "cora", "--engine-partitions",
                       "2", "--steps", "5", "--device", "cpu"]) == 0
    assert "[cpu] final test acc: " in capsys.readouterr().out


CLI_JOB = ["gnn", "--dataset", "cora", "--strategy", "mini", "--compact",
           "--hidden", "16", "--device", "cpu"]


@pytest.mark.parametrize("flags,steps,seed_steps", [
    (["--prefetch-mode", "process", "--prefetch-workers", "2"], 4, 0),
    (["--prefetch-workers", "2"], 4, 0),
    (["--checkpoint-dir", "{ck}", "--checkpoint-every", "2",
      "--keep-checkpoints", "1"], 4, 0),
    (["--on-divergence", "rollback", "--checkpoint-dir", "{ck}",
      "--checkpoint-every", "2"], 4, 0),
    (["--resume", "--checkpoint-dir", "{ck}"], 2, 4),
    (["--fault-retries", "1", "--fault-backoff", "0", "--check-finite",
      "--step-timeout", "120"], 4, 0),
], ids=["process", "workers", "checkpoints", "rollback", "resume",
        "policy"])
def test_train_cli_runtime_flags_run_on_cpu(flags, steps, seed_steps,
                                            tmp_path, capsys):
    """The runtime's flags train to the end; ``--resume`` continues a
    directory another run checkpointed (4 + 2 steps)."""
    ck = str(tmp_path / "ck")
    if seed_steps:
        assert train_main(CLI_JOB + ["--steps", str(seed_steps),
                                     "--checkpoint-dir", ck,
                                     "--checkpoint-every", "2"]) == 0
    argv = CLI_JOB + ["--steps", str(steps)] + [f.format(ck=ck)
                                                for f in flags]
    assert train_main(argv) == 0
    out = capsys.readouterr().out
    assert f"final test acc: " in out
    assert f"at step {seed_steps + steps} " in out
    if "--checkpoint-every" in flags:
        keep = 1 if "--keep-checkpoints" in flags else 2
        assert checkpoint_steps(ck) == [2, 4][-keep:]
