"""The port's examples and host modules against the JAX package's, on
the CPU at small sizes.

- ``examples/quickstart_torch.py`` from the JAX quickstart's initial
  weights: every loss within ``TRAIN_TOL`` of the quickstart's jitted JAX
  loop, the test accuracy within 1e-6 of JAX ``accuracy_block``; the
  facade's server certified.
- ``examples/strategy_comparison_torch.py`` and
  ``examples/distributed_training_torch.py`` run through the engine
  ``Trainer`` (the reference's engine ``Trainer`` is no oracle, ROADMAP
  C.2): a row run again, or the whole run again with another prefetch
  pool, is bitwise the first.
- ``examples/serve_lm_torch.py`` on the JAX serving example's weights
  (``examples/serve_lm.py``: reduced Mixtral, window 16, rolling):
  the same greedy continuation and the same printed sample.
- ``graph_feature_batch``, ``Timer``/``timed`` and ``get_logger`` against
  the reference's on the same inputs; the citation config field by field.
"""
import dataclasses
import importlib
import importlib.util
import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.config import GNNConfig as JaxConfig
from repro.core.mpgnn import accuracy_block as jax_accuracy_block
from repro.core.mpgnn import loss_block as jax_loss_block
from repro.core.strategies import global_batch_view as jax_global_view
from repro.graph.datasets import make_dataset as jax_dataset
from repro.models import make_gnn as jax_make_gnn
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TRAIN_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_ex_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the examples -------------------------------------------------------------


def _jax_quickstart(steps: int):
    """The JAX quickstart's loop: (initial params, losses, test acc)."""
    g = jax_dataset("cora", seed=0).add_self_loops()
    cfg = JaxConfig(model="gcn", num_layers=2, hidden_dim=32, num_classes=7,
                    feature_dim=g.node_features.shape[1])
    model = jax_make_gnn(cfg)
    params = model.init(jax.random.PRNGKey(0), cfg.feature_dim)
    init = jax.tree_util.tree_map(np.asarray, params)
    opt = jopt.adam(1e-2, weight_decay=5e-4)
    state = opt.init(params)
    block = jax_global_view(g, cfg.num_layers).as_block()

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: jax_loss_block(model, p, block))(params)
        params, state = opt.update(grads, state, params)
        return params, state, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    acc = float(jax_accuracy_block(model, params, block,
                                   mask=g.test_mask.astype("float32")))
    return init, losses, acc


@pytest.mark.parametrize("backend", ["csc", "reference"])
def test_quickstart_matches_the_jax_quickstart(backend, capsys):
    steps = 12
    init, want, want_acc = _jax_quickstart(steps)
    out = _example("quickstart_torch").main(
        backend, "cpu", steps, params=params_from_jax(init),
        facade=backend == "csc")
    np.testing.assert_allclose(out["losses"], want, rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    assert out["test_acc"] == pytest.approx(want_acc, abs=1e-6)
    printed = capsys.readouterr().out
    assert "step   0  loss" in printed and "test accuracy:" in printed
    if backend == "csc":
        assert "facade test accuracy:" in printed
        assert out["preds"].shape == (4,)
        out["server"].assert_compiled_per_bucket()


def test_strategy_comparison_rows_repeat_bitwise(capsys):
    ex = _example("strategy_comparison_torch")
    out = ex.main("cpu", steps=3, nodes=600)
    rows = out["rows"]
    assert [r["strategy"] for r in rows] == [
        "global", "mini", "cluster", "mini+compact", "cluster+compact"]
    for r in rows:
        assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
        assert 0.0 <= r["acc"] <= 1.0 and r["peak_active_nodes"] > 0
    printed = capsys.readouterr().out
    assert "cluster+compact" in printed and "P=4" in printed
    # a row run again on the same trainer is the first run, bit for bit
    again = ex.run(out["trainer"], out["graph"], out["clusters"], "global",
                   steps=3)
    assert again["losses"] == rows[0]["losses"]
    for k, v in rows[0]["params"].items():
        assert torch.equal(again["params"][k], v), k
    out["trainer"].assert_compiled_once()


def test_distributed_training_repeats_across_prefetch_pools(capsys):
    ex = _example("distributed_training_torch")
    argv = ["--device", "cpu", "--steps", "6", "--nodes", "600",
            "--workers", "4"]
    a = ex.main(argv)
    b = ex.main(argv + ["--prefetch-workers", "1"])
    assert set(a["losses"]) == {"global", "mini", "cluster"}
    assert a["losses"] == b["losses"]
    for k, v in a["params"].items():
        assert torch.equal(b["params"][k], v), k
    assert a["trainer"].step_num == 6
    printed = capsys.readouterr().out
    assert "[cluster ] 2 steps" in printed and "done: one engine" in printed


def _jax_serve_lm(batch=4, P=32, N=32):
    """The JAX serving example's model, params and loop
    (``examples/serve_lm.py``): (params, every sequence's N tokens)."""
    from repro.arch import build_model as jax_build_model
    from repro.config import get_arch_config as jax_arch_config
    cfg = jax_arch_config("mixtral-8x7b").reduced().replace(
        dtype="float32", sliding_window=16)
    model = jax_build_model(cfg, remat=False, rolling_window_decode=True)
    params = model.init(jax.random.PRNGKey(0))
    prompts = jax.numpy.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, P)), jax.numpy.int32)
    logits, caches, idx = jax.jit(lambda p, b: model.prefill(
        p, b, cache_len=P + N))(params, {"tokens": prompts})
    decode = jax.jit(model.decode_step)
    generated = [jax.numpy.argmax(logits[:, -1], -1)]
    for _ in range(N):
        logits, caches, idx = decode(
            params, {"tokens": generated[-1][:, None]}, caches, idx)
        generated.append(jax.numpy.argmax(logits[:, -1], -1))
    return params, np.stack([np.asarray(t) for t in generated[1:]], 1)


def test_serve_lm_matches_the_jax_serving_example(capsys, monkeypatch):
    """The port's serving example on the JAX example's weights (through
    ``lm_params_from_jax``): its 4 x 32 greedy tokens are the JAX loop's,
    and its printed sample continuation is the one the JAX example
    itself prints."""
    from repro_torch.config import get_arch_config
    from repro_torch.weights import lm_params_from_jax
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    _example("serve_lm").main()
    jax_out = capsys.readouterr().out
    params, want = _jax_serve_lm()
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(
        dtype="float32", sliding_window=16)
    got = _example("serve_lm_torch").main(
        device="cpu", params=lm_params_from_jax(
            cfg, jax.tree_util.tree_map(np.asarray, params)))
    out = capsys.readouterr().out
    assert got["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(got["tokens"], want)

    def sample(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("sample continuation")]
    assert sample(out) == sample(jax_out) and len(sample(out)) == 1
    assert "window=16 slots" in out and "16 held" in out


def test_distributed_training_takes_the_runtime_flags(tmp_path):
    ex = _example("distributed_training_torch")
    ck = tmp_path / "ck"
    out = ex.main(["--device", "cpu", "--steps", "3", "--nodes", "600",
                   "--workers", "2", "--checkpoint-dir", str(ck),
                   "--check-finite"])
    assert out["trainer"].runtime is not None
    assert sorted(p.name for p in ck.glob("step_*.npz")) == [
        "step_00000001.npz", "step_00000002.npz", "step_00000003.npz"]


# -- host modules -------------------------------------------------------------


@pytest.mark.parametrize("pad_to", [0, 3, 9])
def test_graph_feature_batch_matches_reference(pad_to):
    from repro.data import graph_feature_batch as want_fn
    from repro_torch.data import graph_feature_batch
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(20, 5)).astype(np.float64)
    labels = rng.integers(0, 4, 20)
    ids = rng.choice(20, 6, replace=False)
    got, want = graph_feature_batch(feats, labels, ids, pad_to), \
        want_fn(feats, labels, ids, pad_to)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_timer_and_timed_match_reference(monkeypatch):
    """The same readings of a fake clock give the same totals, counts and
    means."""
    import repro.utils.timing as ref
    import repro_torch.utils.timing as port
    results = []
    for mod in (ref, port):
        ticks = iter([1.0, 1.25, 2.0, 2.5, 3.0, 3.75, 4.0, 4.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.Timer("x")
        t.tic()
        dt = t.toc()
        with t:
            pass
        sink = {}
        with mod.timed(sink, "a"):
            pass
        with mod.timed(sink, "a"):
            pass
        results.append((dt, t.total_s, t.count, t.mean_us, sink))
        monkeypatch.undo()
    assert results[0] == results[1]
    assert results[1][:3] == (0.25, 0.75, 2)


def test_get_logger_matches_reference(capsys):
    from repro.utils import get_logger as ref_logger
    from repro_torch.utils import get_logger
    ref_logger()
    log = get_logger("examples_test")
    want_root, root = logging.getLogger("repro"), logging.getLogger(
        "repro_torch")
    assert log.name == "repro_torch.examples_test"
    assert get_logger("repro_torch.api").name == "repro_torch.api"
    assert get_logger() is root
    assert (root.level, root.propagate) == (want_root.level,
                                            want_root.propagate)
    assert len(root.handlers) == len(want_root.handlers) == 1
    got_fmt, want_fmt = root.handlers[0].formatter, \
        want_root.handlers[0].formatter
    assert (got_fmt._fmt, got_fmt.datefmt) == (want_fmt._fmt,
                                               want_fmt.datefmt)
    assert root.handlers[0].stream is sys.stdout
    log.info("hello %d", 7)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.endswith(" I repro_torch.examples_test: hello 7")


def test_api_train_logs_through_the_logger(capsys):
    import repro_torch.api as api
    api.train(api.TrainJob(dataset="cora", steps=2, hidden=8, eval_every=2,
                           device="cpu"))
    out = capsys.readouterr().out
    assert " I repro_torch.api: step     2  loss" in out


# -- the config ---------------------------------------------------------------


def test_citation_config_is_the_references():
    want = importlib.import_module("repro.configs.gnn_gcn_citation")
    got = importlib.import_module("repro_torch.configs.gnn_gcn_citation")
    # the Sum-stage backend is each package's default: the port's csc
    # runs on the card, the reference's ``reference`` backend does not
    skip = {"aggregate_backend"}
    assert ({f.name for f in dataclasses.fields(got.CONFIG)}
            == {f.name for f in dataclasses.fields(want.CONFIG)})
    for f in dataclasses.fields(want.CONFIG):
        if f.name not in skip:
            assert getattr(got.CONFIG, f.name) == getattr(want.CONFIG,
                                                          f.name), f.name
    assert set(got.TRAIN) == set(want.TRAIN)
    for k, cfg in want.TRAIN.items():
        assert dataclasses.asdict(got.TRAIN[k]) == dataclasses.asdict(cfg)
    assert got.DATASETS == want.DATASETS
    from repro_torch.config import get_gnn_config
    assert get_gnn_config("gnn_gcn_citation") == (got.CONFIG, "cora")
