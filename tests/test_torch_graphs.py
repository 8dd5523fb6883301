"""The capture contract: what lets one CUDA graph per bucket replay every
view of that bucket, and the reference's once-per-bucket certificate.

On the CPU:

- every plan's piece count fits ``max_pieces`` (``E // PIECE``) and its
  pad edges' runs fit ``ceil(E / PIECE)``, the bounds the kernels' grids
  are sized by, on random plans with hub rows, bucketed as a trainer
  stages them;
- ``_assert_once_per_bucket`` takes the reference's decision on each of
  its three outcomes;
- the optimizers fed their per-step scalars as a tensor are bitwise the
  update with Python floats, over 30 steps;
- eager trainers and servers certify that they ran, and report their
  captures (none).

The ``cuda`` twins check on the card that replay is bitwise equal to eager
and that each bucket is captured once, for the GNN steps and the LM
decode round, and hold the reduced Jamba's and MiniCPM3's served logits
to the CPU's::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_graphs.py

The JAX package is imported inside the one test that uses it, so that the
twins run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import GNNConfig
from repro_torch.core.strategies import strategy_views
from repro_torch.core.trainer import (CompactTrainer, RetraceError,
                                      _assert_once_per_bucket)
from repro_torch.core.views import BucketSpec, CompactBlockBuilder
from repro_torch.graph.csr import Graph
from repro_torch.graph.datasets import sbm_graph
from repro_torch.kernels.plan import PIECE, build_bucket_csc_plan
from repro_torch.models import make_gnn
from repro_torch.optim import adam, adamw, sgd, warmup_cosine_schedule
from repro_torch.serving.server import GNNServer

STEPS = 30


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def g():
    return sbm_graph(num_nodes=160, num_classes=4, feature_dim=8,
                     p_in=0.05, p_out=0.005, seed=0).add_self_loops()


CFG = dict(num_layers=2, hidden_dim=16, num_classes=4, feature_dim=8)


def _model(name="gcn", seed=0):
    return make_gnn(GNNConfig(model=name, **CFG), seed=seed)


# -- the bounds the kernels' grids are sized by -------------------------------


def _hub_graph(seed: int, n: int = 600) -> Graph:
    """A graph whose in-degrees mix short rows with hubs of 65 to 700
    in-edges, so plans have pieces in several buckets."""
    rng = np.random.default_rng(seed)
    hubs = rng.choice(n, 6, replace=False)
    dst = np.concatenate([rng.integers(0, n, 3 * n),
                          np.repeat(hubs, rng.integers(65, 700, 6))])
    src = rng.integers(0, n, len(dst))
    return Graph(src.astype(np.int32), dst.astype(np.int32), n,
                 rng.normal(size=(n, 4)).astype(np.float32),
                 rng.integers(0, 3, n).astype(np.int32))


def _pad_runs(plan) -> int:
    return -(-(plan.num_edges - plan.num_real_edges) // PIECE)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_piece_and_pad_run_counts_fit_the_bucket_bounds(seed):
    g = _hub_graph(seed)
    stager = CompactBlockBuilder(g, 2, csc_plan=True, src_plan=True)
    seen = set()
    for strategy, kw in (("mini", dict(batch_nodes=40)),
                         ("mini", dict(batch_nodes=4)),
                         ("cluster", dict(clusters_per_batch=2))):
        stream = strategy_views(g, strategy, 2, seed=seed, compact=True,
                                **kw)
        for i in range(6):
            block = stager.stage(stream.build(i))
            for plan in (block.csc_plan, block.src_plan):
                assert plan.num_pieces <= plan.max_pieces
                assert _pad_runs(plan) <= -(-plan.num_edges // PIECE)
                assert plan.max_pieces == block.num_edges_padded // PIECE
                seen.add((block.num_edges_padded, plan.num_pieces > 0))
    assert any(cut for _, cut in seen), "no plan was cut into pieces"
    # the bound is reached: one row holding all 64q + r edges (r > 0)
    for e_pad in (65, 200, 4097):
        plan = build_bucket_csc_plan(np.zeros(e_pad, np.int32), 8, e_pad)
        assert plan.num_pieces == plan.max_pieces == e_pad // PIECE


def test_whole_graph_plans_fit_their_bound():
    g = _hub_graph(3)
    dst, src = (g.csc_plan(g.num_nodes, g.num_edges),
                g.src_plan(g.num_nodes, g.num_edges))
    assert 0 < dst.num_pieces <= dst.max_pieces     # the hubs are cut
    assert src.num_pieces <= src.max_pieces


# -- the certificate ----------------------------------------------------------


@pytest.mark.parametrize("traces,touched", [(0, 0), (3, 0), (2, 1), (0, 2),
                                            (1, 1), (3, 3)])
def test_once_per_bucket_takes_the_references_decision(traces, touched):
    from repro.core.trainer import RetraceError as JaxRetraceError
    from repro.core.trainer import _assert_once_per_bucket as jax_assert

    def outcome(fn, err):
        try:
            fn(traces, touched, "train step")
        except err as e:
            return "never ran" if "never ran" in str(e) else "retraced"
        return "certified"

    want = outcome(jax_assert, JaxRetraceError)
    assert outcome(_assert_once_per_bucket, RetraceError) == want


def test_eager_trainer_certifies_that_it_ran(g):
    tr = CompactTrainer(_model(), g, adam(1e-2), device="cpu")
    assert not tr.graphs_on
    with pytest.raises(RetraceError, match="never ran"):
        tr.assert_compiled_per_bucket()
    tr.fit(strategy_views(g, "mini", 2, batch_nodes=24, compact=True),
           steps=4)
    tr.assert_compiled_per_bucket()
    tr.assert_trace_contract()
    assert tr.captures == {} and sum(tr.step_calls.values()) == 4


def test_eager_server_certifies_and_reports_its_trace(g):
    srv = GNNServer(_model(), None, g, max_batch=8, device="cpu",
                    cuda_graphs=True)     # ignored on the CPU
    with pytest.raises(RetraceError, match="never ran"):
        srv.assert_compiled_per_bucket()
    srv.submit([0, 5, 9])
    srv.submit([0, 5, 9])      # hits
    srv.assert_compiled_per_bucket()
    trace = srv.server_stats()["trace"]
    assert trace["full"]["buckets"] and trace["hit"]["buckets"]
    for path in ("full", "hit"):
        assert set(trace[path]["captures"].values()) == {0}
        assert sum(trace[path]["calls"].values()) == 1


# -- the optimizers' scalars --------------------------------------------------


def _python_float_update(kind, lr, state, params, grads, b1=0.9, b2=0.999,
                         eps=1e-8, wd=0.0):
    """The update with its scalars as Python floats (the form a tensor of
    scalars replaces), for ``adam`` / ``adamw`` / ``sgd``."""
    f32 = np.float32
    with torch.no_grad():
        lr_t = lr(state["step"])
        if kind == "sgd":
            for k, p in params.items():
                p.sub_(lr_t * grads[k])
            state["step"] += 1
            return
        step = state["step"] + 1
        if wd and kind == "adam":
            grads = {k: gr + wd * params[k] for k, gr in grads.items()}
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        for k, p in params.items():
            gr = grads[k]
            m = state["m"][k].mul_(b1).add_((1 - b1) * gr)
            v = state["v"][k].mul_(b2).add_((1 - b2) * torch.square(gr))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd and kind == "adamw":
                u = u + wd * p
            p.sub_(lr_t * u)
        state["step"] = step


@pytest.mark.parametrize("kind,sched", [
    ("adam", "constant"), ("adam", "warmup_cosine"),
    ("adamw", "warmup_cosine"), ("sgd", "constant")])
def test_scalars_as_a_tensor_are_bitwise_the_python_floats(kind, sched):
    lr = (warmup_cosine_schedule(1e-2, 5, STEPS) if sched != "constant"
          else (lambda step: float(np.float32(1e-2))))
    wd = 5e-4 if kind != "sgd" else 0.0
    opt = {"adam": lambda: adam(lr, weight_decay=wd),
           "adamw": lambda: adamw(lr, weight_decay=wd),
           "sgd": lambda: sgd(lr)}[kind]()
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 4), "b": (4,)}
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()}
    want = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    want_state = opt.init(want)
    for _ in range(STEPS):
        grads = {k: torch.from_numpy(rng.normal(size=s).astype(
            np.float32) * 3) for k, s in shapes.items()}
        opt.update(grads, state, params)
        _python_float_update(kind, lr, want_state, want, grads, wd=wd)
    assert state["step"] == want_state["step"] == STEPS
    for k in params:
        assert torch.equal(params[k], want[k]), k
    for moment in ("m", "v"):
        for k in state.get(moment, {}):
            assert torch.equal(state[moment][k], want_state[moment][k])


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fit(g, views, cuda, graphs: bool, steps: int = 10, model="gcn"):
    tr = CompactTrainer(_model(model), g, adam(1e-2, weight_decay=5e-4),
                        gcn_norm=model == "gcn", device=cuda,
                        cuda_graphs=graphs,
                        buckets=BucketSpec.for_graph(g, levels=4))
    losses = tr.fit(views, steps=steps)["losses"]
    state = {k: p.detach().cpu().clone() for k, p in tr.params.items()}
    grads = {k: p.grad.detach().cpu().clone() for k, p in tr.params.items()}
    return tr, losses, state, grads


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,compact,model", [
    ("global", True, "gcn"), ("mini", True, "gcn"), ("cluster", True, "gcn"),
    ("mini", False, "gcn"), ("cluster", False, "gat"),
    ("mini", True, "sage_max")])
def test_cuda_replay_is_bitwise_eager(g, cuda, strategy, compact, model):
    def views():
        return strategy_views(g, strategy, 2, seed=1, batch_nodes=12,
                              clusters_per_batch=3, halo_hops=1,
                              compact=compact)
    eager, l_e, s_e, g_e = _fit(g, views(), cuda, False, model=model)
    tr, l_g, s_g, g_g = _fit(g, views(), cuda, True, model=model)
    assert l_g == l_e
    for k in s_e:
        assert torch.equal(s_g[k], s_e[k]), k
        assert torch.equal(g_g[k], g_e[k]), k
    assert tr.graphs_on and not eager.graphs_on
    tr.assert_compiled_per_bucket()
    assert tr.captures == {k: 1 for k in tr.buckets_touched}
    # another fit over the same buckets captures nothing new
    tr.fit(views(), steps=4)
    tr.assert_compiled_per_bucket()


@pytest.mark.cuda
def test_cuda_restore_and_reset_keep_the_captured_step_live(g, cuda,
                                                           tmp_path):
    """save/restore/reset write into the tensors a graph reads, so a
    replayed step after them is the eager one."""
    def views():
        return strategy_views(g, "mini", 2, seed=2, batch_nodes=12,
                              compact=True)
    runs = []
    for graphs in (False, True):
        tr = CompactTrainer(_model(), g, adam(1e-2), device=cuda,
                            cuda_graphs=graphs)
        first = tr.fit(views(), steps=6, checkpoint_dir=str(
            tmp_path / str(graphs)), checkpoint_every=3)["losses"]
        tr.restore(str(tmp_path / str(graphs)), step=3)
        again = tr.fit(views(), steps=3)["losses"]
        tr.reset()
        fresh = tr.fit(views(), steps=4)["losses"]
        runs.append((first, again, fresh))
    assert runs[0] == runs[1]
    first, again, fresh = runs[1]
    assert again == first[3:] and fresh == first[:4]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "gat", "sage_max"])
def test_cuda_served_replay_is_bitwise_eager(g, cuda, model):
    rng = np.random.default_rng(0)
    batches = [rng.choice(g.num_nodes, int(n), replace=False)
               for n in rng.integers(1, 24, 12)]
    out = {}
    for graphs in (False, True):
        srv = GNNServer(_model(model), None, g, max_batch=24, device=cuda,
                        gcn_norm=model == "gcn", cuda_graphs=graphs)
        out[graphs] = [srv.submit(b) for b in batches]
        srv.assert_compiled_per_bucket()
    for a, b in zip(out[False], out[True]):
        assert np.array_equal(a, b)
    trace = srv.server_stats()["trace"]
    assert trace["full"]["captures"] == {k: 1 for k in
                                         trace["full"]["buckets"]}


# -- the engine Trainer: one capture for every strategy -----------------------


def _engine_trainer(g, device, graphs: bool, P: int = 3, model="gcn"):
    from repro_torch.core.engine import HybridParallelEngine
    from repro_torch.core.partition import build_partitions
    from repro_torch.core.trainer import Trainer
    eng = HybridParallelEngine(_model(model), build_partitions(
        g, P, gcn_norm=model == "gcn"), device=device)
    return Trainer(eng, adam(1e-2, weight_decay=5e-4), cuda_graphs=graphs)


def _switch(tr, g, steps: int = 6):
    """Global, then mini and cluster (dense and compact) through one
    trainer; returns every loss."""
    losses = []
    for strategy in ("global", "mini", "cluster"):
        for compact in (False, True):
            losses += tr.fit(strategy_views(
                g, strategy, 2, seed=1, batch_nodes=12,
                clusters_per_batch=3, halo_hops=1, compact=compact),
                steps=steps)["losses"]
    return losses


def test_engine_trainer_eager_certifies_that_it_ran(g):
    tr = _engine_trainer(g, "cpu", graphs=True)
    assert not tr.graphs_on
    with pytest.raises(RetraceError, match="never ran"):
        tr.assert_compiled_once()
    _switch(tr, g, steps=2)
    tr.assert_compiled_once()
    assert tr.trace_counts == {"train_step": 0, "infer": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "gat", "sage_max"])
def test_cuda_engine_replay_is_bitwise_eager(g, cuda, model):
    """Across a global -> mini -> cluster switch the step is captured
    exactly once, and every replay is its eager twin bit for bit."""
    runs = {}
    for graphs in (False, True):
        tr = _engine_trainer(g, cuda, graphs, model=model)
        losses = _switch(tr, g)
        runs[graphs] = (losses, {k: p.detach().cpu().clone()
                                 for k, p in tr.params.items()})
        tr.assert_compiled_once()
    assert tr.graphs_on and tr.trace_counts["train_step"] == 1
    assert runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k


@pytest.mark.cuda
def test_cuda_engine_restore_and_reset_keep_the_captured_step_live(
        g, cuda, tmp_path):
    def views():
        return strategy_views(g, "mini", 2, seed=2, batch_nodes=12,
                              compact=True)
    runs = []
    for graphs in (False, True):
        tr = _engine_trainer(g, cuda, graphs)
        first = tr.fit(views(), steps=6, checkpoint_dir=str(
            tmp_path / str(graphs)), checkpoint_every=3)["losses"]
        tr.restore(str(tmp_path / str(graphs)), step=3)
        again = tr.fit(views(), steps=3)["losses"]
        tr.reset()
        fresh = tr.fit(views(), steps=4)["losses"]
        runs.append((first, again, fresh))
    assert runs[0] == runs[1]
    first, again, fresh = runs[1]
    assert again == first[3:] and fresh == first[:4]
    tr.assert_compiled_once()


# -- LM decode: one CUDA graph per bucket ---------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b", "minicpm3-4b"])
def test_cuda_lm_decode_captured_once_replays_eager(arch, cuda):
    """The reduced model served on the card, two batches of mixed-length
    prompts: the captured decode round gives eager decode's tokens and
    every round's logits bit for bit, and is captured once for the
    bucket (batch 2, cache 40) across both batches."""
    from repro_torch.launch.serve import BatchServer, Request
    lengths = ((9, 4), (3, 12))
    runs = {}
    for graphs in (False, True):
        srv = BatchServer(arch, batch_size=2, cache_len=40, seed=0,
                          device=cuda, cuda_graphs=graphs)
        srv.round_logits = []
        vocab = srv.cfg.vocab_size
        prompts = [np.random.default_rng(n).integers(0, vocab, n)
                   .astype(np.int32) for pair in lengths for n in pair]
        reqs = [Request(i, p, 6) for i, p in enumerate(prompts)]
        srv.run(reqs[:2])
        srv.run(reqs[2:])
        srv.assert_compiled_per_bucket()
        runs[graphs] = ([r.out for r in reqs], srv.round_logits, srv)
    assert runs[True][2].captures == {(2, 40): 1}
    assert runs[False][2].captures == {}
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][1]) == len(runs[False][1]) == 10
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)


def _served_logits(model, lengths, new, cache_len, seed=3):
    """A left-padded prefill of seeded prompts of ``lengths``, then
    ``new`` greedy decode steps at a device index: every step's logits,
    float32 on the CPU."""
    P = max(lengths)
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), P), np.int64)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(0, model.cfg.vocab_size, n)
    dev = model.device
    pads = torch.tensor([P - n for n in lengths], device=dev)
    ar = torch.arange(P, device=dev)[None]
    valid = ar >= pads[:, None]
    logits, caches, idx = model.prefill(
        {"tokens": torch.from_numpy(toks).to(dev), "valid": valid,
         "positions": (ar - pads[:, None]).clamp_min(0).int()},
        cache_len=cache_len)
    out = [logits.float().cpu()]
    idx = torch.tensor(idx, device=dev)
    for _ in range(new):
        logits, caches, idx = model.decode_step(
            {"tokens": logits[:, -1].argmax(-1)[:, None], "valid": valid,
             "positions": (idx - pads)[:, None].int()}, caches, idx)
        out.append(logits.float().cpu())
    return torch.cat(out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, launches", [("jamba-1.5-large-398b", 1),
                                            ("minicpm3-4b", 0)])
def test_cuda_hybrid_lm_matches_the_cpu(arch, launches, cuda):
    """Reduced Jamba (attention then Mamba, MoE on the Mamba slot) and
    MiniCPM3 (MLA), float32, on the card against the CPU on the same
    weights: a left-padded prefill two chunks long (Jamba's attention
    layer through the ``flash_attention`` kernel, one launch; MLA's
    absorbed path over all cache slots, no kernel) and 6 greedy decode
    steps at a device index, within 1e-4 of max|logit|."""
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    cpu = build_model(cfg, torch.Generator().manual_seed(2)
                      ).requires_grad_(False)
    lengths = (32, 19, 5)
    want = _served_logits(cpu, lengths, 6, 40)
    before = ops.launches["flash_attention"]
    got = _served_logits(cpu.to(cuda), lengths, 6, 40)
    assert ops.launches["flash_attention"] == before + launches
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_capture_holds_the_collector_off():
    """A collection inside a capture could free an unreachable captured
    graph, whose destruction invalidates the capture (ROADMAP C.22): the
    collector runs once before and not during it, and is restored."""
    import gc
    from repro_torch.core.trainer import _no_collection
    assert gc.isenabled()
    with _no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with _no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.cuda
def test_cuda_capture_survives_garbage_holding_a_graph(cuda):
    """An unreachable cycle that holds a captured graph, made after the
    warm-up and just before a capture whose step allocates enough Python
    objects to set off the collector: the capture succeeds and
    replays."""
    from repro_torch.core.trainer import capture, warm_up
    side = torch.cuda.Stream(cuda)
    x = torch.ones(64, device=cuda)

    def load(static, new):
        static.copy_(new)

    def garbage():
        warm_up(lambda s: s * 2, x, side)
        cycle = {"step": capture(lambda s: s * 2, x, side, load=load)}
        cycle["self"] = cycle

    def fn(s):
        junk = [[i] for i in range(20_000)]   # past gen-0's threshold
        del junk
        return s + 1

    warm_up(fn, x, side)
    garbage()
    step = capture(fn, x, side, load=load)
    out = step.replay(torch.full((64,), 2.0, device=cuda))
    assert torch.equal(out, torch.full((64,), 3.0, device=cuda))
