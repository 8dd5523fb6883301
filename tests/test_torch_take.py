"""NN-G's gather of node rows onto the edges, ``take(v, idx, plan)``.

With the plan over ``idx`` and ``v`` on the card, ``take`` runs the
plan-driven gather kernel (``ops.take_op``, the ``segment_sum_bwd``
kernel counted as ``"take"``); on the CPU, or without a plan, it is
``index_select``. Real edges get their rows bit for bit either way; a
plan's pad edges (a bucket's, or the masked edges of a shard's plan) read
the last row, as the TPU kernel clips, and every consumer masks them.

On the CPU: ``take_op``'s plain route at widths 1 to 128, a 3-D tree leaf,
a power-law plan with hub rows, a padded bucket and a shard's masked
plan; ``take`` and ``tree_take`` as ``index_select``, the backward the
planned segment sum. The tests marked ``cuda`` hold the kernel route to
``index_select`` on the card, a captured ``take`` to its eager bits on
another view of the bucket, the launch counts, and three GAT-E and GCN
steps to the ``index_select`` route bit for bit::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_take.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import GNNConfig
from repro_torch.core import aggregate as agg
from repro_torch.core.strategies import strategy_views
from repro_torch.core.tgar import tree_take
from repro_torch.core.trainer import CompactTrainer, capture, warm_up
from repro_torch.graph.csr import build_block
from repro_torch.graph.datasets import powerlaw_graph, sbm_graph
from repro_torch.kernels import ops
from repro_torch.kernels.plan import (build_bucket_csc_plan, build_csc_plan,
                                      build_csc_plans_stacked)
from repro_torch.models import make_gnn
from repro_torch.optim import adam

# name -> (rows, edges, trailing shape, kind): "uniform" ids; "hubs" adds
# rows of 65 to 2,000 edges (pieces in the plan); "bucket" pads to
# (128, 512) with the block's pad id 0; "masked" is a shard's plan, whose
# masked edges hold valid ids but join no row
CASES = {
    "width_1": (300, 1500, (1,), "uniform"),
    "width_4": (300, 1500, (4,), "uniform"),
    "width_32": (300, 1500, (32,), "uniform"),
    "width_128": (200, 900, (128,), "uniform"),
    "leaf_4x8": (300, 1500, (4, 8), "uniform"),
    "hubs_width_4": (2000, 8000, (4,), "hubs"),
    "hubs_width_32": (2000, 8000, (32,), "hubs"),
    "bucket": (100, 300, (4,), "bucket"),
    "masked": (300, 1500, (32,), "masked"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(name: str, seed: int = 0):
    """``(v, idx, plan, real)``: the rows, the gather's ids (E,), the
    plan over them and which edges are real in it."""
    n, e, trailing, kind = CASES[name]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, e).astype(np.int32)
    real = np.ones(e, bool)
    if kind == "hubs":
        hubs = rng.choice(n, 5, replace=False)
        idx = rng.permutation(np.concatenate(
            [idx, np.repeat(hubs, [65, 130, 412, 1000, 2000])])
        ).astype(np.int32)
        real = np.ones(len(idx), bool)
    if kind == "bucket":
        n, e_pad = 128, 512
        plan = build_bucket_csc_plan(idx, n, e_pad)
        idx = np.concatenate([idx, np.zeros(e_pad - e, np.int32)])
        real = np.arange(e_pad) < e
    elif kind == "masked":
        real = rng.random(e) > 0.3
        plan = build_csc_plans_stacked(idx[None], real[None], n)[0]
    else:
        plan = build_csc_plan(idx, n)
    v = rng.normal(size=(n,) + trailing).astype(np.float32)
    return (torch.from_numpy(v), torch.from_numpy(idx), plan,
            torch.from_numpy(real))


def _want(v, idx, real):
    """``v[idx]`` on real edges, the last row on the plan's pad edges."""
    want = v.index_select(0, idx)
    want[~real] = v[-1]
    return want


# -- the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_take_op_plain_route_is_the_clipped_gather(name):
    v, idx, plan, real = _case(name)
    before = dict(ops.launches)
    got = ops.take_op(v, plan)
    assert got.shape == (len(idx),) + tuple(v.shape[1:])
    assert torch.equal(got, _want(v, idx, real))
    assert ops.launches == before           # the CPU launches nothing


def test_take_op_checks_its_segment_axis():
    v, _, plan, _ = _case("width_4")
    with pytest.raises(ValueError, match="take: segment axis"):
        ops.take_op(v[1:], plan)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("planned", [False, True])
def test_cpu_take_is_index_select(planned, grad):
    """On the CPU ``take`` gives ``index_select``'s bits with or without a
    plan; its backward is the planned segment sum with one, torch's
    ``index_select`` backward without."""
    v, idx, plan, _ = _case("hubs_width_32")
    plan = plan if planned else None
    v = v.clone().requires_grad_(grad)
    got = agg.take(v, idx, plan)
    assert torch.equal(got, v.detach().index_select(0, idx))
    if not grad:
        return
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(got.shape)).astype(np.float32))
    (d_v,) = torch.autograd.grad(got, v, g)
    if planned:
        want = ops.segment_sum_op(g, plan)
    else:
        (want,) = torch.autograd.grad(v.index_select(0, idx), v, g)
    assert torch.equal(d_v, want)


def _gat_e_block(seed: int = 0):
    g = powerlaw_graph(num_nodes=300, feature_dim=16, edge_feature_dim=8,
                       seed=seed)
    cfg = GNNConfig(model="gat_e", hidden_dim=32, num_heads=4,
                    num_classes=2, feature_dim=16, edge_feature_dim=8)
    return g, cfg, build_block(g, csc_plan=True)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_tree_take_of_gat_e_keys_is_index_select(grad):
    """A GAT-E transform's keys (``n`` (N, 4, 8), ``as`` and ``ad`` (N,
    4)) at both edge ends: the same dict as ``index_select`` gives."""
    _, cfg, block = _gat_e_block()
    layer = make_gnn(cfg).layers[0]
    with torch.set_grad_enabled(grad):
        n = layer.transform(block.x)
        for idx, plan in ((block.src, block.src_plan),
                          (block.dst, block.csc_plan)):
            got = tree_take(n, idx, plan)
            assert sorted(got) == ["ad", "as", "n"]
            for k, v in n.items():
                assert torch.equal(got[k], v.index_select(0, idx)), k
                assert got[k].requires_grad == grad


# -- the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_take_is_index_select_on_real_edges(name, cuda):
    """The kernel route: ``index_select``'s bits on every real edge, the
    last row on pad edges, one ``"take"`` launch a call and none counted
    as ``"segment_sum_bwd"``."""
    v, idx, plan, real = _case(name)
    v, idx, plan, real = v.to(cuda), idx.to(cuda), plan.to(cuda), \
        real.to(cuda)
    before = dict(ops.launches)
    got = agg.take(v, idx, plan)
    vg = v.clone().requires_grad_()
    planned = agg.take(vg, idx, plan)
    torch.cuda.synchronize()
    want = v.index_select(0, idx)
    assert torch.equal(got[real], want[real])
    assert torch.equal(got, _want(v, idx, real))
    assert torch.equal(planned.detach(), got)
    assert ops.launches == {**before, "take": before["take"] + 2}


@pytest.mark.cuda
def test_cuda_captured_take_replays_another_view(cuda):
    """A CUDA graph captured over two ``take``s (widths 32 and 4, the
    rows and edges schedules) on one view of a (128, 512) bucket replays
    to the eager bits for another view loaded into its inputs, and each
    replay adds the capture's tally, two ``"take"`` launches."""
    rng = np.random.default_rng(3)
    n_pad, e_pad = 128, 512

    def view(e: int, seed: int):
        r = np.random.default_rng(seed)
        ids = r.integers(0, 100, e).astype(np.int32)
        plan = build_bucket_csc_plan(ids, n_pad, e_pad).to(cuda)
        idx = torch.zeros(e_pad, dtype=torch.int32)
        idx[:e] = torch.from_numpy(ids)
        return {"v32": torch.from_numpy(r.normal(size=(n_pad, 32)).astype(
                    np.float32)).to(cuda),
                "v4": torch.from_numpy(r.normal(size=(n_pad, 4)).astype(
                    np.float32)).to(cuda),
                "idx": idx.to(cuda), "plan": plan}

    def step(s):
        return (agg.take(s["v32"], s["idx"], s["plan"]),
                agg.take(s["v4"], s["idx"], s["plan"]))

    def load(static, staged):
        for k in ("v32", "v4", "idx"):
            static[k].copy_(staged[k])
        for f in ("perm", "indptr", "edge_dst", "piece_ptr"):
            getattr(static["plan"], f).copy_(getattr(staged["plan"], f))

    a, b = view(int(rng.integers(200, 500)), 1), view(300, 2)
    static = {k: (v.to(cuda, copy=True) if k == "plan" else v.clone())
              for k, v in a.items()}
    side = torch.cuda.Stream(cuda)
    warm_up(step, static, side)
    torch.cuda.synchronize()
    captured = capture(step, static, side, load=load)
    assert captured.counts == {"take": 2}
    for staged in (b, a, b):
        want = step(staged)
        before = ops.launches["take"]
        got = captured.replay(staged)
        torch.cuda.synchronize()
        assert ops.launches["take"] == before + 2
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def _gcn_graph():
    return sbm_graph(num_nodes=400, num_classes=4, feature_dim=16,
                     p_in=0.05, p_out=0.005, seed=0).add_self_loops()


@pytest.mark.cuda
@pytest.mark.parametrize("model,per_step", [("gat_e", 12), ("gcn", 4)])
def test_cuda_steps_are_the_index_select_routes_bits(model, per_step, cuda,
                                                     monkeypatch):
    """Three captured global steps of GAT-E and GCN: the losses and every
    parameter after them equal the ``index_select`` route's (the
    parent's, forced here) bit for bit; the kernel route launches
    ``"take"`` 6 times a GAT-E layer (``n``, ``as``, ``ad`` at both
    ends) and twice a GCN layer, 12 and 4 a step."""
    if model == "gat_e":
        g, cfg, _ = _gat_e_block()
    else:
        g = _gcn_graph()
        cfg = GNNConfig(model="gcn", hidden_dim=128, num_classes=4,
                        feature_dim=16)

    def fit():
        tr = CompactTrainer(make_gnn(cfg), g, adam(1e-2, weight_decay=5e-4),
                            gcn_norm=model == "gcn", device=cuda)
        before = ops.launches["take"]
        losses = tr.fit(strategy_views(g, "global", 2), steps=3)["losses"]
        torch.cuda.synchronize()
        state = {k: p.detach().cpu().clone() for k, p in tr.params.items()}
        return losses, state, ops.launches["take"] - before

    losses, state, takes = fit()
    with monkeypatch.context() as m:
        m.setattr(agg, "_gather", lambda v, idx, plan: v.index_select(0, idx))
        want_losses, want_state, parent_takes = fit()
    assert takes == 3 * per_step and parent_takes == 0
    assert losses == want_losses
    for k in want_state:
        assert torch.equal(state[k], want_state[k]), k
