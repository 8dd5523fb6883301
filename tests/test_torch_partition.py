"""The port's partitioning against the JAX package's, bit for bit: the
partition plan and sharded data of every method, the partition
statistics, and views sharded onto a plan (dense and compact); and the
shards' plans the engine's kernels read."""
import jax  # noqa: F401 — imported first so JAX stays on the CPU
import numpy as np
import pytest
import torch

from repro.core.partition import build_partitions as jax_partitions
from repro.core.partition import partition_stats as jax_stats
from repro.core.strategies import shard_view as jax_shard_view
from repro.core.strategies import shard_view_loop as jax_shard_view_loop
from repro.core.strategies import strategy_views as jax_strategy_views
from repro.graph.datasets import make_dataset as jax_dataset
from repro.graph.datasets import sbm_graph as jax_sbm
from repro_torch.core.clustering import label_propagation_clusters
from repro_torch.core.partition import build_partitions, partition_stats
from repro_torch.core.strategies import (_shard_compact, shard_view,
                                         shard_view_loop, strategy_views)
from repro_torch.graph.datasets import make_dataset, sbm_graph

METHODS = ("1d_src", "1d_dst", "vertex_cut")
PLAN_FIELDS = ("owner", "masters", "master_mask", "mirrors", "mirror_mask",
               "src_local", "dst_local", "edge_mask", "edge_orig",
               "send_idx", "send_mask", "recv_slot", "recv_mask")
SHARD_FIELDS = ("x", "y", "edge_weight", "edge_attr")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sbm(n=300):
    kw = dict(num_nodes=n, num_classes=4, feature_dim=8, p_in=0.05,
              p_out=0.01, seed=2)
    return jax_sbm(**kw).add_self_loops(), sbm_graph(**kw).add_self_loops()


def _alipay(n=400):
    return (jax_dataset("alipay_like", seed=0, num_nodes=n),
            make_dataset("alipay_like", seed=0, num_nodes=n))


def _same(want, got, what):
    if want is None or got is None:
        assert want is None and got is None, what
        return
    assert want.dtype == got.dtype and want.shape == got.shape, what
    np.testing.assert_array_equal(want, got, err_msg=what)


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("method", METHODS)
def test_partitions_bit_identical(method, P):
    jg, pg = _sbm()
    want = jax_partitions(jg, P, method=method)
    got = build_partitions(pg, P, method=method)
    for f in PLAN_FIELDS:
        _same(getattr(want.plan, f), getattr(got.plan, f), f)
    for f in SHARD_FIELDS:
        _same(getattr(want, f), getattr(got, f), f)
    assert (got.plan.P, got.plan.method, got.feature_dim) == \
        (want.plan.P, want.plan.method, want.feature_dim)
    assert jax_stats(want) == partition_stats(got)


@pytest.mark.parametrize("method", METHODS)
def test_edge_attributed_partitions_bit_identical(method):
    """GAT-E's graph: edge attributes and no GCN norm (the raw weights)."""
    jg, pg = _alipay()
    want = jax_partitions(jg, 4, method=method, gcn_norm=False)
    got = build_partitions(pg, 4, method=method, gcn_norm=False)
    for f in PLAN_FIELDS:
        _same(getattr(want.plan, f), getattr(got.plan, f), f)
    for f in SHARD_FIELDS:
        _same(getattr(want, f), getattr(got, f), f)
    assert jax_stats(want) == partition_stats(got)
    np.testing.assert_array_equal(want.plan.node_locator(),
                                  got.plan.node_locator())
    for a, b in zip(want.plan.edge_locator(), got.plan.edge_locator()):
        np.testing.assert_array_equal(a, b)


def _view_pairs(jg, pg, compact: bool):
    """(JAX view, port view) for the global, mini and cluster streams."""
    clusters = label_propagation_clusters(pg, max_cluster_size=60, seed=0)
    kw = dict(compact=compact, batch_nodes=20, clusters_per_batch=3,
              halo_hops=1)
    out = []
    for strategy in ("global", "mini", "cluster"):
        extra = {"clusters": clusters} if strategy == "cluster" else {}
        js = jax_strategy_views(jg, strategy, 2, seed=3, **kw, **extra)
        ps = strategy_views(pg, strategy, 2, seed=3, **kw, **extra)
        for i in (0, 5):
            out.append((strategy, js.build(i), ps.build(i)))
    return out


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_shard_view_bit_identical(compact):
    jg, pg = _sbm()
    want_plan = jax_partitions(jg, 4).plan
    plan = build_partitions(pg, 4).plan
    for strategy, jv, pv in _view_pairs(jg, pg, compact):
        want = jax_shard_view(want_plan, jv)
        got = shard_view(plan, pv)
        for k in ("node_active", "edge_active", "loss_mask"):
            _same(want[k], got[k], f"{strategy} {k}")
        if compact and strategy != "global":
            dense = shard_view(plan, pv.to_dense())
            for k, v in _shard_compact(plan, pv).items():
                _same(dense[k], v, f"{strategy} compact {k}")
        if not compact:
            loop = shard_view_loop(plan, pv)
            want_loop = jax_shard_view_loop(want_plan, jv)
            for k in ("node_active", "edge_active", "loss_mask"):
                _same(want_loop[k], loop[k], f"{strategy} loop {k}")
                _same(got[k], loop[k], f"{strategy} loop vs take {k}")


@pytest.mark.parametrize("method", METHODS)
def test_shard_plans(method):
    """Each shard's destination, source and send plans: every valid entry
    in its row once, in entry order within a row; pad entries join no
    row. The plan of a run of shards side by side holds each shard's
    rows, in the same order; the plans are built once."""
    _, pg = _sbm()
    plan = build_partitions(pg, 4, method=method).plan
    n_tot = plan.n_m_pad + plan.n_mir_pad
    cases = (("dst", plan.csc_plans(), plan.dst_local, plan.edge_mask,
              n_tot),
             ("src", plan.src_plans(), plan.src_local, plan.edge_mask,
              n_tot),
             ("send", plan.send_plans(), plan.send_idx.reshape(4, -1),
              plan.send_mask.reshape(4, -1), plan.n_m_pad))
    for kind, plans, ids, mask, n in cases:
        assert len(plans) == plan.P
        flat = []
        for p, cp in enumerate(plans):
            valid = mask[p] > 0
            perm, indptr = cp.perm.numpy(), cp.indptr.numpy()
            e = int(valid.sum())
            assert (cp.num_segments, cp.num_edges, cp.num_real_edges) == \
                (n, ids.shape[1], e), kind
            rows = np.repeat(np.arange(n), np.diff(indptr))
            np.testing.assert_array_equal(ids[p][perm[:e]], rows)
            np.testing.assert_array_equal(np.sort(perm[:e]),
                                          np.flatnonzero(valid))
            np.testing.assert_array_equal(
                cp.edge_dst.numpy(), np.where(valid, ids[p], n))
            flat.append(np.where(valid, ids[p] + p * n, plan.P * n))
        stacked = plan.local_plans(1, 3)[kind]
        indptr = stacked.indptr.numpy()
        perm = stacked.perm.numpy()
        np.testing.assert_array_equal(stacked.edge_dst.numpy(),
                                      np.concatenate(flat[1:]) - n)
        for l, cp in enumerate(plans[1:]):
            rows = slice(l * n, (l + 1) * n + 1)
            np.testing.assert_array_equal(
                indptr[rows] - indptr[l * n], cp.indptr.numpy())
            lo, hi = indptr[l * n], indptr[(l + 1) * n]
            np.testing.assert_array_equal(
                perm[lo:hi] - l * ids.shape[1],
                cp.perm.numpy()[:cp.num_real_edges])
            np.testing.assert_array_equal(
                stacked.piece_ptr.numpy()[rows] - stacked.piece_ptr.numpy()[
                    l * n], cp.piece_ptr.numpy())
        assert stacked.num_pieces == sum(p.num_pieces for p in plans[1:])
        assert plan.local_plans(1, 1)[kind] is plans[1]
    assert plan.csc_plans() is plan.csc_plans()
    assert plan.local_plans(0, 4)["dst"] is plan.local_plans(0, 4)["dst"]


def test_unknown_method_raises():
    _, pg = _sbm(60)
    with pytest.raises(ValueError, match="unknown partition method"):
        build_partitions(pg, 2, method="2d")
