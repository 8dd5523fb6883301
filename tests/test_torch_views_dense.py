"""The port's dense mask views against the JAX package's, on the CPU.

Every view here is numpy on both sides, built from the same graph and
the same seeds, and must match bit for bit: the K-hop sets and masks
(with and without a neighbour cap), the cluster views at halo 0, 1 and 2
and without a train mask, the per-step recompute they are held against,
``CompactView.to_dense``, the legacy generators, the views' counts and
bytes, and dense ``strategy_views`` streams at any index.
"""
import copy

import numpy as np
import pytest
import torch

from repro.core import subgraph as jsub
from repro.core.strategies import cluster_batch_views as jax_cluster_batches
from repro.core.strategies import mini_batch_views as jax_mini_batches
from repro.core.strategies import strategy_views as jax_strategy_views
from repro.core.views import ClusterViewCache as JaxClusterCache
from repro.core.views import ViewBuilder as JaxViewBuilder
from repro.core.views import cluster_view_recompute as jax_recompute
from repro.graph.datasets import make_dataset as jax_dataset
from repro_torch.core import subgraph as sub
from repro_torch.core.clustering import label_propagation_clusters
from repro_torch.core.strategies import (cluster_batch_views,
                                         mini_batch_views, strategy_views)
from repro_torch.core.views import (ClusterViewCache, CompactBlockBuilder,
                                    ViewBuilder, cluster_view_recompute)
from repro_torch.graph import make_dataset

K = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph, clusters) of one seeded alipay_like graph."""
    jg = jax_dataset("alipay_like", seed=0, num_nodes=500)
    pg = make_dataset("alipay_like", seed=0, num_nodes=500)
    clusters = label_propagation_clusters(pg, max_cluster_size=40, seed=0)
    return jg, pg, clusters


def _same_dense(pv, jv):
    """Two dense views (port, reference) bit for bit."""
    assert (pv.K, pv.strategy, pv.meta) == (jv.K, jv.strategy, jv.meta)
    for f in ("node_active", "edge_active", "loss_mask"):
        a, b = getattr(pv, f), getattr(jv, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _without_train(g):
    """A shallow copy of ``g`` with no train mask."""
    g = copy.copy(g)
    g.train_mask = None
    return g


# -- K-hop sets and masks --------------------------------------------------


@pytest.mark.parametrize("cap", [0, 3])
def test_bfs_layers_and_masks_match_jax(graphs, cap):
    jg, pg, _ = graphs
    targets = np.random.default_rng(4).choice(pg.num_nodes, 12,
                                              replace=False)
    got = sub.bfs_layers(pg, targets, K, cap, np.random.default_rng(9))
    want = jsub.bfs_layers(jg, targets, K, cap, np.random.default_rng(9))
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(a, b)
    if cap == 0:    # the per-node loop is the vectorized BFS's oracle
        loop, _ = sub.bfs_layers_loop(pg, targets, K)
        for a, b in zip(got[0], loop):
            np.testing.assert_array_equal(a, b)
    masks = sub.khop_subgraph_view(pg, targets, K, cap,
                                   np.random.default_rng(9))
    jmasks = jsub.khop_subgraph_view(jg, targets, K, cap,
                                     np.random.default_rng(9))
    for a, b in zip(masks, jmasks):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [0, 3])
def test_khop_view_matches_jax(graphs, cap):
    jg, pg, _ = graphs
    vb, jvb = ViewBuilder(pg, K), JaxViewBuilder(jg, K)
    rng = np.random.default_rng(2)
    for i in range(4):     # more builds than slots: the ring turns over
        targets = rng.choice(pg.num_nodes, 10, replace=False)
        pv = vb.khop_view(targets, cap, np.random.default_rng(i))
        jv = jvb.khop_view(targets, cap, np.random.default_rng(i))
        _same_dense(pv, jv)
        # the builder's masks are the allocating function's
        na, ea, loss, _ = sub.khop_subgraph_view(
            pg, targets, K, cap, np.random.default_rng(i))
        np.testing.assert_array_equal(pv.node_active, na)
        np.testing.assert_array_equal(pv.edge_active, ea)
        np.testing.assert_array_equal(pv.loss_mask, loss)
    assert vb.builds == 4


# -- cluster views ---------------------------------------------------------


@pytest.mark.parametrize("halo,train", [(0, True), (1, True), (2, True),
                                        (1, False)],
                         ids=["halo0", "halo1", "halo2", "no_train_mask"])
def test_cluster_view_matches_jax_and_the_recompute(graphs, halo, train):
    jg, pg, clusters = graphs
    if not train:
        jg, pg = _without_train(jg), _without_train(pg)
    cache = ClusterViewCache(pg, clusters, halo)
    jcache = JaxClusterCache(jg, clusters, halo)
    vb, jvb = ViewBuilder(pg, K), JaxViewBuilder(jg, K)
    tmask = (pg.train_mask if pg.train_mask is not None
             else np.ones(pg.num_nodes, bool))
    rng = np.random.default_rng(7)
    for _ in range(3):
        chosen = rng.choice(cache.num_clusters, 3, replace=False)
        pv = vb.cluster_view(chosen, cache)
        _same_dense(pv, jvb.cluster_view(chosen, jcache))
        member, active, loss = cluster_view_recompute(
            pg, clusters, chosen, halo, tmask)
        jmember, jactive, jloss = jax_recompute(jg, clusters, chosen, halo,
                                                tmask)
        np.testing.assert_array_equal(member, jmember)
        np.testing.assert_array_equal(active, jactive)
        np.testing.assert_array_equal(loss, jloss)
        # the cached composition is the recompute, bit for bit
        for k in range(K):
            np.testing.assert_array_equal(pv.node_active[k], active)
            np.testing.assert_array_equal(
                pv.edge_active[k], active[pg.src] & active[pg.dst])
        np.testing.assert_array_equal(pv.loss_mask, loss)
        m, a = np.empty(pg.num_nodes, bool), np.empty(pg.num_nodes, bool)
        cache.compose(chosen, m, a)
        np.testing.assert_array_equal(m, member)
        np.testing.assert_array_equal(a, active)


def test_compact_builder_refuses_dense_builds(graphs):
    _, pg, clusters = graphs
    vb = ViewBuilder(pg, K, compact=True)
    with pytest.raises(RuntimeError, match="compact=True"):
        vb.khop_view(np.arange(4))
    with pytest.raises(RuntimeError, match="compact=True"):
        vb.cluster_view([0], ClusterViewCache(pg, clusters))


# -- compact against dense ---------------------------------------------------


@pytest.mark.parametrize("strategy,kw", [
    ("mini", dict(batch_nodes=15)),
    ("mini", dict(batch_nodes=15, neighbor_cap=2)),
    ("cluster", dict(clusters_per_batch=3, halo_hops=0)),
    ("cluster", dict(clusters_per_batch=3, halo_hops=2)),
], ids=["mini", "mini_cap", "cluster_halo0", "cluster_halo2"])
def test_to_dense_is_the_dense_builder(graphs, strategy, kw):
    jg, pg, clusters = graphs
    kw = dict(kw, seed=3, clusters=clusters)
    dense = strategy_views(pg, strategy, K, **kw)
    compact = strategy_views(pg, strategy, K, compact=True, **kw)
    jcompact = jax_strategy_views(jg, strategy, K, compact=True, **kw)
    for i in (0, 4, 1):
        want = dense.build(i)
        cv = compact.build(i)
        got = cv.to_dense()
        _same_dense(got, jcompact.build(i).to_dense())
        for f in ("node_active", "edge_active", "loss_mask"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)
        assert cv.active_counts() == want.active_counts()


def test_bucket_for_gives_a_dense_view_the_graphs_shape(graphs):
    _, pg, _ = graphs
    stager = CompactBlockBuilder(pg, K)
    view = strategy_views(pg, "mini", K, batch_nodes=8).build(0)
    assert stager.bucket_for(view) == (pg.num_nodes, pg.num_edges)
    cv = strategy_views(pg, "mini", K, batch_nodes=8, compact=True).build(0)
    assert stager.bucket_for(cv) == stager._pick(cv)
    block = stager.stage(view)
    assert (block.num_nodes_padded, block.num_edges_padded) == \
        stager.bucket_for(view)
    np.testing.assert_array_equal(block.node_active.numpy(),
                                  view.node_active)


# -- the legacy generators ---------------------------------------------------


@pytest.mark.parametrize("kind", ["mini", "mini_cap", "cluster",
                                  "cluster_halo1"])
def test_legacy_generators_match_jax(graphs, kind):
    jg, pg, clusters = graphs
    if kind.startswith("mini"):
        cap = 2 if kind == "mini_cap" else 0
        got = mini_batch_views(pg, K, batch_nodes=12, neighbor_cap=cap,
                               seed=5, steps=4)
        want = jax_mini_batches(jg, K, batch_nodes=12, neighbor_cap=cap,
                                seed=5, steps=4)
    else:
        halo = 1 if kind == "cluster_halo1" else 0
        got = cluster_batch_views(pg, K, clusters, clusters_per_batch=2,
                                  halo_hops=halo, seed=5, steps=4)
        want = jax_cluster_batches(jg, K, clusters, clusters_per_batch=2,
                                   halo_hops=halo, seed=5, steps=4)
    got, want = list(got), list(want)
    assert len(got) == len(want) == 4
    for pv, jv in zip(got, want):
        _same_dense(pv, jv)
    # detached: each view owns its masks
    assert got[0].node_active is not got[1].node_active


def test_mini_batch_views_refuse_a_graph_without_labels(graphs):
    _, pg, _ = graphs
    g = copy.copy(pg)
    g.train_mask = np.zeros(g.num_nodes, bool)
    with pytest.raises(ValueError, match="no labeled nodes"):
        next(mini_batch_views(g, K))


# -- counts and bytes ----------------------------------------------------------


@pytest.mark.parametrize("strategy", ["global", "mini", "cluster"])
def test_active_counts_and_nbytes_match_jax(graphs, strategy):
    jg, pg, clusters = graphs
    kw = dict(seed=1, batch_nodes=10, clusters=clusters,
              clusters_per_batch=3, halo_hops=1)
    for compact in (False, True):
        pv = strategy_views(pg, strategy, K, compact=compact, **kw).build(2)
        jv = jax_strategy_views(jg, strategy, K, compact=compact,
                                **kw).build(2)
        assert pv.active_counts() == jv.active_counts()
        if hasattr(jv, "nbytes"):
            assert pv.nbytes() == jv.nbytes()
        # without the builder's meta, the counts come from the masks
        if not compact:
            bare = pv.copy_masks()
            bare.meta = {}
            jbare = jv.copy_masks()
            jbare.meta = {}
            assert bare.active_counts() == jbare.active_counts()


# -- dense streams -------------------------------------------------------------


@pytest.mark.parametrize("strategy,halo", [("mini", 0), ("cluster", 0),
                                           ("cluster", 1)])
def test_dense_streams_match_jax_at_any_index(graphs, strategy, halo):
    jg, pg, clusters = graphs
    kw = dict(seed=5, batch_nodes=20, clusters=clusters,
              clusters_per_batch=3, halo_hops=halo)
    stream = strategy_views(pg, strategy, K, **kw)
    jstream = jax_strategy_views(jg, strategy, K, **kw)
    assert not stream.compact
    for i in (0, 1, 7, 3):
        _same_dense(stream.build(i), jstream.build(i))
    # the iterator hands out detached copies, in index order
    first, second = next(stream), next(stream)
    _same_dense(first, jstream.build(0))
    _same_dense(second, jstream.build(1))
    assert stream.cursor == 2
    assert first.node_active is not second.node_active
