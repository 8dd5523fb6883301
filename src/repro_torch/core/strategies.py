"""Training strategies over views (paper §4.2/4.3): the counterpart of
the reference's ``core/strategies.py``. Global-, mini- and cluster-batch
are all streams of views, so one trainer loop drives every strategy:

- :func:`strategy_views` — the indexable :class:`ViewStream` a trainer
  drives (view i a pure function of ``(seed, i)``), dense or compact;
- :func:`mini_batch_views` / :func:`cluster_batch_views` — the
  reference's generators: one sequential RNG and detached dense views.

Sharding a view onto a partition plan (``shard_view``) waits for the
engine (ROADMAP A.9)."""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.core.views import (ClusterViewCache, ClusterViewStream,
                                    GlobalViewStream, GraphView,
                                    MiniBatchViewStream, ViewBuilder,
                                    ViewStream)
from repro_torch.graph.csr import Graph

__all__ = ["GraphView", "ViewStream", "global_batch_view",
           "mini_batch_views", "cluster_batch_views", "strategy_views"]


def global_batch_view(g: Graph, K: int) -> GraphView:
    """Full graph convolution each step (paper: stable, costliest step)."""
    loss = (g.train_mask if g.train_mask is not None
            else np.ones(g.num_nodes, bool)).astype(np.float32)
    return GraphView(g, K, "global", None, None, loss,
                     {"targets": int(loss.sum()),
                      "active_nodes": int(g.num_nodes),
                      "active_edges": int(g.num_edges)})


def mini_batch_views(g: Graph, K: int, batch_nodes: int = 0,
                     neighbor_cap: int = 0, seed: int = 0,
                     steps: Optional[int] = None) -> Iterator[GraphView]:
    """Random labeled targets (1% of them by default, the paper's) and
    their K-hop dense views, from one sequential RNG, each view detached
    from the builder. ``neighbor_cap`` samples in-neighbours."""
    rng = np.random.default_rng(seed)
    labeled = np.where(g.train_mask if g.train_mask is not None
                       else np.ones(g.num_nodes, bool))[0]
    if len(labeled) == 0:
        raise ValueError(
            "mini_batch_views: the graph has no labeled nodes "
            "(train_mask selects nothing) to sample batch targets from")
    bsz = batch_nodes or max(1, len(labeled) // 100)
    builder = ViewBuilder(g, K, slots=1)   # views are copied out below
    i = 0
    while steps is None or i < steps:
        targets = rng.choice(labeled, size=min(bsz, len(labeled)),
                             replace=False)
        yield builder.khop_view(targets, neighbor_cap, rng).copy_masks()
        i += 1


def cluster_batch_views(g: Graph, K: int, clusters: np.ndarray,
                        clusters_per_batch: int = 0, halo_hops: int = 0,
                        seed: int = 0, steps: Optional[int] = None
                        ) -> Iterator[GraphView]:
    """Cluster batches (paper §2.3): random clusters, their members and a
    ``halo_hops`` boundary active, the edges inside the active set, the
    loss on labeled members; dense views from one sequential RNG, each
    detached from the builder."""
    rng = np.random.default_rng(seed)
    num_clusters = int(clusters.max()) + 1
    cpb = clusters_per_batch or max(1, num_clusters // 100)
    train = (g.train_mask if g.train_mask is not None
             else np.ones(g.num_nodes, bool))
    cache = ClusterViewCache(g, clusters, halo_hops)
    builder = ViewBuilder(g, K, slots=1)   # views are copied out below
    i = 0
    while steps is None or i < steps:
        chosen = rng.choice(num_clusters, size=min(cpb, num_clusters),
                            replace=False)
        yield builder.cluster_view(chosen, cache, train).copy_masks()
        i += 1


def strategy_views(g: Graph, strategy: str, K: int, seed: int = 0,
                   steps: Optional[int] = None,
                   batch_nodes: int = 0,
                   clusters: Optional[np.ndarray] = None,
                   clusters_per_batch: int = 0,
                   halo_hops: int = 1,
                   neighbor_cap: int = 0,
                   compact: bool = False) -> ViewStream:
    """One entry point for all three strategies (paper §2.3): an indexable
    :class:`ViewStream` whose view i is a pure function of ``(seed, i)``,
    the same views as the reference's ``strategy_views`` builds. The
    ``cluster`` strategy computes label-propagation communities when
    ``clusters`` is not given. ``compact=True`` makes the mini and
    cluster streams yield :class:`~repro_torch.core.views.CompactView` views
    (relabeled sampled subgraphs; the same node and edge sets and rng
    draws as the dense views, O(view) host cost); the global view is the
    whole graph and ignores it."""
    if strategy == "global":
        # the global view is static — every index yields the SAME object
        # so a trainer can recognize it and stage it once
        return GlobalViewStream(global_batch_view(g, K), length=steps)
    if strategy == "mini":
        return MiniBatchViewStream(g, K, batch_nodes=batch_nodes,
                                   neighbor_cap=neighbor_cap,
                                   seed=seed, length=steps,
                                   compact=compact)
    if strategy == "cluster":
        if clusters is None:
            from repro_torch.core.clustering import label_propagation_clusters
            clusters = label_propagation_clusters(
                g, max_cluster_size=max(64, g.num_nodes // 20), seed=seed)
        return ClusterViewStream(g, K, clusters,
                                 clusters_per_batch=clusters_per_batch,
                                 halo_hops=halo_hops, seed=seed,
                                 length=steps, compact=compact)
    raise ValueError(f"unknown strategy {strategy!r} "
                     "(expected global|mini|cluster)")
