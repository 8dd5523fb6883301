"""Training strategies over views (paper §4.2/4.3): the counterpart of
the reference's ``core/strategies.py``. Global-, mini- and cluster-batch
are all streams of views, so one trainer loop drives every strategy.
Sharding a view onto a partition plan (``shard_view``) waits for the
engine (ROADMAP A.9)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.views import (ClusterViewStream, GlobalViewStream,
                                    GraphView, MiniBatchViewStream,
                                    ViewStream)
from repro_torch.graph.csr import Graph

__all__ = ["GraphView", "ViewStream", "global_batch_view", "strategy_views"]


def global_batch_view(g: Graph, K: int) -> GraphView:
    """Full graph convolution each step (paper: stable, costliest step)."""
    loss = (g.train_mask if g.train_mask is not None
            else np.ones(g.num_nodes, bool)).astype(np.float32)
    return GraphView(g, K, "global", None, None, loss,
                     {"targets": int(loss.sum()),
                      "active_nodes": int(g.num_nodes),
                      "active_edges": int(g.num_edges)})


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
    ``clusters`` is not given. Mini and cluster streams need
    ``compact=True`` until the dense mask views are ported (ROADMAP A.7);
    the global view is the whole graph and ignores it."""
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
