"""Training strategies over views (paper §4.2/4.3): the counterpart of
the reference's ``core/strategies.py``. Global-, mini- and cluster-batch
are all streams of views, so one trainer loop drives every strategy:

- :func:`strategy_views` — the indexable :class:`ViewStream` a trainer
  drives (view i a pure function of ``(seed, i)``), dense or compact;
- :func:`mini_batch_views` / :func:`cluster_batch_views` — the
  reference's generators: one sequential RNG and detached dense views;
- :func:`shard_view` — a view's masks mapped onto a partition plan, for
  the distributed engine (:mod:`repro_torch.core.engine`), with its
  per-partition loop :func:`shard_view_loop` kept as the oracle."""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.core.views import (ClusterViewCache, ClusterViewStream,
                                    CompactView, GlobalViewStream,
                                    GraphView,
                                    MiniBatchViewStream, ViewBuilder,
                                    ViewStream)
from repro_torch.graph.csr import Graph

__all__ = ["GraphView", "ViewStream", "global_batch_view",
           "mini_batch_views", "cluster_batch_views", "strategy_views",
           "shard_view", "shard_view_loop"]


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


# -- sharding a view onto a partition plan (the distributed engine) ----------


def shard_view(plan, view) -> dict:
    """Map a view's global masks onto per-partition local arrays, bit for
    bit as the reference's ``shard_view``: numpy arrays stacked over the
    partitions, ``node_active`` (P, K, n_m_pad), ``edge_active`` (P, K,
    e_pad) and ``loss_mask`` (P, n_m_pad). One ``np.take`` over the
    stacked ``plan.masters`` / ``plan.edge_orig`` per mask, so the host
    cost a step is O(1) Python for any P; a CompactView goes through
    :func:`_shard_compact`."""
    if isinstance(view, CompactView):
        return _shard_compact(plan, view)
    P = plan.P
    K = view.K
    n_m_pad = plan.masters.shape[1]
    e_pad = plan.src_local.shape[1]
    loss = view.loss_mask[plan.masters] * plan.master_mask
    if view.node_active is None:
        node_active = np.broadcast_to(plan.master_mask[:, None, :],
                                      (P, K, n_m_pad)).copy()
    else:
        # (K, P, n_m_pad) -> (P, K, n_m_pad)
        node_active = (np.take(view.node_active, plan.masters, axis=1)
                       .transpose(1, 0, 2)
                       * plan.master_mask[:, None, :])
    if view.edge_active is None:
        edge_active = np.broadcast_to(plan.edge_mask[:, None, :],
                                      (P, K, e_pad)).copy()
    else:
        edge_active = (np.take(view.edge_active, plan.edge_orig, axis=1)
                       .transpose(1, 0, 2)
                       * plan.edge_mask[:, None, :])
    return {"node_active": np.ascontiguousarray(node_active, np.float32),
            "edge_active": np.ascontiguousarray(edge_active, np.float32),
            "loss_mask": np.ascontiguousarray(loss, np.float32)}


def _shard_compact(plan, view: CompactView) -> dict:
    """Sharded masks straight from a CompactView's id lists: only the
    view's |nodes| + |edges| entries are scattered into zeroed
    per-partition buffers through the plan's cached locators, O(view)
    host work. Bit-exact against ``shard_view(plan, view.to_dense())``:
    slots the view never touches stay zero, as the dense path's ``*
    master_mask`` / ``* edge_mask`` leave them."""
    P, K = plan.P, view.K
    n_m_pad = plan.masters.shape[1]
    e_pad = plan.src_local.shape[1]
    node_active = np.zeros((P, K, n_m_pad), np.float32)
    edge_active = np.zeros((P, K, e_pad), np.float32)
    loss = np.zeros((P, n_m_pad), np.float32)
    nslot = plan.node_locator()
    owner = plan.owner
    epart, eslot = plan.edge_locator()
    lidx = np.flatnonzero(view.loss_local)
    if len(lidx):
        ln = view.nodes[lidx]
        loss[owner[ln], nslot[ln]] = view.loss_local[lidx]
    off = view.hop_offsets
    for k in range(K):
        act = view.nodes[: int(off[K - 1 - k])]
        if len(act):
            node_active[owner[act], k, nslot[act]] = 1.0
        ids = view.edge_ids[view.edge_layer_mask(k)]
        if len(ids):
            edge_active[epart[ids], k, eslot[ids]] = 1.0
    return {"node_active": node_active, "edge_active": edge_active,
            "loss_mask": loss}


def shard_view_loop(plan, view: GraphView) -> dict:
    """The per-partition loop form of :func:`shard_view` (the
    reference's parity oracle and naive host baseline), bit-exact
    against it."""
    P = plan.P
    K = view.K
    n_m_pad = plan.masters.shape[1]
    e_pad = plan.src_local.shape[1]
    node_active = np.ones((P, K, n_m_pad), np.float32)
    edge_active = np.ones((P, K, e_pad), np.float32)
    loss = np.zeros((P, n_m_pad), np.float32)
    for p in range(P):
        mids = plan.masters[p]
        loss[p] = view.loss_mask[mids] * plan.master_mask[p]
        if view.node_active is not None:
            node_active[p] = (view.node_active[:, mids]
                              * plan.master_mask[p][None, :])
        else:
            node_active[p] *= plan.master_mask[p][None, :]
        eids = plan.edge_orig[p]
        if view.edge_active is not None:
            edge_active[p] = (view.edge_active[:, eids]
                              * plan.edge_mask[p][None, :])
        else:
            edge_active[p] *= plan.edge_mask[p][None, :]
    return {"node_active": node_active, "edge_active": edge_active,
            "loss_mask": loss}
