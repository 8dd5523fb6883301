"""Community detection for cluster-batched training (paper §2.3, §4.1).
A numpy copy of the reference's ``core/clustering.py``: the same draws,
the same labels, bit for bit.

The paper generates clusters "by using a community detection algorithm
based on maximizing intra-community edges" (Louvain [5]; METIS also
supported). We provide:

- ``label_propagation_clusters`` — native numpy asynchronous label
  propagation (Louvain-quality-ish, linear time) with a balancing pass that
  splits oversized communities (cluster-batch wants bounded batch sizes).
- ``louvain_clusters`` — networkx Louvain when available (small graphs).
- ``hash_clusters`` — degenerate hash partition (the "no community
  structure" baseline the paper warns about in Table A1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.csr import Graph


def cluster_members(labels: np.ndarray,
                    num_clusters: Optional[int] = None) -> list:
    """Per-cluster sorted member node-id arrays, in one argsort instead of
    C boolean scans. The ClusterViewCache (repro_torch.core.views) builds its
    static member sets through this."""
    labels = np.asarray(labels)
    C = int(num_clusters if num_clusters is not None else labels.max() + 1)
    order = np.argsort(labels, kind="stable")   # ties keep node-id order
    counts = np.bincount(labels, minlength=C)
    return np.split(order, np.cumsum(counts)[:-1])


def hash_clusters(g: Graph, num_clusters: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.num_nodes)
    out = np.empty(g.num_nodes, np.int32)
    out[perm] = np.arange(g.num_nodes) % num_clusters
    return out


def label_propagation_clusters(g: Graph, max_cluster_size: int = 0,
                               iters: int = 8, seed: int = 0) -> np.ndarray:
    """Asynchronous label propagation; returns dense cluster ids (0..C-1)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    labels = np.arange(n, dtype=np.int64)
    indptr, order = g.csc()
    src = g.src
    nodes = np.arange(n)
    for _ in range(iters):
        rng.shuffle(nodes)
        changed = 0
        for u in nodes:
            eids = order[indptr[u]:indptr[u + 1]]
            if len(eids) == 0:
                continue
            nbr_labels = labels[src[eids]]
            vals, counts = np.unique(nbr_labels, return_counts=True)
            best = vals[np.argmax(counts)]
            if best != labels[u]:
                labels[u] = best
                changed += 1
        if changed == 0:
            break
    labels = _densify(labels)
    if max_cluster_size:
        labels = _split_oversized(labels, max_cluster_size, rng)
    return labels.astype(np.int32)


def louvain_clusters(g: Graph, seed: int = 0,
                     max_cluster_size: int = 0) -> np.ndarray:
    """networkx Louvain (small/medium graphs only)."""
    import networkx as nx

    G = nx.Graph()
    G.add_nodes_from(range(g.num_nodes))
    G.add_edges_from(zip(g.src.tolist(), g.dst.tolist()))
    comms = nx.community.louvain_communities(G, seed=seed)
    labels = np.zeros(g.num_nodes, np.int64)
    for c, nodes in enumerate(comms):
        labels[list(nodes)] = c
    if max_cluster_size:
        labels = _split_oversized(labels, max_cluster_size,
                                  np.random.default_rng(seed))
    return _densify(labels).astype(np.int32)


def _densify(labels: np.ndarray) -> np.ndarray:
    _, dense = np.unique(labels, return_inverse=True)
    return dense


def _split_oversized(labels: np.ndarray, max_size: int,
                     rng: np.random.Generator) -> np.ndarray:
    labels = _densify(labels)
    next_id = labels.max() + 1
    for c in range(labels.max() + 1):
        members = np.where(labels == c)[0]
        if len(members) > max_size:
            rng.shuffle(members)
            n_sub = int(np.ceil(len(members) / max_size))
            for i in range(1, n_sub):
                labels[members[i * max_size:(i + 1) * max_size]] = next_id
                next_id += 1
    return _densify(labels)


def modularity(g: Graph, labels: np.ndarray) -> float:
    """Newman modularity Q of a clustering (quality metric for Fig. 10)."""
    m = g.num_edges
    if m == 0:
        return 0.0
    # edges are stored in both directions => treat as a symmetric digraph:
    # Q = Σ_c [ e_cc/M - (d_c/M)^2 ]  with d_c = Σ out-degree in c
    same = labels[g.src] == labels[g.dst]
    intra = float(same.sum()) / m
    deg = np.bincount(g.src, minlength=g.num_nodes).astype(np.float64)
    tot = np.zeros(int(labels.max()) + 1)
    np.add.at(tot, labels, deg)
    return intra - float(np.sum((tot / m) ** 2))
