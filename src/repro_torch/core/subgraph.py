"""K-hop exploration (paper §4.2): breadth-first over incoming edges from
the targets, vectorized over the frontier, and the per-layer active sets
it gives. A numpy copy of the reference's ``core/subgraph.py``: same rng
draws, same sets, bit for bit.

- :func:`bfs_layers` — cumulative hop sets, deduplicated through an
  (N,) visited array; :func:`fill_khop_masks` turns them into the dense
  ``(K, N)``/``(K, E)`` masks of a mini-batch view, and
  :func:`khop_subgraph_view` allocates and fills them in one call.
- :func:`bfs_layers_fresh` / :func:`stamped_in_edges` — the compact
  path's fresh-per-hop sets over a stamp array (O(view) work).
- :func:`bfs_layers_loop` — the per-node Python loop, the oracle the
  vectorized expansion is held against.
- :func:`subgraph_size_stats` — the paper's §1 subgraph-explosion
  measure: the share of the graph a K-hop neighbourhood touches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.csr import Graph


def _require_rng(neighbor_cap: int, rng) -> None:
    if neighbor_cap and rng is None:
        raise ValueError(
            "neighbor_cap sampling needs an explicit numpy Generator: "
            "pass rng=np.random.default_rng(seed)")


def bfs_layers(g: Graph, targets: np.ndarray, depth: int,
               neighbor_cap: int = 0,
               rng: Optional[np.random.Generator] = None,
               _visited_out: Optional[np.ndarray] = None):
    """Hop sets ``[S_0=targets, S_1, ..., S_depth]`` where S_k holds the
    nodes within k hops along *incoming* edges (sorted), and the (N,)
    visited array. ``neighbor_cap > 0`` samples at most that many
    in-neighbours per node per hop from ``rng``. ``_visited_out`` is a
    reusable (N,) bool scratch (the ViewBuilder's)."""
    _require_rng(neighbor_cap, rng)
    indptr, order = g.csc()
    src = g.src
    frontier = np.unique(targets).astype(np.int64)
    if _visited_out is not None:
        visited = _visited_out
        visited.fill(False)
    else:
        # documented caller-owned-scratch fallback: one O(N) allocation
        # per call when no scratch is supplied
        visited = np.zeros(g.num_nodes, bool)  # lint: waive=src.hot-full-graph-alloc
    visited[frontier] = True
    hops = [frontier]
    reached = frontier
    for _ in range(depth):
        eidx = _expand_frontier(indptr, order, reached, neighbor_cap, rng)
        if len(eidx):
            cand = np.unique(src[eidx]).astype(np.int64)
            new = cand[~visited[cand]]
            visited[new] = True
        else:
            new = np.zeros(0, np.int64)
        # hops[-1] with the new nodes is all visited so far, sorted
        hops.append(np.flatnonzero(visited))
        reached = new
        if len(new) == 0:
            # keep remaining hop sets constant
            for _ in range(depth - len(hops) + 1):
                hops.append(hops[-1])
            break
    return hops, visited


def bfs_layers_fresh(g: Graph, targets: np.ndarray, depth: int,
                     neighbor_cap: int = 0,
                     rng: Optional[np.random.Generator] = None,
                     stamp: Optional[np.ndarray] = None,
                     stamp_val: int = 0):
    """Fresh-per-hop node sets ``[F_0=targets, F_1, ..., F_depth]`` where
    F_d holds the nodes first reached at hop d (sorted). Dedup runs
    through a caller-owned stamp array (``stamp[v] == stamp_val`` marks v
    visited in this build), so per-view work is O(view edges)."""
    _require_rng(neighbor_cap, rng)
    indptr, order = g.csc()
    src = g.src
    if stamp is None:
        # documented caller-owned-scratch fallback (see docstring)
        stamp = np.full(g.num_nodes, -1, np.int64)  # lint: waive=src.hot-full-graph-alloc
        stamp_val = 0
    frontier = np.unique(targets).astype(np.int64)
    stamp[frontier] = stamp_val
    fresh = [frontier]
    reached = frontier
    for _ in range(depth):
        eidx = _expand_frontier(indptr, order, reached, neighbor_cap, rng)
        if len(eidx):
            cand = src[eidx]
            new = np.unique(cand[stamp[cand] != stamp_val]).astype(np.int64)
        else:
            new = np.zeros(0, np.int64)
        stamp[new] = stamp_val
        fresh.append(new)
        reached = new
        if len(new) == 0:
            # keep remaining fresh sets empty (hop sets stalled)
            for _ in range(depth - len(fresh) + 1):
                fresh.append(np.zeros(0, np.int64))
            break
    return fresh, stamp


def stamped_in_edges(g: Graph, dst_nodes: np.ndarray, stamp: np.ndarray,
                     stamp_val: int) -> np.ndarray:
    """Global edge ids of every in-edge of ``dst_nodes`` whose src is
    stamped, grouped by ``dst_nodes`` order."""
    indptr, order = g.csc()
    eidx = _expand_frontier(indptr, order, dst_nodes, 0, None)
    if len(eidx) == 0:
        return eidx
    return eidx[stamp[g.src[eidx]] == stamp_val]


def _expand_frontier(indptr: np.ndarray, order: np.ndarray,
                     reached: np.ndarray, neighbor_cap: int,
                     rng) -> np.ndarray:
    """Edge ids of every incoming edge of ``reached``, expanded in one
    shot; with a cap, each node keeps the ``cap`` smallest of per-slot
    uniform keys (one ``rng.random`` call for all segments)."""
    if len(reached) == 0:
        return np.zeros(0, np.int32)
    starts = indptr[reached]
    degs = indptr[reached + 1] - starts
    total = int(degs.sum())
    if total == 0:
        return np.zeros(0, np.int32)
    cum = np.cumsum(degs)
    seg_off = np.repeat(cum - degs, degs)        # expanded segment starts
    pos = np.arange(total, dtype=np.int64)
    idx = pos - seg_off + np.repeat(starts, degs)
    if neighbor_cap:
        keys = rng.random(total)
        seg_ids = np.repeat(np.arange(len(reached), dtype=np.int64), degs)
        sorter = np.lexsort((keys, seg_ids))
        rank = pos - seg_off
        idx = idx[sorter[rank < neighbor_cap]]
    return order[idx]


def bfs_layers_loop(g: Graph, targets: np.ndarray, depth: int,
                    neighbor_cap: int = 0,
                    rng: Optional[np.random.Generator] = None):
    """The per-node Python loop form of :func:`bfs_layers`, its oracle
    (bit-exact hop sets without a neighbour cap)."""
    _require_rng(neighbor_cap, rng)
    indptr, order = g.csc()
    src = g.src
    frontier = np.unique(targets).astype(np.int64)
    visited = np.zeros(g.num_nodes, bool)
    visited[frontier] = True
    hops = [frontier]
    reached = frontier
    for _ in range(depth):
        nbrs = []
        for u in reached:
            eids = order[indptr[u]:indptr[u + 1]]
            if neighbor_cap and len(eids) > neighbor_cap:
                eids = rng.choice(eids, neighbor_cap, replace=False)
            nbrs.append(src[eids])
        new = (np.unique(np.concatenate(nbrs)) if nbrs
               else np.zeros(0, np.int64))
        new = new[~visited[new]]
        visited[new] = True
        hops.append(np.union1d(hops[-1], new))
        reached = new
        if len(new) == 0:
            for _ in range(depth - len(hops) + 1):
                hops.append(hops[-1])
            break
    return hops, visited


def fill_khop_masks(g: Graph, hops, K: int, node_active: np.ndarray,
                    edge_active: np.ndarray,
                    in_hop: Optional[np.ndarray] = None) -> None:
    """Write the per-layer active masks of BFS ``hops`` into the caller's
    ``(K, N)``/``(K, E)`` float32 buffers (zeroed here). Layer k computes
    the embeddings of the nodes within K-1-k hops of the targets; its
    active edges are those whose dst is in that set and whose src is
    within one more hop. ``in_hop`` is a reusable (K+1, N) bool scratch."""
    N = g.num_nodes
    if in_hop is None:
        # documented caller-owned-scratch fallback (the ViewBuilder
        # passes its reusable (K+1, N) buffer)
        in_hop = np.zeros((K + 1, N), bool)  # lint: waive=src.hot-full-graph-alloc
    else:
        in_hop.fill(False)
    for d in range(K + 1):
        in_hop[d, hops[min(d, len(hops) - 1)]] = True
    node_active.fill(0.0)
    edge_active.fill(0.0)
    for k in range(K):
        out_set = in_hop[K - 1 - k]          # nodes whose h^{k+1} is needed
        src_set = in_hop[K - k]              # their in-neighbourhood
        node_active[k, out_set] = 1.0
        edge_active[k] = out_set[g.dst] & src_set[g.src]


def khop_subgraph_view(g: Graph, targets: np.ndarray, K: int,
                       neighbor_cap: int = 0,
                       rng: Optional[np.random.Generator] = None,
                       _bfs=None):
    """Per-layer active sets for a K-layer GNN with its loss on
    ``targets``: ``(node_active (K, N) f32, edge_active (K, E) f32,
    loss_mask (N,) f32, visited (N,) bool)``. ``_bfs`` swaps the
    expansion (:func:`bfs_layers_loop`); repeated builds without fresh
    allocations go through ``ViewBuilder.khop_view``."""
    hops, visited = (_bfs or bfs_layers)(g, targets, K, neighbor_cap, rng)
    N, E = g.num_nodes, g.num_edges
    node_active = np.zeros((K, N), np.float32)
    edge_active = np.zeros((K, E), np.float32)
    fill_khop_masks(g, hops, K, node_active, edge_active)
    loss_mask = np.zeros(N, np.float32)
    loss_mask[np.unique(targets)] = 1.0
    return node_active, edge_active, loss_mask, visited


def subgraph_size_stats(g: Graph, targets: np.ndarray, K: int) -> dict:
    """Paper §1: subgraph explosion metrics (fraction of graph touched)."""
    hops, visited = bfs_layers(g, targets, K)
    return {
        "targets": int(len(np.unique(targets))),
        "touched_nodes": int(visited.sum()),
        "touched_frac": float(visited.sum() / g.num_nodes),
        "hop_sizes": [int(len(h)) for h in hops],
    }
