"""K-hop exploration for compact views (paper §4.2): breadth-first over
incoming edges from the targets, vectorized over the frontier. A numpy
copy of the reference's ``core/subgraph.py`` functions that the compact
view path uses; same rng draws, same sets, bit for bit."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graph.csr import Graph


def _require_rng(neighbor_cap: int, rng) -> None:
    if neighbor_cap and rng is None:
        raise ValueError(
            "neighbor_cap sampling needs an explicit numpy Generator: "
            "pass rng=np.random.default_rng(seed)")


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
        stamp = np.full(g.num_nodes, -1, np.int64)
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
