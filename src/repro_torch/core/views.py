"""Compact views and bucketed staging (paper §2.3/§4.2 host path).

The compact half of the reference's ``core/views.py``:

- :class:`CompactView` — a relabeled K-hop subgraph: local-id edge list
  over the sampled nodes, a local→global map and per-hop offsets, so
  host work and device memory scale with the view, not the graph.
- :class:`BucketSpec` / :class:`CompactBlockBuilder` — blocks padded to
  a small menu of ``(n_pad, e_pad)`` shapes, staged into per-bucket
  rings of reusable numpy buffers.
- :class:`ViewBuilder` — ``khop_compact`` builds.

A staged block's tensors alias ring memory (``torch.from_numpy``) and
stay valid until ``slots`` more views land in the same bucket; a
consumer that holds a block longer copies it first
(``GraphBlock.to(device, copy=True)``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.subgraph import bfs_layers_fresh, stamped_in_edges
from repro_torch.graph.csr import Graph, GraphBlock, block_from_arrays
from repro_torch.kernels.plan import build_bucket_csc_plan


@dataclass
class CompactView:
    """A relabeled sampled subgraph.

    ``nodes`` holds the sampled global ids in hop order (``hop_offsets[d]``
    = number of nodes within d hops), so per-layer activity is a rank
    comparison in local-id space::

        node active in layer k  <=>  local_id < hop_offsets[K-1-k]
        edge active in layer k  <=>  dst_local < hop_offsets[K-1-k]
                                  and src_local < hop_offsets[K-k]
    """
    graph: Graph
    K: int
    strategy: str
    nodes: np.ndarray         # (n,) int64 global ids, hop-ordered
    hop_offsets: np.ndarray   # (K+1,) int64; hop_offsets[-1] == n
    src_local: np.ndarray     # (e,) int32
    dst_local: np.ndarray     # (e,) int32, nondecreasing
    edge_ids: np.ndarray      # (e,) int64 global edge ids
    loss_local: np.ndarray    # (n,) f32 loss mask in local id space
    meta: dict

    @property
    def num_nodes(self) -> int:
        return int(len(self.nodes))

    @property
    def num_edges(self) -> int:
        return int(len(self.edge_ids))

    def layer_bounds(self, k: int) -> tuple:
        """(dst-side, src-side) local-id bounds of layer k."""
        off = self.hop_offsets
        return int(off[self.K - 1 - k]), int(off[self.K - k])

    def edge_layer_mask(self, k: int) -> np.ndarray:
        d_bound, s_bound = self.layer_bounds(k)
        return (self.dst_local < d_bound) & (self.src_local < s_bound)


def _ceil_pow2(x: int) -> int:
    return 1 << (max(1, int(x)) - 1).bit_length()


@dataclass(frozen=True)
class BucketSpec:
    """A small fixed menu of ``(n_pad, e_pad)`` padded shapes;
    :meth:`pick` returns the smallest bucket fitting a view."""
    shapes: tuple    # ((n_pad, e_pad), ...), kept sorted ascending

    def __post_init__(self):
        shapes = tuple(sorted({(int(n), int(e)) for n, e in self.shapes}))
        if not shapes:
            raise ValueError("BucketSpec needs at least one (n_pad, e_pad)")
        object.__setattr__(self, "shapes", shapes)

    @classmethod
    def for_graph(cls, g: Graph, levels: int = 4, n_min: int = 64,
                  e_min: int = 256) -> "BucketSpec":
        """Powers-of-two ladder from ``(n_min, e_min)`` up to graph
        capacity (halving per level)."""
        n_top = _ceil_pow2(max(n_min, g.num_nodes))
        e_top = _ceil_pow2(max(e_min, g.num_edges))
        return cls(tuple((max(n_min, n_top >> i), max(e_min, e_top >> i))
                         for i in range(max(1, int(levels)))))

    def __len__(self) -> int:
        return len(self.shapes)

    def pick(self, n: int, e: int) -> tuple:
        for shape in self.shapes:
            if shape[0] >= n and shape[1] >= e:
                return shape
        raise ValueError(
            f"view ({n} nodes, {e} edges) overflows every bucket "
            f"{list(self.shapes)} — supply a BucketSpec with a larger "
            f"(n_pad, e_pad)")


class _CompactSlot:
    """One bucket-shaped set of reusable block buffers. ``feature_dim``
    overrides the feature width when ``x`` rows come from another source
    than ``g.node_features`` (the serving cache's hidden-layer rows)."""

    def __init__(self, g: Graph, K: int, n_pad: int, e_pad: int,
                 feature_dim: Optional[int] = None):
        F = (g.node_features.shape[1] if feature_dim is None
             else int(feature_dim))
        self.src = np.zeros(e_pad, np.int32)
        self.dst = np.zeros(e_pad, np.int32)
        self.edge_mask = np.zeros(e_pad, np.float32)
        self.node_mask = np.zeros(n_pad, np.float32)
        self.x = np.zeros((n_pad, F), np.float32)
        self.y = np.zeros(n_pad, np.int32)
        self.loss = np.zeros(n_pad, np.float32)
        self.edge_weight = np.zeros(e_pad, np.float32)
        self.edge_attr = (np.zeros((e_pad, g.edge_features.shape[1]),
                                   np.float32)
                          if g.edge_features is not None else None)
        self.node_active = np.zeros((K, n_pad), np.float32)
        self.edge_active = np.zeros((K, e_pad), np.float32)


def _fill_compact_block(view: CompactView, slot: _CompactSlot,
                        gcn_norm: bool, csc_plan: bool,
                        features: Optional[np.ndarray] = None
                        ) -> GraphBlock:
    """Gather the view's node/edge data into (zeroed) bucket-shaped
    buffers. Pad edges keep src = dst = 0 with edge_mask 0, inert under
    every combine mode; in the plan they join no row."""
    g, K = view.graph, view.K
    n, e = view.num_nodes, view.num_edges
    x_src = g.node_features if features is None else features
    slot.src.fill(0)
    slot.src[:e] = view.src_local
    slot.dst.fill(0)
    slot.dst[:e] = view.dst_local
    slot.edge_mask.fill(0.0)
    slot.edge_mask[:e] = 1.0
    slot.node_mask.fill(0.0)
    slot.node_mask[:n] = 1.0
    slot.x.fill(0.0)
    slot.x[:n] = x_src[view.nodes]
    slot.y.fill(0)
    slot.y[:n] = g.labels[view.nodes]
    slot.loss.fill(0.0)
    slot.loss[:n] = view.loss_local
    slot.edge_weight.fill(0.0)
    if gcn_norm:
        slot.edge_weight[:e] = g.gcn_norm()[view.edge_ids]
    elif g.edge_weights is not None:
        slot.edge_weight[:e] = g.edge_weights[view.edge_ids]
    else:
        slot.edge_weight[:e] = 1.0
    if slot.edge_attr is not None:
        slot.edge_attr.fill(0.0)
        slot.edge_attr[:e] = g.edge_features[view.edge_ids]
    slot.node_active.fill(0.0)
    slot.edge_active.fill(0.0)
    for k in range(K):
        d_bound, _ = view.layer_bounds(k)
        slot.node_active[k, :d_bound] = 1.0   # hop-ordered: a prefix
        slot.edge_active[k, :e][view.edge_layer_mask(k)] = 1.0
    plan = None
    if csc_plan:
        plan = build_bucket_csc_plan(view.dst_local, len(slot.node_mask),
                                     len(slot.edge_mask))
    return block_from_arrays(slot.src, slot.dst, slot.edge_mask,
                             slot.node_mask, slot.x, slot.y, slot.loss,
                             slot.edge_weight, slot.edge_attr,
                             node_active=slot.node_active,
                             edge_active=slot.edge_active, csc_plan=plan)


class CompactBlockBuilder:
    """Stages CompactViews into per-bucket rings of reusable padded
    buffers; with ``csc_plan=True`` a bucket-shaped plan is built per view
    from the compact dst ids (host cost O(view)). ``features`` substitutes
    another (N, D) row source for ``g.node_features`` (the serving
    cache's table, updated in place)."""

    def __init__(self, g: Graph, K: int,
                 buckets: Optional[BucketSpec] = None, slots: int = 2,
                 gcn_norm: bool = True, csc_plan: bool = False,
                 features: Optional[np.ndarray] = None):
        self.g = g
        self.K = int(K)
        self.features = features
        self.buckets = buckets or BucketSpec.for_graph(g)
        self.slots = max(1, int(slots))
        self.gcn_norm = bool(gcn_norm)
        self.csc_plan = bool(csc_plan)
        self._rings: dict = {}     # (n_pad, e_pad) -> [_CompactSlot, ...]
        self._turns: dict = {}
        self.stages = 0
        # views too large for every bucket (escalated, warned once)
        self.overflows = 0
        self._warned_overflow = False

    def _pick(self, view: CompactView) -> tuple:
        """The view's bucket; a view too large for every configured
        bucket escalates to a power-of-two shape covering it."""
        try:
            return self.buckets.pick(view.num_nodes, view.num_edges)
        except ValueError:
            self.overflows += 1
            if not self._warned_overflow:
                self._warned_overflow = True
                warnings.warn(
                    f"CompactView ({view.num_nodes} nodes, "
                    f"{view.num_edges} edges) overflows every bucket "
                    f"{list(self.buckets.shapes)}; escalating to a "
                    "power-of-two shape at most graph capacity.",
                    RuntimeWarning, stacklevel=3)
            n = min(_ceil_pow2(view.num_nodes), self.g.num_nodes)
            e = min(_ceil_pow2(view.num_edges), self.g.num_edges)
            return (max(n, view.num_nodes), max(e, view.num_edges))

    def stage(self, view: CompactView) -> GraphBlock:
        self.stages += 1
        shape = self._pick(view)
        ring = self._rings.setdefault(shape, [])
        if len(ring) < self.slots:
            fdim = (None if self.features is None
                    else self.features.shape[1])
            ring.append(_CompactSlot(self.g, self.K, *shape,
                                     feature_dim=fdim))
        turn = self._turns.get(shape, 0)
        self._turns[shape] = turn + 1
        return _fill_compact_block(view, ring[turn % len(ring)],
                                   self.gcn_norm, self.csc_plan,
                                   features=self.features)


class ViewBuilder:
    """Builds compact K-hop views with reusable stamp scratch (single
    consumer). Dense mask views and cluster views wait for the training
    slice."""

    def __init__(self, g: Graph, K: int):
        self.g = g
        self.K = K
        g.csc()     # no-op when cached
        self.builds = 0
        self._stamp: Optional[np.ndarray] = None
        self._g2l: Optional[np.ndarray] = None
        self._tick = 0

    def _compact_scratch(self):
        if self._stamp is None:
            self._stamp = np.full(self.g.num_nodes, -1, np.int64)
            self._g2l = np.zeros(self.g.num_nodes, np.int64)
        self._tick += 1
        return self._stamp, self._g2l, self._tick

    def khop_compact(self, targets: np.ndarray, neighbor_cap: int = 0,
                     rng: Optional[np.random.Generator] = None
                     ) -> CompactView:
        """Hop-ordered relabeling straight from the fresh-per-hop
        frontiers; edges are all in-edges of nodes within K-1 hops whose
        src was visited, CSC-sorted by local dst."""
        g, K = self.g, self.K
        stamp, g2l, tick = self._compact_scratch()
        fresh, _ = bfs_layers_fresh(g, targets, K, neighbor_cap, rng,
                                    stamp=stamp, stamp_val=tick)
        self.builds += 1
        offsets = np.cumsum([len(f) for f in fresh]).astype(np.int64)
        nodes = np.concatenate(fresh)
        n = int(offsets[-1])
        g2l[nodes] = np.arange(n)
        eidx = stamped_in_edges(g, nodes[:int(offsets[K - 1])], stamp, tick)
        src_local = g2l[g.src[eidx]].astype(np.int32)
        dst_local = g2l[g.dst[eidx]].astype(np.int32)
        sorter = np.argsort(dst_local, kind="stable")
        loss_local = np.zeros(n, np.float32)
        loss_local[:int(offsets[0])] = 1.0    # hop 0 = the unique targets
        return CompactView(
            g, K, "mini", nodes, offsets, src_local[sorter],
            dst_local[sorter], eidx[sorter].astype(np.int64), loss_local,
            {"targets": int(offsets[0]), "touched": n,
             "active_nodes": int(offsets[K - 1]),
             "active_edges": int(len(eidx))})
