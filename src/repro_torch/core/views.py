"""Views, view streams and bucketed staging (paper §2.3/§4.2 host path),
the counterpart of the reference's ``core/views.py``:

- :class:`GraphView` — a logic view of the whole graph (per-layer
  ``(K, N)``/``(K, E)`` active masks and a loss mask): the global
  strategy's view and the dense form of the mini and cluster views.
- :class:`CompactView` — a relabeled sampled subgraph: local-id edge
  list over the sampled nodes, a local→global map and per-hop offsets, so
  host work and device memory scale with the view, not the graph.
- :class:`BucketSpec` / :class:`CompactBlockBuilder` — blocks padded to
  a small menu of ``(n_pad, e_pad)`` shapes, staged into per-bucket
  rings of reusable numpy buffers.
- :class:`ClusterViewCache` — per-cluster member and halo node sets,
  computed once per clustering.
- :class:`ViewBuilder` — dense builds (``khop_view``, ``cluster_view``)
  into a ring of reusable mask buffers, and compact ones
  (``khop_compact``, ``cluster_compact``); both draw the same rng
  numbers, so view i's node and edge sets are the same in either form
  (``CompactView.to_dense``).
- :class:`ViewStream` — indexable strategy streams: view i is built from
  an RNG stream derived from ``(seed, i)``, the same draws as the
  reference's, so both packages build the same views.

A dense view's masks alias its builder's ring and stay valid until
``slots`` more views are built from it (``GraphView.copy_masks``
detaches them).

A staged block's tensors alias ring memory (``torch.from_numpy``) and
stay valid until ``slots`` more views land in the same bucket; a
consumer that holds a block longer copies it first
(``GraphBlock.to(device, copy=True)``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.subgraph import (_expand_frontier, bfs_layers,
                                       bfs_layers_fresh, fill_khop_masks,
                                       stamped_in_edges)
from repro_torch.graph.csr import (Graph, GraphBlock, base_block,
                                   block_from_arrays)
from repro_torch.kernels.plan import build_bucket_csc_plan


@dataclass
class GraphView:
    """Per-layer node/edge active masks plus a loss mask over the whole
    graph; ``None`` masks mean every node or edge is active."""
    graph: Graph
    K: int
    strategy: str
    node_active: Optional[np.ndarray]    # (K, N) f32 or None (=all)
    edge_active: Optional[np.ndarray]    # (K, M) f32 or None
    loss_mask: np.ndarray                # (N,) f32
    meta: dict

    def as_block(self, gcn_norm: bool = True,
                 csc_plan: bool = False) -> GraphBlock:
        """This view's masks stamped onto a shallow copy of the graph's
        cached base block (features, edge layout, norms and plan shared
        read-only across views)."""
        base = base_block(self.graph, gcn_norm=gcn_norm, csc_plan=csc_plan)
        as_t = (lambda a: None if a is None
                else torch.from_numpy(np.asarray(a, np.float32)))
        return replace(base,
                       loss_mask=as_t((self.loss_mask > 0).astype(
                           np.float32)),
                       node_active=as_t(self.node_active),
                       edge_active=as_t(self.edge_active))

    _COUNT_KEYS = ("active_nodes", "active_edges", "targets")

    def active_counts(self) -> dict:
        """The builder's counts from ``meta``; a view built by hand
        without them falls back to scanning the masks."""
        m = self.meta
        if all(k in m for k in self._COUNT_KEYS):
            return {k: int(m[k]) for k in self._COUNT_KEYS}
        n_nodes = (self.graph.num_nodes if self.node_active is None
                   else int((self.node_active.max(axis=0) > 0).sum()))
        n_edges = (self.graph.num_edges if self.edge_active is None
                   else int((self.edge_active.max(axis=0) > 0).sum()))
        return {"active_nodes": n_nodes, "active_edges": n_edges,
                "targets": int((self.loss_mask > 0).sum())}

    def copy_masks(self) -> "GraphView":
        """Detach from any builder buffers (fresh mask arrays)."""
        return GraphView(
            self.graph, self.K, self.strategy,
            None if self.node_active is None else self.node_active.copy(),
            None if self.edge_active is None else self.edge_active.copy(),
            self.loss_mask.copy(), dict(self.meta))


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

    def nbytes(self) -> int:
        """Host bytes this view owns."""
        return int(self.nodes.nbytes + self.hop_offsets.nbytes
                   + self.src_local.nbytes + self.dst_local.nbytes
                   + self.edge_ids.nbytes + self.loss_local.nbytes)

    def layer_bounds(self, k: int) -> tuple:
        """(dst-side, src-side) local-id bounds of layer k."""
        off = self.hop_offsets
        return int(off[self.K - 1 - k]), int(off[self.K - k])

    def edge_layer_mask(self, k: int) -> np.ndarray:
        d_bound, s_bound = self.layer_bounds(k)
        return (self.dst_local < d_bound) & (self.src_local < s_bound)

    def active_counts(self) -> dict:
        return {"active_nodes": int(self.hop_offsets[self.K - 1]),
                "active_edges": self.num_edges,
                "targets": int((self.loss_local > 0).sum())}

    def copy_masks(self) -> "CompactView":
        """Detach (fresh arrays) — the ViewStream iterator contract."""
        return CompactView(self.graph, self.K, self.strategy,
                           self.nodes.copy(), self.hop_offsets.copy(),
                           self.src_local.copy(), self.dst_local.copy(),
                           self.edge_ids.copy(), self.loss_local.copy(),
                           dict(self.meta))

    def to_dense(self) -> GraphView:
        """The dense ``(K, N)``/``(K, E)`` mask view of the same node and
        edge sets (equal to the dense builder's at the same stream
        index)."""
        g, K = self.graph, self.K
        na = np.zeros((K, g.num_nodes), np.float32)
        ea = np.zeros((K, g.num_edges), np.float32)
        for k in range(K):
            d_bound, _ = self.layer_bounds(k)
            na[k, self.nodes[:d_bound]] = 1.0
            ea[k, self.edge_ids[self.edge_layer_mask(k)]] = 1.0
        loss = np.zeros(g.num_nodes, np.float32)
        loss[self.nodes] = self.loss_local
        return GraphView(g, K, self.strategy, na, ea, loss,
                         dict(self.meta))

    def as_block(self, gcn_norm: bool = True, csc_plan: bool = False,
                 bucket: Optional[tuple] = None) -> GraphBlock:
        """One-off padded block with fresh arrays; ``bucket`` is an
        ``(n_pad, e_pad)`` pair (None pads tight)."""
        n_pad, e_pad = bucket or (max(1, self.num_nodes),
                                  max(1, self.num_edges))
        slot = _CompactSlot(self.graph, self.K, int(n_pad), int(e_pad))
        return _fill_compact_block(self, slot, gcn_norm, csc_plan)


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
                        features: Optional[np.ndarray] = None,
                        src_plan: bool = False) -> GraphBlock:
    """Gather the view's node/edge data into (zeroed) bucket-shaped
    buffers. Pad edges keep src = dst = 0 with edge_mask 0, inert under
    every combine mode; in the plans they join no row. ``src_plan``
    also builds the plan over the source ids (the gather backward's)."""
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
    n_pad, e_pad = len(slot.node_mask), len(slot.edge_mask)
    plan = (build_bucket_csc_plan(view.dst_local, n_pad, e_pad)
            if csc_plan else None)
    splan = (build_bucket_csc_plan(view.src_local, n_pad, e_pad)
             if csc_plan and src_plan else None)
    return block_from_arrays(slot.src, slot.dst, slot.edge_mask,
                             slot.node_mask, slot.x, slot.y, slot.loss,
                             slot.edge_weight, slot.edge_attr,
                             node_active=slot.node_active,
                             edge_active=slot.edge_active, csc_plan=plan,
                             src_plan=splan)


class CompactBlockBuilder:
    """Stages CompactViews into per-bucket rings of reusable padded
    buffers; with ``csc_plan=True`` a bucket-shaped plan is built per view
    from the compact dst ids (host cost O(view)), and with ``src_plan=True``
    another from the src ids, which the gather backward of a training step
    reads (serving, which takes no gradient, leaves it out). ``features``
    substitutes another (N, D) row source for ``g.node_features`` (the
    serving cache's table, updated in place)."""

    def __init__(self, g: Graph, K: int,
                 buckets: Optional[BucketSpec] = None, slots: int = 2,
                 gcn_norm: bool = True, csc_plan: bool = False,
                 features: Optional[np.ndarray] = None,
                 src_plan: bool = False):
        self.g = g
        self.K = int(K)
        self.features = features
        self.buckets = buckets or BucketSpec.for_graph(g)
        self.slots = max(1, int(slots))
        self.gcn_norm = bool(gcn_norm)
        self.csc_plan = bool(csc_plan)
        self.src_plan = bool(src_plan)
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

    def bucket_for(self, view) -> tuple:
        """The view's ``(n_pad, e_pad)``: a GraphView's is the whole
        graph's shape, the dense path's single bucket."""
        if isinstance(view, GraphView):
            return (view.graph.num_nodes, view.graph.num_edges)
        return self._pick(view)

    def stage(self, view) -> GraphBlock:
        """A bucket-padded block over ring memory; a GraphView stages as
        its own full-graph block (the graph's cached base block with the
        view's masks)."""
        self.stages += 1
        if isinstance(view, GraphView):
            return view.as_block(gcn_norm=self.gcn_norm,
                                 csc_plan=self.csc_plan)
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
                                   features=self.features,
                                   src_plan=self.src_plan)


def cluster_view_recompute(g: Graph, clusters: np.ndarray,
                           chosen: np.ndarray, halo_hops: int,
                           train: np.ndarray):
    """A cluster view recomputed from scratch (``np.isin`` membership and
    halo edge walks), the oracle :meth:`ViewBuilder.cluster_view` is held
    against. Returns (member bool(N), active bool(N), loss f32(N))."""
    member = np.isin(clusters, chosen)
    active = member.copy()
    for _ in range(halo_hops):
        # grow along incoming edges (neighbours feeding the members)
        grow = np.zeros(g.num_nodes, bool)
        inside = active[g.dst]
        grow[g.src[inside]] = True
        active |= grow
    loss = (member & train).astype(np.float32)
    if loss.sum() == 0:
        loss = member.astype(np.float32)
    return member, active, loss


class ClusterViewCache:
    """Static per-cluster node sets, computed once per clustering.

    ``members[c]`` — sorted member node ids of cluster c;
    ``halo[c]`` — sorted node ids of c's ``halo_hops``-grown active set.
    A step's active set over any chosen clusters is the union of the
    cached sets (the halo of a union is the union of the halos)."""

    def __init__(self, g: Graph, clusters: np.ndarray, halo_hops: int = 0):
        from repro_torch.core.clustering import cluster_members
        self.g = g
        self.clusters = np.asarray(clusters)
        self.halo_hops = int(halo_hops)
        self.num_clusters = int(self.clusters.max()) + 1
        self.members = cluster_members(self.clusters, self.num_clusters)
        self.halo = (self.members if self.halo_hops == 0
                     else self._grow_halos())

    def _grow_halos(self) -> list:
        """Per-cluster halo BFS over the in-edges of the frontier, with a
        stamp array (last cluster to visit each node) as the visited set."""
        g, C = self.g, self.num_clusters
        indptr, order = g.csc()
        src = g.src
        stamp = np.full(g.num_nodes, -1, np.int64)
        halos = []
        for c in range(C):
            frontier = self.members[c]
            stamp[frontier] = c
            grown = [frontier]
            for _ in range(self.halo_hops):
                eidx = _expand_frontier(indptr, order, frontier, 0, None)
                if len(eidx) == 0:
                    break
                cand = src[eidx]
                fresh = np.unique(cand[stamp[cand] != c])
                if len(fresh) == 0:
                    break
                stamp[fresh] = c
                grown.append(fresh)
                frontier = fresh
            halos.append(np.unique(np.concatenate(grown))
                         if len(grown) > 1 else np.asarray(frontier))
        return halos

    def compose(self, chosen, member_out: np.ndarray,
                active_out: np.ndarray) -> None:
        """OR the chosen clusters' cached sets into the caller's (N,)
        bool scratch buffers."""
        member_out.fill(False)
        member_out[np.concatenate([self.members[c] for c in chosen])] = True
        active_out.fill(False)
        active_out[np.concatenate([self.halo[c] for c in chosen])] = True


class _Slot:
    """One dense view's mask buffers."""

    def __init__(self, K: int, N: int, E: int):
        self.node = np.zeros((K, N), np.float32)
        self.edge = np.zeros((K, E), np.float32)
        self.loss = np.zeros(N, np.float32)


class ViewBuilder:
    """Builds views for one consumer. Dense builds rotate through
    ``slots`` preallocated mask buffers, so a dense view's arrays stay
    valid until ``slots`` more views are built; ``compact=True`` builders
    own no dense buffers and only make compact views, with reusable stamp
    scratch."""

    def __init__(self, g: Graph, K: int, slots: int = 2,
                 compact: bool = False):
        self.g = g
        self.K = K
        self.compact = bool(compact)
        N, E = g.num_nodes, g.num_edges
        g.csc()     # no-op when cached
        if self.compact:
            self._slots = []
        else:
            self._slots = [_Slot(K, N, E) for _ in range(max(1, slots))]
            # shared scratch (single consumer; never escapes into views)
            self._visited = np.zeros(N, bool)
            self._in_hop = np.zeros((K + 1, N), bool)
            self._member = np.zeros(N, bool)
            self._active = np.zeros(N, bool)
        self._turn = 0
        self.builds = 0
        self._stamp: Optional[np.ndarray] = None
        self._g2l: Optional[np.ndarray] = None
        self._tick = 0
        # all-ones train fallback for graphs without a train_mask
        self._all_train: Optional[np.ndarray] = None

    def _train_mask(self, train: Optional[np.ndarray]) -> np.ndarray:
        if train is not None:
            return train
        if self.g.train_mask is not None:
            return self.g.train_mask
        if self._all_train is None:
            self._all_train = np.ones(self.g.num_nodes, bool)
        return self._all_train

    def _next_slot(self) -> _Slot:
        if not self._slots:
            raise RuntimeError(
                "this ViewBuilder was created compact=True and owns no "
                "dense mask buffers; use khop_compact/cluster_compact")
        slot = self._slots[self._turn % len(self._slots)]
        self._turn += 1
        self.builds += 1
        return slot

    def _compact_scratch(self):
        if self._stamp is None:
            self._stamp = np.full(self.g.num_nodes, -1, np.int64)
            self._g2l = np.zeros(self.g.num_nodes, np.int64)
        self._tick += 1
        return self._stamp, self._g2l, self._tick

    def khop_view(self, targets: np.ndarray, neighbor_cap: int = 0,
                  rng: Optional[np.random.Generator] = None) -> GraphView:
        """The K-hop dense view of ``targets`` in the next ring slot; the
        same masks as :func:`~repro_torch.core.subgraph.
        khop_subgraph_view`."""
        slot = self._next_slot()
        hops, visited = bfs_layers(self.g, targets, self.K, neighbor_cap,
                                   rng, _visited_out=self._visited)
        fill_khop_masks(self.g, hops, self.K, slot.node, slot.edge,
                        in_hop=self._in_hop)
        slot.loss.fill(0.0)
        uniq = np.unique(targets)
        slot.loss[uniq] = 1.0
        # counts recorded at build time, so active_counts() never scans
        # the masks (layer 0 is the union across layers)
        return GraphView(self.g, self.K, "mini", slot.node, slot.edge,
                         slot.loss,
                         {"targets": int(len(uniq)),
                          "touched": int(visited.sum()),
                          "active_nodes": int(len(hops[self.K - 1])),
                          "active_edges": int(slot.edge[0].sum())})

    def cluster_view(self, chosen: np.ndarray, cache: ClusterViewCache,
                     train: Optional[np.ndarray] = None) -> GraphView:
        """The chosen clusters' cached member and halo sets as a dense
        view in the next ring slot; the same masks as
        :func:`cluster_view_recompute`."""
        g = self.g
        slot = self._next_slot()
        cache.compose(chosen, self._member, self._active)
        member, active = self._member, self._active
        slot.node[:] = active                    # (N,) bool -> (K, N) f32
        slot.edge[:] = active[g.src] & active[g.dst]
        train = self._train_mask(train)
        np.multiply(member, train, out=slot.loss, casting="unsafe")
        if not slot.loss.any():
            slot.loss[:] = member
        n_active = int(active.sum())
        return GraphView(g, self.K, "cluster", slot.node, slot.edge,
                         slot.loss,
                         {"clusters": [int(c) for c in chosen],
                          "members": int(member.sum()),
                          "active": n_active,
                          "active_nodes": n_active,
                          "active_edges": int(slot.edge[0].sum()),
                          "targets": int(slot.loss.sum())})

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

    def cluster_compact(self, chosen: np.ndarray, cache: ClusterViewCache,
                        train: Optional[np.ndarray] = None) -> CompactView:
        """The chosen clusters' cached halo sets as one compact view: edges
        are the in-edges of that set with both endpoints inside, and every
        hop offset is n (every node active in every layer)."""
        g, K = self.g, self.K
        stamp, g2l, tick = self._compact_scratch()
        members = np.unique(np.concatenate(
            [cache.members[c] for c in chosen])).astype(np.int64)
        nodes = (members if cache.halo_hops == 0 else np.unique(
            np.concatenate([cache.halo[c] for c in chosen])).astype(
                np.int64))
        self.builds += 1
        n = len(nodes)
        stamp[nodes] = tick
        g2l[nodes] = np.arange(n)
        eidx = stamped_in_edges(g, nodes, stamp, tick)
        src_local = g2l[g.src[eidx]].astype(np.int32)
        dst_local = g2l[g.dst[eidx]].astype(np.int32)
        sorter = np.argsort(dst_local, kind="stable")
        train = self._train_mask(train)
        labeled = members[train[members]]
        if len(labeled) == 0:
            labeled = members
        loss_local = np.zeros(n, np.float32)
        loss_local[g2l[labeled]] = 1.0
        return CompactView(
            g, K, "cluster", nodes, np.full(K + 1, n, np.int64),
            src_local[sorter], dst_local[sorter],
            eidx[sorter].astype(np.int64), loss_local,
            {"clusters": [int(c) for c in chosen],
             "members": int(len(members)), "active": n,
             "active_nodes": n, "active_edges": int(len(eidx)),
             "targets": int(len(labeled))})


class ViewStream:
    """An indexable stream of views: ``build(i)`` is a pure function of
    the index (view i draws from an RNG stream derived from ``(seed,
    i)``), so the stream position is one integer (``cursor``). Also a
    plain iterator: ``next`` builds at ``cursor``, advances it, and hands
    out views detached from the builder's scratch."""

    strategy = "?"
    compact = False   # mini and cluster streams set it per instance

    def __init__(self, g: Graph, K: int, seed: int = 0,
                 length: Optional[int] = None):
        self.g = g
        self.K = K
        self.seed = int(seed)
        self.length = length
        self.cursor = 0
        self._builder: Optional[ViewBuilder] = None

    def rng_for(self, i: int) -> np.random.Generator:
        """The order-stable per-view RNG stream."""
        return np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(int(i),)))

    def build(self, i: int, builder: Optional[ViewBuilder] = None):
        raise NotImplementedError

    def make_builder(self) -> Optional[ViewBuilder]:
        """A private ViewBuilder for one consumer (None for the static
        global view); a compact stream's owns no dense buffers."""
        return ViewBuilder(self.g, self.K, compact=self.compact)

    def seek(self, i: int) -> None:
        """Move the stream to view ``i`` (the cursor is the stream's whole
        state, so a checkpoint's cursor resumes it exactly)."""
        self.cursor = int(i)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self.length is not None and self.cursor >= self.length:
            raise StopIteration
        if self._builder is None:
            self._builder = self.make_builder()
        view = self.build(self.cursor, self._builder)
        self.cursor += 1
        if self._builder is not None:
            view = view.copy_masks()
        return view


class GlobalViewStream(ViewStream):
    """The static full-graph view: every index is the same object, so a
    trainer can recognise it and stage it once."""

    strategy = "global"

    def __init__(self, view: GraphView, length: Optional[int] = None):
        super().__init__(view.graph, view.K, seed=0, length=length)
        self._view = view

    def build(self, i: int, builder=None) -> GraphView:
        return self._view

    def make_builder(self) -> None:
        return None


class MiniBatchViewStream(ViewStream):
    """Random labeled targets + their K-hop view (dense, or compact with
    ``compact=True``), one independent RNG stream per index."""

    strategy = "mini"

    def __init__(self, g: Graph, K: int, batch_nodes: int = 0,
                 neighbor_cap: int = 0, seed: int = 0,
                 length: Optional[int] = None, compact: bool = False):
        super().__init__(g, K, seed=seed, length=length)
        self.compact = bool(compact)
        self.labeled = np.where(g.train_mask if g.train_mask is not None
                                else np.ones(g.num_nodes, bool))[0]
        if len(self.labeled) == 0:
            raise ValueError(
                "mini-batch views: the graph has no labeled nodes "
                "(train_mask selects nothing) to sample batch targets from")
        self.batch_nodes = batch_nodes or max(1, len(self.labeled) // 100)
        self.neighbor_cap = neighbor_cap

    def build(self, i: int, builder: Optional[ViewBuilder] = None):
        rng = self.rng_for(i)
        targets = rng.choice(self.labeled,
                             size=min(self.batch_nodes, len(self.labeled)),
                             replace=False)
        builder = builder or self.make_builder()
        if self.compact:
            return builder.khop_compact(targets, self.neighbor_cap, rng)
        return builder.khop_view(targets, self.neighbor_cap, rng)


class ClusterViewStream(ViewStream):
    """Random cluster picks composed from one shared (read-only)
    ClusterViewCache, one independent RNG stream per index."""

    strategy = "cluster"

    def __init__(self, g: Graph, K: int, clusters: np.ndarray,
                 clusters_per_batch: int = 0, halo_hops: int = 0,
                 seed: int = 0, length: Optional[int] = None,
                 compact: bool = False):
        super().__init__(g, K, seed=seed, length=length)
        self.compact = bool(compact)
        self.cache = ClusterViewCache(g, clusters, halo_hops)
        C = self.cache.num_clusters
        self.clusters_per_batch = min(
            clusters_per_batch or max(1, C // 100), C)
        self.train = (g.train_mask if g.train_mask is not None
                      else np.ones(g.num_nodes, bool))

    def build(self, i: int, builder: Optional[ViewBuilder] = None):
        rng = self.rng_for(i)
        chosen = rng.choice(self.cache.num_clusters,
                            size=self.clusters_per_batch, replace=False)
        builder = builder or self.make_builder()
        if self.compact:
            return builder.cluster_compact(chosen, self.cache, self.train)
        return builder.cluster_view(chosen, self.cache, self.train)
