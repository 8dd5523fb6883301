"""Graph storage: the host-side global graph and the tensor GraphBlock.

``Graph`` is the host numpy store (CSR for outgoing and CSC for incoming
edges, paper §4.1), the same as the reference's. ``GraphBlock`` is the
padded view one forward pass consumes, held as torch tensors; ``to``
moves it, and its plan, to a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.plan import CSCPlan, build_csc_plan


@dataclass
class Graph:
    """Global directed graph. For undirected inputs both directions exist."""
    src: np.ndarray                  # (M,) int32
    dst: np.ndarray                  # (M,) int32
    num_nodes: int
    node_features: np.ndarray        # (N, F) float32
    labels: np.ndarray               # (N,)  int32
    edge_features: Optional[np.ndarray] = None   # (M, Fe) float32
    edge_weights: Optional[np.ndarray] = None    # (M,)  float32
    train_mask: Optional[np.ndarray] = None      # (N,) bool
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    name: str = "graph"
    _csr: Optional[tuple] = field(default=None, repr=False)
    _csc: Optional[tuple] = field(default=None, repr=False)
    # plans keyed by the padded segment count, built once per graph
    _csc_plans: dict = field(default_factory=dict, repr=False)
    _gcn_norm: Optional[np.ndarray] = field(default=None, repr=False)
    _base_blocks: dict = field(default_factory=dict, repr=False)

    @property
    def num_edges(self) -> int:
        return int(len(self.src))

    def csr(self):
        """(indptr, order) such that edges order[indptr[u]:indptr[u+1]]
        have src == u."""
        if self._csr is None:
            order = np.argsort(self.src, kind="stable").astype(np.int32)
            counts = np.bincount(self.src, minlength=self.num_nodes)
            indptr = np.zeros(self.num_nodes + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            self._csr = (indptr, order)
        return self._csr

    def csc(self):
        if self._csc is None:
            order = np.argsort(self.dst, kind="stable").astype(np.int32)
            counts = np.bincount(self.dst, minlength=self.num_nodes)
            indptr = np.zeros(self.num_nodes + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            self._csc = (indptr, order)
        return self._csc

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_nodes)

    def gcn_norm(self) -> np.ndarray:
        """Per-edge symmetric GCN normalization 1/sqrt(d_i d_j) with
        self-loop-augmented degrees, cached."""
        if self._gcn_norm is None:
            deg = self.in_degree().astype(np.float64) + 1.0
            self._gcn_norm = (
                1.0 / np.sqrt(deg[self.src] * deg[self.dst])).astype(
                np.float32)
        return self._gcn_norm

    def csc_plan(self, pad_nodes: int = 0, pad_edges: int = 0) -> CSCPlan:
        """Cached plan over the (padded) destination ids, shared by every
        whole-graph block of this graph (paper §4.2's reused indexing)."""
        n_pad = max(pad_nodes, self.num_nodes)
        e_pad = max(pad_edges, self.num_edges)
        key = (n_pad, e_pad)
        if key not in self._csc_plans:
            ids = np.full(e_pad, n_pad, np.int32)
            ids[: self.num_edges] = self.dst
            self._csc_plans[key] = build_csc_plan(ids, n_pad)
        return self._csc_plans[key]

    def add_self_loops(self) -> "Graph":
        loops = np.arange(self.num_nodes, dtype=np.int32)
        src = np.concatenate([self.src, loops])
        dst = np.concatenate([self.dst, loops])
        ef = None
        if self.edge_features is not None:
            ef = np.concatenate(
                [self.edge_features,
                 np.zeros((self.num_nodes, self.edge_features.shape[1]),
                          self.edge_features.dtype)])
        ew = None
        if self.edge_weights is not None:
            ew = np.concatenate(
                [self.edge_weights, np.ones(self.num_nodes, np.float32)])
        return Graph(src.astype(np.int32), dst.astype(np.int32),
                     self.num_nodes, self.node_features, self.labels,
                     ef, ew, self.train_mask, self.val_mask, self.test_mask,
                     self.name + "+loops")


@dataclass
class GraphBlock:
    """Fixed-shape padded view. All tensors are padded; masks mark
    validity. ``src``/``dst`` index the node axis of ``x``."""
    src: torch.Tensor               # (E_pad,) int32
    dst: torch.Tensor               # (E_pad,) int32
    edge_mask: torch.Tensor         # (E_pad,) f32 1=valid
    node_mask: torch.Tensor         # (N_pad,) f32 1=valid
    x: torch.Tensor                 # (N_pad, F)
    y: torch.Tensor                 # (N_pad,) int32
    loss_mask: torch.Tensor         # (N_pad,) f32
    edge_weight: torch.Tensor       # (E_pad,) f32 (GCN norm; 1s else)
    edge_attr: Optional[torch.Tensor] = None      # (E_pad, Fe)
    # per-layer active sets (paper §4.2); (K, N_pad) / (K, E_pad);
    # None = all valid entries active
    node_active: Optional[torch.Tensor] = None
    edge_active: Optional[torch.Tensor] = None
    # plan for the "csc" aggregation backend
    csc_plan: Optional[CSCPlan] = None

    @property
    def num_nodes_padded(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])

    def to(self, device, copy: bool = False) -> "GraphBlock":
        """The block on ``device``. ``copy=True`` detaches it from the
        arrays it was built on (a staged block aliases ring buffers that
        the next stage overwrites)."""
        moved = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is not None:
                moved[f.name] = v.to(device, copy=copy)
        return replace(self, **moved)


def _t(a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(a)


def block_from_arrays(src, dst, edge_mask, node_mask, x, y, loss_mask,
                      edge_weight, edge_attr=None, node_active=None,
                      edge_active=None, csc_plan=None) -> GraphBlock:
    """A GraphBlock over numpy arrays, sharing their memory."""
    return GraphBlock(_t(src), _t(dst), _t(edge_mask), _t(node_mask), _t(x),
                      _t(y), _t(loss_mask), _t(edge_weight), _t(edge_attr),
                      _t(node_active), _t(edge_active), csc_plan)


def build_block(g: Graph, pad_nodes: int = 0, pad_edges: int = 0,
                loss_mask: Optional[np.ndarray] = None,
                gcn_norm: bool = True,
                csc_plan: bool = False) -> GraphBlock:
    """Whole-graph block. ``csc_plan=True`` attaches the graph's cached
    plan so the "csc" aggregation backend can run."""
    n, m = g.num_nodes, g.num_edges
    n_pad = max(pad_nodes, n)
    e_pad = max(pad_edges, m)
    src = np.zeros(e_pad, np.int32)
    dst = np.zeros(e_pad, np.int32)
    emask = np.zeros(e_pad, np.float32)
    src[:m], dst[:m], emask[:m] = g.src, g.dst, 1.0
    nmask = np.zeros(n_pad, np.float32)
    nmask[:n] = 1.0
    x = np.zeros((n_pad, g.node_features.shape[1]), np.float32)
    x[:n] = g.node_features
    y = np.zeros(n_pad, np.int32)
    y[:n] = g.labels
    lm = np.zeros(n_pad, np.float32)
    if loss_mask is None:
        loss_mask = (g.train_mask if g.train_mask is not None
                     else np.ones(n, bool))
    lm[:n] = loss_mask.astype(np.float32)
    ew = np.zeros(e_pad, np.float32)
    ew[:m] = g.gcn_norm() if gcn_norm else (
        g.edge_weights if g.edge_weights is not None else 1.0)
    ea = None
    if g.edge_features is not None:
        ea = np.zeros((e_pad, g.edge_features.shape[1]), np.float32)
        ea[:m] = g.edge_features
    plan = g.csc_plan(n_pad, e_pad) if csc_plan else None
    return block_from_arrays(src, dst, emask, nmask, x, y, lm, ew, ea,
                             csc_plan=plan)


def base_block(g: Graph, gcn_norm: bool = True,
               csc_plan: bool = False) -> GraphBlock:
    """The whole-graph block, cached per ``(gcn_norm, csc_plan)``.
    Callers treat its tensors as read-only."""
    key = (bool(gcn_norm), bool(csc_plan))
    if key not in g._base_blocks:
        g._base_blocks[key] = build_block(g, gcn_norm=gcn_norm,
                                          csc_plan=csc_plan)
    return g._base_blocks[key]
