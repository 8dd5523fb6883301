"""Distributed graph representation (paper §4.1), the counterpart of
``repro/core/partition.py``, held bit-identical to it.

Nodes are distributed evenly; each edge is assigned to one partition; a
node owned elsewhere but referenced locally becomes a **mirror** — a
placeholder holding *no values* (the paper's replica-factor-1 claim): the
halo exchange materializes a compact ``(n_mirror, d)`` buffer per layer,
synchronizing only the masters a layer actually uses.

Partitioning methods (§5.4):
- ``1d_src`` (default) — edge goes to the owner of its source node (master
  node and all its out-edges colocated: edge attributes/attention local).
- ``1d_dst`` — by destination owner.
- ``vertex_cut`` — 2D grid hash over (src, dst) (PowerGraph-style), which
  balances edges on skewed graphs at the cost of replication.

The exchange plan is dense numpy with static shapes: ``send_idx[p, q,
i]`` = local master slot on p of the i-th value p sends to q;
``recv_slot[q, p, i]`` = the mirror slot on q where it lands. The
engine (:mod:`repro_torch.core.engine`) executes it through a
communicator's ``all_to_all``.

The plans the kernels read are built once per partitioning and cached
here: one destination plan and one source plan per shard over its
``[masters ; mirrors]`` axis, one plan per shard over its ``send_idx``
(the halo's scatter-adds and the backward of its gathers), and the
plans over a run of shards side by side (:meth:`PartitionPlan.
local_plans`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.graph.csr import Graph
from repro_torch.kernels.plan import build_csc_plan, build_csc_plans_stacked
from repro_torch.utils import trace


def _round_up(x: int, m: int = 8) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclass
class PartitionPlan:
    P: int
    method: str
    owner: np.ndarray                 # (N,) int32 node -> partition
    masters: np.ndarray               # (P, n_m_pad) int32 global node ids
    master_mask: np.ndarray           # (P, n_m_pad) f32
    mirrors: np.ndarray               # (P, n_mir_pad) int32 global node ids
    mirror_mask: np.ndarray           # (P, n_mir_pad) f32
    src_local: np.ndarray             # (P, e_pad) int32 into [masters;mirrors]
    dst_local: np.ndarray             # (P, e_pad) int32
    edge_mask: np.ndarray             # (P, e_pad) f32
    edge_orig: np.ndarray             # (P, e_pad) int32 global edge ids
    send_idx: np.ndarray              # (P, P, s_pad) int32 master slots
    send_mask: np.ndarray             # (P, P, s_pad) f32
    recv_slot: np.ndarray             # (P, P, s_pad) int32 mirror slots
    recv_mask: np.ndarray             # (P, P, s_pad) f32
    # the kernels' plans, built once per partitioning: per shard by kind
    # ("dst", "src", "send"), and stacked by (kind, first shard, count)
    _csc_plans: dict = field(default_factory=dict, repr=False)
    # cached inverse maps (global id -> local slot), built on first use by
    # the compact shard path (shard_view over a CompactView scatters a few
    # thousand ids instead of gathering all N / all E per step)
    _locators: dict = field(default_factory=dict, repr=False)

    @property
    def n_m_pad(self) -> int:
        return int(self.masters.shape[1])

    @property
    def n_mir_pad(self) -> int:
        return int(self.mirrors.shape[1])

    @property
    def e_pad(self) -> int:
        return int(self.src_local.shape[1])

    @property
    def s_pad(self) -> int:
        return int(self.send_idx.shape[2])

    def _plan_ids(self, kind: str) -> tuple:
        """(ids (P, E), mask (P, E), segments) of the shards' plans of
        ``kind``."""
        if kind == "send":
            return (self.send_idx.reshape(self.P, -1),
                    self.send_mask.reshape(self.P, -1), self.n_m_pad)
        ids = self.dst_local if kind == "dst" else self.src_local
        return ids, self.edge_mask, self.n_m_pad + self.n_mir_pad

    def _shard_plans(self, kind: str) -> list:
        if kind not in self._csc_plans:
            self._csc_plans[kind] = build_csc_plans_stacked(
                *self._plan_ids(kind))
        return self._csc_plans[kind]

    def csc_plans(self) -> list:
        """One :class:`~repro_torch.kernels.plan.CSCPlan` per partition
        over its local destination ids (segments = the shard's ``[masters
        ; mirrors]`` axis; pad edges join no row), built once per
        partitioning and reused by every view (paper §4.2 reused
        indexing). The TPU's stacked lane-padded geometry is not kept."""
        return self._shard_plans("dst")

    def src_plans(self) -> list:
        """The same over each shard's source ids: the backward of the
        shard-local gather ``n[src]`` is a segment sum over it."""
        return self._shard_plans("src")

    def send_plans(self) -> list:
        """One plan per partition over its ``send_idx`` (segments = its
        master slots; pad entries join no row): the halo's reduce is a
        segment sum (or max) over it, and so is the backward of the
        broadcast's gather of master values."""
        return self._shard_plans("send")

    def local_plans(self, start: int, count: int) -> dict:
        """``{"dst", "src", "send"}``: for a process that holds shards
        ``start .. start + count - 1`` side by side, the plan over their
        ids offset so that shard ``l`` of the run owns rows ``l * N ..``
        (``N`` its plans' segment count); pad entries join no row. A
        row keeps its shard's edges in their order, and the kernels cut
        a row by its length alone, so a row's bits are its shard's.
        Cached; one shard's is its own plan."""
        out = {}
        for kind in ("dst", "src", "send"):
            key = (kind, start, count)
            if count == 1:
                out[kind] = self._shard_plans(kind)[start]
                continue
            if key not in self._csc_plans:
                ids, mask, n = self._plan_ids(kind)
                part = slice(start, start + count)
                off = np.arange(count, dtype=np.int64)[:, None] * n
                flat = np.where(mask[part] > 0, ids[part] + off, count * n)
                self._csc_plans[key] = build_csc_plan(flat.reshape(-1),
                                                      count * n)
            out[kind] = self._csc_plans[key]
        return out

    def node_locator(self) -> np.ndarray:
        """(N,) int64: master slot of each global node on its owner
        partition (``masters[owner[v], node_locator()[v]] == v``)."""
        if "node" not in self._locators:
            valid = self.master_mask > 0
            cols = np.broadcast_to(
                np.arange(self.n_m_pad, dtype=np.int64),
                self.masters.shape)
            slot = np.zeros(int(self.masters.max()) + 1, np.int64)
            slot[self.masters[valid].astype(np.int64)] = cols[valid]
            self._locators["node"] = slot
        return self._locators["node"]

    def edge_locator(self):
        """(part, slot): for each global edge id, its partition and edge
        slot there (``edge_orig[part[e], slot[e]] == e``)."""
        if "edge" not in self._locators:
            valid = self.edge_mask > 0
            M = int(self.edge_orig[valid].max()) + 1 if valid.any() else 1
            part = np.zeros(M, np.int64)
            slot = np.zeros(M, np.int64)
            rows = np.broadcast_to(
                np.arange(self.P, dtype=np.int64)[:, None],
                self.edge_orig.shape)
            cols = np.broadcast_to(
                np.arange(self.e_pad, dtype=np.int64),
                self.edge_orig.shape)
            ids = self.edge_orig[valid].astype(np.int64)
            part[ids] = rows[valid]
            slot[ids] = cols[valid]
            self._locators["edge"] = (part, slot)
        return self._locators["edge"]


@dataclass
class ShardedGraph:
    """Per-partition node/edge data, stacked over the partition axis."""
    plan: PartitionPlan
    x: np.ndarray                     # (P, n_m_pad, F)
    y: np.ndarray                     # (P, n_m_pad) int32
    edge_weight: np.ndarray           # (P, e_pad) f32
    edge_attr: Optional[np.ndarray]   # (P, e_pad, Fe) or None
    feature_dim: int


def build_partitions(g: Graph, P: int, method: str = "1d_src",
                     seed: int = 0, gcn_norm: bool = True
                     ) -> ShardedGraph:
    """Partition ``g`` into ``P`` shards, as the reference does: the same
    owners, masters, mirrors, local edges and exchange plan, bit for bit.
    The reference's per-node dictionaries are array lookups here. The
    plan is a ``plan.build`` span (:mod:`repro_torch.utils.trace`); the
    node and edge data sliced per partition after it are not."""
    with trace.span("plan.build"):
        plan, edges_l = _partition_plan(g, P, method, seed)
    return _slice_data(g, plan, edges_l, gcn_norm)


def _partition_plan(g: Graph, P: int, method: str, seed: int):
    """The :class:`PartitionPlan`, and each partition's edge ids."""
    rng = np.random.default_rng(seed)
    N = g.num_nodes

    # ---- master assignment: even split of a shuffled permutation ----------
    perm = rng.permutation(N)
    owner = np.empty(N, np.int32)
    owner[perm] = np.arange(N) % P

    # ---- edge assignment ----------------------------------------------------
    if method == "1d_src":
        e_part = owner[g.src]
    elif method == "1d_dst":
        e_part = owner[g.dst]
    elif method == "vertex_cut":
        r = int(np.floor(np.sqrt(P)))
        while P % r:
            r -= 1
        c = P // r
        hs = (g.src.astype(np.int64) * 2654435761 % (1 << 31)) % r
        hd = (g.dst.astype(np.int64) * 40503 % (1 << 31)) % c
        e_part = (hs * c + hd).astype(np.int32)
    else:
        raise ValueError(f"unknown partition method {method!r}")

    # ---- per-partition locals ----------------------------------------------
    masters_l, mirrors_l, edges_l = [], [], []
    for p in range(P):
        m_nodes = np.where(owner == p)[0].astype(np.int64)
        eids = np.where(e_part == p)[0].astype(np.int64)
        endpoints = np.unique(np.concatenate([g.src[eids], g.dst[eids]]))
        mir = endpoints[owner[endpoints] != p]
        masters_l.append(m_nodes)
        mirrors_l.append(np.sort(mir))
        edges_l.append(eids)

    n_m_pad = _round_up(max(len(m) for m in masters_l))
    n_mir_pad = _round_up(max((len(m) for m in mirrors_l), default=1))
    e_pad = _round_up(max(len(e) for e in edges_l))

    masters = np.zeros((P, n_m_pad), np.int32)
    master_mask = np.zeros((P, n_m_pad), np.float32)
    mirrors = np.zeros((P, n_mir_pad), np.int32)
    mirror_mask = np.zeros((P, n_mir_pad), np.float32)
    src_local = np.zeros((P, e_pad), np.int32)
    dst_local = np.zeros((P, e_pad), np.int32)
    edge_mask = np.zeros((P, e_pad), np.float32)
    edge_orig = np.zeros((P, e_pad), np.int32)

    # a node's master slot on its owner (each node has one owner)
    master_slot = np.zeros(N, np.int64)
    for p in range(P):
        ml, rl = masters_l[p], mirrors_l[p]
        masters[p, :len(ml)] = ml
        master_mask[p, :len(ml)] = 1.0
        mirrors[p, :len(rl)] = rl
        mirror_mask[p, :len(rl)] = 1.0
        master_slot[ml] = np.arange(len(ml))
        eids = edges_l[p]
        loc = np.empty(N, np.int64)   # scratch local index map for p
        loc[ml] = np.arange(len(ml))
        loc[rl] = n_m_pad + np.arange(len(rl))
        src_local[p, :len(eids)] = loc[g.src[eids]]
        dst_local[p, :len(eids)] = loc[g.dst[eids]]
        edge_mask[p, :len(eids)] = 1.0
        edge_orig[p, :len(eids)] = eids

    # ---- exchange plan: owner p -> mirror holder q --------------------------
    # pair (p, q) sends q's mirrors owned by p, in q's (sorted) mirror
    # order; a mirror's slot on q is its position among q's mirrors
    pairs = {}
    for q in range(P):
        ow = owner[mirrors_l[q]]
        for p in np.unique(ow):
            pairs[(int(p), q)] = np.flatnonzero(ow == p)
    s_pad = _round_up(max((len(v) for v in pairs.values()), default=1))
    send_idx = np.zeros((P, P, s_pad), np.int32)
    send_mask = np.zeros((P, P, s_pad), np.float32)
    recv_slot = np.zeros((P, P, s_pad), np.int32)
    recv_mask = np.zeros((P, P, s_pad), np.float32)
    for (p, q), slots in pairs.items():
        k = len(slots)
        send_idx[p, q, :k] = master_slot[mirrors_l[q][slots]]
        send_mask[p, q, :k] = 1.0
        recv_slot[q, p, :k] = slots
        recv_mask[q, p, :k] = 1.0

    plan = PartitionPlan(P, method, owner, masters, master_mask, mirrors,
                         mirror_mask, src_local, dst_local, edge_mask,
                         edge_orig, send_idx, send_mask, recv_slot, recv_mask)
    return plan, edges_l


def _slice_data(g: Graph, plan: PartitionPlan, edges_l: list,
                gcn_norm: bool) -> ShardedGraph:
    """The node and edge data sliced per partition of ``plan``."""
    P, M = plan.P, g.num_edges
    masters, master_mask = plan.masters, plan.master_mask
    n_m_pad, e_pad = masters.shape[1], plan.edge_mask.shape[1]
    F = g.node_features.shape[1]
    x = np.zeros((P, n_m_pad, F), np.float32)
    y = np.zeros((P, n_m_pad), np.int32)
    for p in range(P):
        x[p] = g.node_features[masters[p]] * master_mask[p][:, None]
        y[p] = g.labels[masters[p]] * master_mask[p].astype(np.int32)
    ew = np.zeros((P, e_pad), np.float32)
    norm = g.gcn_norm() if gcn_norm else (
        g.edge_weights if g.edge_weights is not None
        else np.ones(M, np.float32))
    ea = None
    if g.edge_features is not None:
        ea = np.zeros((P, e_pad, g.edge_features.shape[1]), np.float32)
    for p in range(P):
        k = int(plan.edge_mask[p].sum())
        eids = edges_l[p]
        ew[p, :k] = norm[eids]
        if ea is not None:
            ea[p, :k] = g.edge_features[eids]
    return ShardedGraph(plan, x, y, ew, ea, F)


def partition_stats(sg: ShardedGraph) -> dict:
    """Metrics the paper reports for partitioning methods (Fig. 10, §4.1)."""
    plan = sg.plan
    n_masters = plan.master_mask.sum(axis=1)
    n_mirrors = plan.mirror_mask.sum(axis=1)
    n_edges = plan.edge_mask.sum(axis=1)
    comm = plan.send_mask.sum()          # values moved per broadcast phase
    total_nodes = float(n_masters.sum())
    return {
        "method": plan.method,
        "P": plan.P,
        "replica_factor": float((n_masters.sum() + n_mirrors.sum())
                                / max(total_nodes, 1)),
        "edge_balance": float(n_edges.max() / max(n_edges.mean(), 1e-9)),
        "master_balance": float(n_masters.max()
                                / max(n_masters.mean(), 1e-9)),
        "halo_values_per_sync": float(comm),
        "mirrors_total": float(n_mirrors.sum()),
        "edges_per_part_max": float(n_edges.max()),
        "memory_per_part_nodes": float(n_masters.max() + n_mirrors.max()),
    }


__all__ = ["PartitionPlan", "ShardedGraph", "build_partitions",
           "partition_stats"]
