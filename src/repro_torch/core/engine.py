"""Hybrid-parallel distributed training engine (paper §1/§4.3), the
counterpart of ``repro/core/engine.py``.

Conventional GNN data-parallelism gives each worker a whole subgraph; the
paper instead computes **each batch by a group of workers jointly**: node
and edge tensors are partition-sharded, parameters are replicated, and each
NN-TGAR stage runs as a local compute plus a master/mirror halo exchange.
The worker group is a communicator (:mod:`repro_torch.core.comm`): the
halo exchange is its ``all_to_all`` over the partition plan's static
send buffers, and the gradients of the replicated parameters are summed
by its ``all_reduce_grads`` — the paper's NN-Reduce.

Communication matches §4.1: a value moves only master→mirror (broadcast
phase) and partial aggregates move mirror→master (reduce phase); traffic is
O(#mirrors) per layer, not O(edges) — the paper's "local message bombing"
fix. Attention models (softmax combine) add a max- and a sum-reduce pass —
the distributed segment-softmax.

A process holds a run of ``L`` partitions (all ``P`` under
:class:`~repro_torch.core.comm.LocalComm`, one under
:class:`~repro_torch.core.comm.ProcessGroupComm`) side by side: shard
``l``'s masters are rows ``l * n_m_pad ..`` of the node arrays, its
``[masters ; mirrors]`` rows ``l * (n_m_pad + n_mir_pad) ..`` of the
shard-local axis and its edges ``l * e_pad ..`` of the edge axis. The
Sum stage runs over the block-diagonal stack of the shards' plans
(:meth:`~repro_torch.core.partition.PartitionPlan.local_plans`), so the
``L`` shards take one launch per kernel, and a row's bits are its
shard's (the kernels cut rows from the row's start).

No scatter here is atomic, so a step is the same bits on every run:

- the broadcast's gather of master values and the reduce's sum into
  them are a planned gather and a ``segment_sum`` over the shard's plan
  on ``send_idx`` (one the other's backward); the reduce's max is
  ``segment_max`` over it;
- valid ``recv_slot`` entries are unique, so moving values between the
  received buffer and the mirror slots is a copy both ways
  (:class:`_SlotCopy`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.aggregate import (NEG, ShardContext, _CSCSegmentMax,
                                        _CSCSegmentSum, combine,
                                        get_backend, take)
from repro_torch.core.comm import Comm, default_comm
from repro_torch.core.partition import ShardedGraph
from repro_torch.core.tgar import TGARLayer, tree_take
from repro_torch.device import resolve_device
from repro_torch.kernels.plan import CSCPlan

VIEW_KEYS = ("node_active", "edge_active", "loss_mask")


# ---------------------------------------------------------------------------
# halo exchange primitives
# ---------------------------------------------------------------------------


class _SlotCopy(torch.autograd.Function):
    """``out[i] = x[take[i]] * take_mask[i]`` where ``back`` inverts
    ``take`` on the valid rows (``take[back[j]] == j`` where
    ``back_mask[j]``, and the other way round): a copy between the
    received buffer and the mirror slots, whose backward is the copy back
    (no scatter, so no atomics)."""

    @staticmethod
    def forward(ctx, x, take_idx, take_mask, back_idx, back_mask):
        ctx.save_for_backward(back_idx, back_mask)
        return x.index_select(0, take_idx) * take_mask[:, None]

    @staticmethod
    def backward(ctx, g):
        back_idx, back_mask = ctx.saved_tensors
        return (g.index_select(0, back_idx) * back_mask[:, None],
                None, None, None, None)


def _flat(arr: torch.Tensor) -> torch.Tensor:
    return arr.reshape(arr.shape[0], math.prod(arr.shape[1:]))


def _bcast_array(arr, shard: "Shard", comm: Comm):
    """Master values (L * n_m_pad, ...) -> mirror buffer (L * n_mir_pad,
    ...)."""
    flat = _flat(arr)
    buf = take(flat, shard.send_ids, shard.send_plan) \
        * shard.send_mask[:, None]                     # (L * P * s_pad, D)
    got = comm.all_to_all(buf.reshape(shard.L, comm.P, -1, flat.shape[1]))
    mir = _SlotCopy.apply(got.reshape(-1, flat.shape[1]), shard.mirror_take,
                          shard.mirror_mask, shard.recv_take,
                          shard.recv_mask)
    return mir.reshape((-1,) + tuple(arr.shape[1:]))


def _reduce_array(mir, shard: "Shard", comm: Comm, op: str = "sum"):
    """Mirror partials (L * n_mir_pad, ...) -> master accumulation (L *
    n_m_pad, ...). ``op="max"``: a master's max over the partials its
    mirror holders sent, NEG where none did (``segment_max`` over the
    send plan). Where several holders' partials tie, each takes the
    master's full cotangent (the ``csc`` kernels' rule, ROADMAP C.1 and
    C.20; the reference's scatter-max averages them)."""
    flat = _flat(mir)
    D = flat.shape[1]
    buf = _SlotCopy.apply(flat, shard.recv_take, shard.recv_mask,
                          shard.mirror_take, shard.mirror_mask)
    if op == "max":
        buf = torch.where(shard.recv_mask[:, None] > 0, buf,
                          torch.full_like(buf, NEG))
    got = comm.all_to_all(buf.reshape(shard.L, comm.P, -1, D))
    got = got.reshape(-1, D)                       # rows by mirror holder
    if op == "sum":
        out = _CSCSegmentSum.apply(got * shard.send_mask[:, None],
                                   shard.send_plan)
    elif op == "max":
        got = torch.where(shard.send_mask[:, None] > 0, got,
                          torch.full_like(got, NEG))
        out = _CSCSegmentMax.apply(got, shard.send_plan)
    else:
        raise ValueError(f"unknown halo reduce {op!r}")
    return out.reshape((-1,) + tuple(mir.shape[1:]))


def _bcast_tree(tree, shard: "Shard", comm: Comm):
    return {k: _bcast_array(v, shard, comm) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# distributed TGAR layer forward
# ---------------------------------------------------------------------------


@dataclass
class Shard:
    """A process's ``L`` shards on its device, side by side (see the
    module docstring), and the view's masks for them."""
    L: int
    n_m_pad: int
    n_mir_pad: int
    x: torch.Tensor               # (L * n_m_pad, F)
    y: torch.Tensor               # (L * n_m_pad,) int64
    master_mask: torch.Tensor     # (L * n_m_pad,)
    src: torch.Tensor             # (L * e_pad,) int32, shard-local rows
    dst: torch.Tensor             # (L * e_pad,) int32
    edge_mask: torch.Tensor       # (L * e_pad,)
    edge_weight: torch.Tensor     # (L * e_pad,)
    edge_attr: Optional[torch.Tensor]
    dst_plan: CSCPlan
    src_plan: CSCPlan
    send_plan: CSCPlan            # over send_ids: rows = master slots
    send_ids: torch.Tensor        # (L * P * s_pad,) int32 master rows
    send_mask: torch.Tensor       # (L * P * s_pad,)
    recv_take: torch.Tensor       # (L * P * s_pad,) int32 mirror rows
    recv_mask: torch.Tensor       # (L * P * s_pad,)
    mirror_take: torch.Tensor     # (L * n_mir_pad,) int32 received rows
    mirror_mask: torch.Tensor     # (L * n_mir_pad,)
    # the view: (L, K, n_m_pad), (L, K, e_pad), (L, n_m_pad)
    node_active: Optional[torch.Tensor] = None
    edge_active: Optional[torch.Tensor] = None
    loss_mask: Optional[torch.Tensor] = None

    @property
    def n_tot(self) -> int:
        return self.n_m_pad + self.n_mir_pad


def _layer_forward_sharded(layer: TGARLayer, h, shard: Shard, k: int,
                           comm: Comm, backend=None):
    """One TGAR layer over a process's shards: NN-T on the masters, their
    values broadcast to the mirrors (one value per mirror per layer),
    NN-G on the local edges, the Sum stage's shard-local partials
    finalized through the halo, NN-A."""
    em = shard.edge_mask * shard.edge_active[:, k].reshape(-1)
    ctx = ShardContext(
        n_master=shard.n_m_pad, n_mirror=shard.n_mir_pad,
        reduce=lambda arr, op: _reduce_array(arr, shard, comm, op),
        bcast=lambda arr: _bcast_array(arr, shard, comm))

    n = layer.transform(h)                                 # NN-T
    n_mir = _bcast_tree(n, shard, comm)
    n_all = {key: ctx.join(n[key], n_mir[key]) for key in n}
    n_src = tree_take(n_all, shard.src, shard.src_plan)
    n_dst = tree_take(n_all, shard.dst, shard.dst_plan)
    msg = layer.gather(n_src, n_dst, shard.edge_attr, shard.edge_weight,
                       em)                                 # NN-G
    M = combine(layer.combine, msg, shard.dst, shard.L * shard.n_tot, em,
                backend=backend, plan=shard.dst_plan, shard=ctx)  # Sum
    h_next = layer.node_apply(h, M)                        # NN-A
    h_next = h_next * shard.node_active[:, k].reshape(-1)[:, None]
    return h_next * shard.master_mask[:, None]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class HybridParallelEngine:
    """Runs an :class:`~repro_torch.core.mpgnn.MPGNNModel` over a
    partitioned graph with a worker group.

    ``comm`` is the group (default: a :class:`~repro_torch.core.comm.
    LocalComm` of ``plan.P`` partitions in this process); the process's
    shards go to ``device`` (the card unless the caller asks for the
    CPU), with the model. The same engine serves training
    (``make_train_step``) and inference (``make_infer``) — the paper's
    unified implementation. ``backend`` selects the Sum-stage backend
    (default: the model's); the shards' plans are built once per
    partitioning and staged once — the paper's reused CSC indexing.

    The replicated parameters are the model's own; the engine's functions
    read them and write their gradients to ``.grad``.
    """

    def __init__(self, model, sharded: ShardedGraph,
                 comm: Optional[Comm] = None, backend=None, device=None):
        self.sg = sharded
        self.plan = sharded.plan
        self.comm = default_comm(self.plan.P, comm)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if backend is None:
            backend = getattr(model, "aggregate_backend", "csc")
        self.backend = get_backend(backend)
        self._device_data = self._stage()

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    # -- data staging ---------------------------------------------------------

    def _stage(self) -> Shard:
        """The process's shards on the device, once per engine."""
        plan, sg, comm = self.plan, self.sg, self.comm
        a, L = comm.start, comm.count
        part = slice(a, a + L)
        n_m, n_mir, n_tot = plan.n_m_pad, plan.n_mir_pad, \
            plan.n_m_pad + plan.n_mir_pad
        off = np.arange(L, dtype=np.int64)[:, None]

        send_ids = plan.send_idx[part].reshape(L, -1) + off * n_m
        recv_take = plan.recv_slot[part].reshape(L, -1) + off * n_mir
        recv_mask = plan.recv_mask[part].reshape(L, -1)
        # mirror slot -> the received entry that fills it
        mirror_take = np.zeros(L * n_mir, np.int64)
        valid = recv_mask > 0
        mirror_take[recv_take[valid]] = np.flatnonzero(valid.reshape(-1))
        plans = plan.local_plans(a, L)

        def t(x, dtype=None):
            x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(self.device, dtype=dtype, copy=True)

        ea = None
        if sg.edge_attr is not None:
            ea = t(sg.edge_attr[part].reshape(L * plan.e_pad, -1))
        return Shard(
            L=L, n_m_pad=n_m, n_mir_pad=n_mir,
            x=t(sg.x[part].reshape(L * n_m, -1)),
            y=t(sg.y[part].reshape(-1), torch.int64),
            master_mask=t(plan.master_mask[part].reshape(-1)),
            src=t((plan.src_local[part] + off * n_tot).reshape(-1),
                  torch.int32),
            dst=t((plan.dst_local[part] + off * n_tot).reshape(-1),
                  torch.int32),
            edge_mask=t(plan.edge_mask[part].reshape(-1)),
            edge_weight=t(sg.edge_weight[part].reshape(-1)),
            edge_attr=ea,
            dst_plan=plans["dst"].to(self.device, copy=True),
            src_plan=plans["src"].to(self.device, copy=True),
            send_plan=plans["send"].to(self.device, copy=True),
            send_ids=t(send_ids.reshape(-1), torch.int32),
            send_mask=t(plan.send_mask[part].reshape(-1)),
            recv_take=t(recv_take.reshape(-1), torch.int32),
            recv_mask=t(recv_mask.reshape(-1)),
            mirror_take=t(mirror_take, torch.int32),
            mirror_mask=t(plan.mirror_mask[part].reshape(-1)))

    def stage_view(self, view_arrays: dict, retry=None) -> dict:
        """The process's rows of sharded view arrays (from
        :func:`~repro_torch.core.strategies.shard_view`) on the device.
        With a :class:`~repro_torch.runtime.faults.Retrier` the copy is a
        retryable ``device_put`` stage: the host arrays are unchanged by
        a failed copy, so a transient failure re-stages the same view."""
        a, L = self.comm.start, self.comm.count

        def put():
            return {k: torch.from_numpy(np.ascontiguousarray(
                view_arrays[k][a:a + L])).to(self.device, copy=True)
                for k in VIEW_KEYS}

        if retry is None:
            return put()
        return retry("device_put", put)

    def default_view_arrays(self) -> dict:
        plan = self.plan
        K = self.model.K
        return {
            "node_active": np.broadcast_to(
                plan.master_mask[:, None, :],
                (plan.P, K, plan.n_m_pad)).copy(),
            "edge_active": np.broadcast_to(
                plan.edge_mask[:, None, :],
                (plan.P, K, plan.e_pad)).copy(),
            "loss_mask": plan.master_mask.copy(),
        }

    # -- shard-local forward --------------------------------------------------

    def _local_shard(self, data: Shard, view: dict) -> Shard:
        """The staged shards with the view's masks attached."""
        out = Shard(**{f.name: getattr(data, f.name)
                       for f in fields(Shard)})
        out.node_active = view["node_active"]
        out.edge_active = view["edge_active"]
        out.loss_mask = view["loss_mask"]
        return out

    def _forward_local(self, shard: Shard) -> torch.Tensor:
        h = shard.x
        for k, layer in enumerate(self.model.layers):
            h = _layer_forward_sharded(layer, h, shard, k, self.comm,
                                       backend=self.backend)
        return self.model.decode(h)

    def _local_objective(self, shard: Shard):
        """(the process's objective, its partitions' loss terms (L,)):
        each partition's local loss sum over the global target count;
        the gradients of the process's objective, summed over the group
        (``all_reduce_grads``), are the loss's (the paper's
        NN-Reduce)."""
        logits = self._forward_local(shard)
        lm = shard.loss_mask.reshape(-1) * shard.master_mask
        logits32 = logits.float()
        logz = torch.logsumexp(logits32, dim=-1)
        ll = logits32.gather(1, shard.y[:, None])[:, 0]
        nll = (logz - ll) * lm
        local_sum = nll.reshape(shard.L, -1).sum(1)
        count = lm.reshape(shard.L, -1).sum(1)
        total = self.comm.all_reduce(count)
        terms = local_sum / torch.clamp_min(total, 1.0)
        obj = terms[0]
        for term in terms[1:]:        # rank order
            obj = obj + term
        return obj, terms

    def _loss_and_grad(self, view: dict):
        """Loss and summed gradients over a staged view; the gradients
        are also left in each parameter's ``.grad``."""
        self.model.zero_grad(set_to_none=True)
        obj, terms = self._local_objective(
            self._local_shard(self._device_data, view))
        obj.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.model.named_parameters()}
        self.comm.all_reduce_grads(grads)
        return self.comm.all_reduce(terms.detach()), grads

    # -- public API -----------------------------------------------------------

    def make_loss_and_grad(self) -> Callable:
        """``fn(view) -> (loss, grads)`` over a staged view
        (:meth:`stage_view`): the global loss (0-d, on the device) and the
        gradients summed over the group, by parameter name."""
        return self._loss_and_grad

    def make_train_step(self, opt) -> Callable:
        """``run(opt_state, view_arrays) -> loss``: stage the view, take
        one step and update the model's parameters (and ``opt_state``)
        in place."""
        def run(opt_state, view_arrays):
            loss, grads = self._loss_and_grad(self.stage_view(view_arrays))
            opt.update(grads, opt_state, self.params)
            return loss

        return run

    def make_infer(self) -> Callable:
        """``fn(view_arrays) -> (P, n_m_pad, C)`` logits aligned with
        ``plan.masters`` (every partition's, gathered from the group)."""
        def fn(view_arrays):
            shard = self._local_shard(self._device_data,
                                      self.stage_view(view_arrays))
            with torch.no_grad():
                logits = self._forward_local(shard)
            return self.comm.all_gather(
                logits.reshape(shard.L, shard.n_m_pad, -1))

        return fn

    def gather_predictions(self, logits_sharded) -> np.ndarray:
        """(P, n_m_pad, C) -> (N, C) in global node order: one masked
        scatter over all partitions (valid master slots land on their
        global node row; padding slots drop out with the mask)."""
        plan = self.plan
        lg = (logits_sharded.detach().cpu().numpy()
              if isinstance(logits_sharded, torch.Tensor)
              else np.asarray(logits_sharded))
        out = np.zeros((len(plan.owner), lg.shape[-1]), np.float32)
        valid = plan.master_mask > 0                      # (P, n_m_pad)
        out[plan.masters[valid]] = lg[valid]
        return out


__all__ = ["HybridParallelEngine", "Shard", "VIEW_KEYS"]
