"""NN-TGAR: the paper's graph-learning compute pattern (§3).

One GNN encoding layer = NN-Transform -> NN-Gather -> Sum -> NN-Apply.
A :class:`TGARLayer` is an ``nn.Module`` that owns its parameters and
implements the three neural stages; the Sum stage is
:func:`repro_torch.core.aggregate.combine`, chosen by ``combine``.

The Sum stage's public segment primitives (``segment_sum``,
``segment_mean``, ``segment_max``, ``segment_softmax``) take raw segment
ids, as ``repro/core/tgar.py``'s do, and give ``jax.ops.segment_*``'s
results: ids outside ``[0, num_segments)``, negative ones included, are
dropped (no output, zero gradient), and an empty segment's max is -inf.
On CPU tensors they are the plain segment math of
:class:`~repro_torch.core.aggregate.ReferenceBackend`. On CUDA tensors
each call builds a :class:`~repro_torch.kernels.plan.CSCPlan` from the
ids (dropped ids become pad edges, which join no row) and runs the
hand-written kernels: ``segment_sum`` forward with the ``segment_sum_bwd``
gather as its backward, ``segment_max`` forward, and ``edge_softmax``
with ``edge_softmax_bwd``; never an atomic ``index_add_`` or
``scatter_reduce_``, and never a plain fallback (an input the kernels
refuse raises). The plan is built on the host at every call; a caller
that reuses one graph keeps its plan and calls
:func:`repro_torch.core.aggregate.combine` with the ``csc`` backend.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import aggregate as agg
from repro_torch.core.aggregate import _PlannedGather  # noqa: F401
from repro_torch.graph.csr import GraphBlock
from repro_torch.kernels import ops
from repro_torch.kernels.plan import CSCPlan, build_csc_plan
from repro_torch.kernels.ref import NEG

_REFERENCE = agg.ReferenceBackend()


# -- the Sum stage's segment primitives ---------------------------------------


class _Planned(NamedTuple):
    """A call's segment ids as the kernels take them: the plan over the
    ids, the dropped ones mapped to pad edges, and ``kept`` (E,) bool,
    or None when no id was dropped. Its methods are the plan-order
    wrappers (:mod:`repro_torch.kernels.ops`) that ``_SegmentMaxSplit``
    is written against."""
    plan: CSCPlan
    kept: Optional[torch.Tensor]

    def row_max(self, data):
        out = ops.segment_max_op(data, self.plan)
        deg = self.plan.indptr[1:] - self.plan.indptr[:-1]
        return torch.where(_lead(deg > 0, out), out,
                           torch.full_like(out, float("-inf")))

    def to_edges(self, rows):
        return ops.segment_sum_bwd_op(rows, self.plan)

    def to_rows(self, x):
        return ops.segment_sum_op(x, self.plan)


class _Plain(NamedTuple):
    """The plain route's kept ids, with the same methods over
    :class:`~repro_torch.core.aggregate.ReferenceBackend`'s segment
    math."""
    ids: torch.Tensor
    num_segments: int
    kept = None

    def row_max(self, data):
        return _REFERENCE.segment_max(data, self.ids, self.num_segments)

    def to_edges(self, rows):
        return rows[self.ids]

    def to_rows(self, x):
        return _REFERENCE.segment_sum(x, self.ids, self.num_segments)


def _segments(segment_ids: torch.Tensor, num_segments: int,
              device) -> _Planned:
    """Plan the ids on the host (``jax.ops.segment_*`` drop an id outside
    ``[0, num_segments)``; the plan takes an id at or past
    ``num_segments`` as a pad edge that joins no row)."""
    ids = segment_ids.detach().cpu().numpy().astype(np.int64).reshape(-1)
    dropped = (ids < 0) | (ids >= num_segments)
    plan = build_csc_plan(np.where(dropped, num_segments, ids),
                          num_segments).to(device)
    kept = (torch.from_numpy(~dropped).to(device) if dropped.any()
            else None)
    return _Planned(plan, kept)


def _lead(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (E,) mask shaped to broadcast over ``like``'s trailing axes."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def _drop(x: torch.Tensor, segs: _Planned) -> torch.Tensor:
    """``x`` with the dropped entries zeroed: their gradient is then 0, as
    JAX's, where the backward kernels' clipped row lookup would hand a
    pad edge its last row's cotangent."""
    if segs.kept is None:
        return x
    return torch.where(_lead(segs.kept, x), x, torch.zeros_like(x))


def _on_card(t: torch.Tensor) -> bool:
    """Whether a call takes the kernels' route: any tensor off the CPU
    (the kernel wrappers launch on CUDA and raise on other devices)."""
    return t.device.type != "cpu"


def _kept(segment_ids: torch.Tensor, num_segments: int, *tensors):
    """The plain path's operands with the dropped entries left out."""
    ids = segment_ids.long()
    kept = (ids >= 0) & (ids < num_segments)
    if bool(kept.all()):
        return (ids,) + tensors
    return (ids[kept],) + tuple(t[kept] for t in tensors)


class _SegmentMaxSplit(torch.autograd.Function):
    """``segment_max`` with ``jax.ops.segment_max``'s gradient: the row
    max, then a backward that splits a row's cotangent evenly over the
    entries that tie for its max (ids ``[0,0,0,1]``, data ``[1,3,3,2]``
    -> ``[0,.5,.5,1]``; ROADMAP C.1), times the reciprocal of the tie
    count, as JAX does, so that the bits are JAX's. On the kernels' route
    (:class:`_Planned`) that is the ``segment_max`` kernel forward, and
    in the backward the ``segment_sum_bwd`` gather of each entry's row
    max, the ``segment_sum`` kernel's count of each row's ties and the
    gather of the shares; the ``csc`` backend's own pair
    (``segment_max_bwd``) gives every tie the whole cotangent."""

    @staticmethod
    def forward(ctx, data, segs):
        out = segs.row_max(data)
        ctx.segs = segs
        ctx.save_for_backward(data, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        data, out = ctx.saved_tensors
        segs = ctx.segs
        hit = data == segs.to_edges(out)
        if segs.kept is not None:
            hit = hit & _lead(segs.kept, hit)
        count = segs.to_rows(hit.to(data.dtype))
        share = segs.to_edges(g * (1.0 / count.clamp_min(1.0)))
        return torch.where(hit, share, torch.zeros_like(share)), None


def _planned_sum(data, segs: _Planned):
    return agg._CSCSegmentSum.apply(_drop(data, segs), segs.plan)


def _planned_softmax(logits, values, segs: _Planned, edge_mask):
    """The weighted softmax of ``segment_softmax`` as the ``edge_softmax``
    kernel's plain one: an edge of mask ``w > 0`` enters with logit
    ``logit + log(w)`` (``log(1)`` is 0, so a 0/1 mask leaves the logits'
    bits alone), every other edge with ``NEG`` and zero values, so an
    all-masked row gives 0 as JAX's does."""
    on = edge_mask > 0
    if segs.kept is not None:
        on = on & segs.kept
    log_w = torch.log(torch.where(on, edge_mask, torch.ones_like(
        edge_mask)).to(logits.dtype))
    lg = torch.where(on[:, None], logits + log_w[:, None],
                     torch.full_like(logits, NEG))
    v = torch.where(on[:, None, None], values, torch.zeros_like(values))
    return agg._CSCEdgeSoftmax.apply(lg, v, segs.plan)


def segment_sum(data, segment_ids, num_segments: int):
    """``jax.ops.segment_sum``: data (E, ...) -> (num_segments, ...)."""
    if not _on_card(data):
        ids, data = _kept(segment_ids, num_segments, data)
        return _REFERENCE.segment_sum(data, ids, num_segments)
    return _planned_sum(data, _segments(segment_ids, num_segments,
                                        data.device))


def segment_mean(data, segment_ids, num_segments: int, weights=None):
    """Per-segment sum over the (weighted) count, clamped at 1e-9; the
    (num_segments,) count broadcasts over every trailing axis, so (E, H,
    D) messages divide by an (N, 1, 1) count. ``weights`` (E,) replace
    the ones the count sums."""
    ones = (torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
            if weights is None else weights)
    if not _on_card(data):
        ids, data, ones = _kept(segment_ids, num_segments, data, ones)
        total = _REFERENCE.segment_sum(data, ids, num_segments)
        count = _REFERENCE.segment_sum(ones, ids, num_segments)
    else:
        segs = _segments(segment_ids, num_segments, data.device)
        total = _planned_sum(data, segs)
        count = _planned_sum(ones, segs)
    count = count.reshape(count.shape + (1,) * (total.dim() - 1))
    return total / torch.clamp_min(count, 1e-9)


def segment_max(data, segment_ids, num_segments: int):
    """``jax.ops.segment_max``: the feature-wise max per segment, -inf for
    an empty one; tied maxima split the cotangent evenly (ROADMAP C.1).
    The kernel's max starts from ``NEG`` (-1e30), so on the card a row
    whose entries all lie below -1e30 gives -1e30 and no gradient."""
    if not _on_card(data):
        ids, data = _kept(segment_ids, num_segments, data)
        return _SegmentMaxSplit.apply(data, _Plain(ids, num_segments))
    return _SegmentMaxSplit.apply(data, _segments(segment_ids, num_segments,
                                                  data.device))


def segment_softmax(logits, values, segment_ids, num_segments: int,
                    edge_mask):
    """Softmax over incoming edges per destination, applied to values.

    logits (E, H), values (E, H, D), edge_mask (E,) -> (num_segments, H,
    D). Masked edges (``edge_mask <= 0``) take ``NEG`` logits, each edge's
    weight is scaled by its mask, and the denominator clamps at 1e-9, as
    ``repro/core/tgar.py:59`` does; the kernel clamps at 1e-20 (ROADMAP
    C.3), and the two agree: a row with an active edge has a denominator
    of at least 1 under a 0/1 mask, an all-masked row gives 0 under
    both. On the card a weight ``w > 0`` enters as ``logit + log(w)``,
    which weighs the edge the same; the mask's own gradient on an
    all-masked row is 0 there, where JAX's is a derivative through the
    1e-9 clamp."""
    if not _on_card(logits):
        ids, logits, values, edge_mask = _kept(
            segment_ids, num_segments, logits, values, edge_mask)
        masked = torch.where(edge_mask[:, None] > 0, logits,
                             torch.full_like(logits, NEG))
        seg_max = torch.clamp_min(
            _REFERENCE.segment_max(masked, ids, num_segments), NEG)
        ex = torch.exp(masked - seg_max[ids]) * edge_mask[:, None]
        den = _REFERENCE.segment_sum(ex, ids, num_segments)
        num = _REFERENCE.segment_sum(ex[..., None] * values, ids,
                                     num_segments)
        return num / torch.clamp_min(den, 1e-9)[..., None]
    return _planned_softmax(logits, values,
                            _segments(segment_ids, num_segments,
                                      logits.device), edge_mask)


class TGARLayer(nn.Module):
    """One encoding layer in the NN-TGAR pattern.

    transform(h) -> n                                  # NN-T, per node
    gather(n_src, n_dst, edge_attr, edge_w, edge_mask) -> msg   # NN-G
        msg is {"value": (E, H, D)} and, for combine == "softmax",
        additionally {"logit": (E, H)}.
    node_apply(h, M) -> h_next                         # NN-A, per node
        (the reference's ``apply``, renamed: ``nn.Module.apply`` is taken)
    """
    combine: str = "sum"

    def __init__(self, name: str, out_dim: int, heads: int = 1):
        super().__init__()
        self.name = name
        self.out_dim = int(out_dim)
        self.heads = int(heads)

    def transform(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def gather(self, n_src, n_dst, edge_attr, edge_w, edge_mask):
        raise NotImplementedError

    def node_apply(self, h: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def tree_take(tree: Dict[str, torch.Tensor], idx: torch.Tensor,
              plan: Optional[CSCPlan] = None):
    """Index the leading axis of every entry (edge-endpoint lookup),
    through :func:`repro_torch.core.aggregate.take`. ``plan`` — the plan
    over ``idx`` (a block's ``src_plan`` for its ``src``, ``csc_plan``
    for its ``dst``) — makes the gather on the card the plan's gather
    kernel and the backward the deterministic segment sum of
    :class:`_PlannedGather`; without one, or on the CPU, the forward is
    plain ``index_select``."""
    return {k: agg.take(v, idx, plan) for k, v in tree.items()}


class _ReferenceRoute(agg.ReferenceBackend):
    """The JAX ``reference`` backend's results over one call's ids, as
    the public primitives above give them: on CPU tensors their plain
    segment math, on CUDA tensors the kernels over one plan built here
    from the ids (``segment_sum``; ``segment_max`` with the even tie
    split of :class:`_SegmentMaxSplit`; the fused ``edge_softmax``).
    The reference's softmax clamps its denominator at 1e-9, the kernel at
    1e-20, and the two agree: ``combine`` hands in logits that are NEG on
    masked edges and values zeroed there, so a row with a live edge has a
    denominator of at least 1 and an all-masked or empty row gives 0
    under both."""

    def __init__(self, segment_ids: torch.Tensor, num_segments: int,
                 on_card: bool):
        self.segs = (_segments(segment_ids, num_segments,
                               segment_ids.device) if on_card else None)

    def segment_sum(self, data, segment_ids, num_segments, plan=None):
        if self.segs is None:
            return segment_sum(data, segment_ids, num_segments)
        return _planned_sum(data, self.segs)

    def segment_max(self, data, segment_ids, num_segments, plan=None):
        if self.segs is None:
            return segment_max(data, segment_ids, num_segments)
        return _SegmentMaxSplit.apply(data, self.segs)

    def edge_softmax(self, logits, values, segment_ids, num_segments,
                     plan=None):
        if self.segs is None:
            ids, logits, values = _kept(segment_ids, num_segments, logits,
                                        values)
            return super().edge_softmax(logits, values, ids, num_segments)
        kept = self.segs.kept
        if kept is not None:
            logits = torch.where(kept[:, None], logits,
                                 torch.full_like(logits, NEG))
            values = _drop(values, self.segs)
        return agg._CSCEdgeSoftmax.apply(logits, values, self.segs.plan)


def combine_messages(layer: TGARLayer, msg, dst, num_segments: int,
                     edge_mask, backend=None, plan: Optional[CSCPlan] = None):
    """The Sum stage on a single block (non-distributed path): the shared
    :func:`~repro_torch.core.aggregate.combine` under ``layer.combine``.

    As in the reference, ``backend=None`` is ``"reference"``, and
    ``"csc"`` without a plan is the reference's segment math: both give
    the JAX ``reference`` backend's results on either device, through
    :class:`_ReferenceRoute` (on the card, the kernels over a plan built
    here from ``dst``; tied maxima split the cotangent evenly, ROADMAP
    C.1). ``"csc"`` with ``plan`` runs the kernels over it, with the
    JAX ``csc`` kernel's rule under ``combine == "max"``: every entry
    that ties for a row's max takes the row's whole cotangent. Any other
    backend runs as :func:`~repro_torch.core.aggregate.combine` runs
    it."""
    be = agg.get_backend("reference" if backend is None else backend)
    if (be.name == "reference"
            or (be.name == "csc" and plan is None)):
        be, plan = _ReferenceRoute(dst, num_segments,
                                   _on_card(msg["value"])), None
    return agg.combine(layer.combine, msg, dst, num_segments, edge_mask,
                       backend=be, plan=plan)


def layer_forward_block(layer: TGARLayer, h: torch.Tensor, block: GraphBlock,
                        layer_idx: int, num_nodes: int, backend=None):
    """Forward one TGAR layer on a GraphBlock, applying the per-layer
    active sets (paper §4.2) so a view computes exactly its K-hop
    neighbourhood. ``backend`` picks the Sum-stage backend; the block's
    plan feeds the ``"csc"`` kernels."""
    edge_mask = block.edge_mask
    node_act = None
    if block.edge_active is not None:
        edge_mask = edge_mask * block.edge_active[layer_idx]
    if block.node_active is not None:
        node_act = block.node_active[layer_idx]

    n = layer.transform(h)                                # NN-T
    n_src = tree_take(n, block.src, block.src_plan)
    n_dst = tree_take(n, block.dst, block.csc_plan)
    msg = layer.gather(n_src, n_dst, block.edge_attr, block.edge_weight,
                       edge_mask)                         # NN-G
    M = agg.combine(layer.combine, msg, block.dst, num_nodes, edge_mask,
                    backend=backend, plan=block.csc_plan)  # Sum
    h_next = layer.node_apply(h, M)                       # NN-A
    if node_act is not None:
        h_next = h_next * node_act[:, None]
    return h_next * block.node_mask[:, None]
