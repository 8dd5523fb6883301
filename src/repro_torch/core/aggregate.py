"""The Sum stage (paper §3.1 / §4.2): per-destination aggregation of edge
messages, forward and backward (the counterpart of
``repro/core/aggregate.py``).

- :data:`COMBINE_SPECS` — the combine modes (``sum`` / ``mean`` /
  ``max`` / ``softmax``) with their algebraic properties.
- :class:`AggregationBackend` — segment primitives. ``"csc"`` runs the
  CUDA kernels through :mod:`repro_torch.kernels.ops` (their plain
  versions for CPU tensors) and needs the block's plan; its gradients
  are two ``torch.autograd.Function``s whose backwards are the backward
  kernels (the reference's ``custom_vjp``s). ``"reference"`` is plain
  segment math under torch's own autograd, for the CPU tests; it raises
  on CUDA tensors, so nothing on the card silently runs it.
- :func:`combine` — the one Sum-stage implementation on one block.

The backends live in this package's own registry. The distributed
finalize (``ShardContext``) waits for the engine slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.plan import CSCPlan
from repro_torch.kernels.ref import NEG


@dataclass(frozen=True)
class CombineSpec:
    """``needs_logits`` — gather must emit a per-edge ``"logit"`` field;
    ``reduce_ops`` — halo reduce phases a distributed finalize needs."""
    name: str
    needs_logits: bool
    reduce_ops: tuple


COMBINE_SPECS: Dict[str, CombineSpec] = {
    "sum": CombineSpec("sum", False, ("sum",)),
    "mean": CombineSpec("mean", False, ("sum",)),
    "max": CombineSpec("max", False, ("max",)),
    "softmax": CombineSpec("softmax", True, ("max", "sum")),
}


def combine_spec(mode: str) -> CombineSpec:
    try:
        return COMBINE_SPECS[mode]
    except KeyError:
        raise ValueError(
            f"unknown combine mode {mode!r}; "
            f"registered: {sorted(COMBINE_SPECS)}") from None


class AggregationBackend:
    """Segment primitives the combine algorithms are written against.
    ``data`` may be (E,), (E, H) or (E, H, D); outputs keep the trailing
    shape with the edge axis replaced by ``num_segments``."""

    name = "abstract"

    def segment_sum(self, data, segment_ids, num_segments: int,
                    plan: Optional[CSCPlan] = None):
        raise NotImplementedError

    def segment_max(self, data, segment_ids, num_segments: int,
                    plan: Optional[CSCPlan] = None):
        raise NotImplementedError

    def edge_softmax(self, logits, values, segment_ids, num_segments: int,
                     plan: Optional[CSCPlan] = None):
        raise NotImplementedError


def _segment_index(data: torch.Tensor, segment_ids: torch.Tensor):
    return segment_ids.long().view(-1, *([1] * (data.dim() - 1))).expand(
        data.shape)


class ReferenceBackend(AggregationBackend):
    """Plain segment ops over ``segment_ids`` (the reference's
    ``jax.ops.segment_*`` math), for tensors on the CPU only."""

    name = "reference"

    @staticmethod
    def _cpu_only(t: torch.Tensor) -> None:
        if t.device.type != "cpu":
            raise RuntimeError(
                "the 'reference' aggregation backend runs on the CPU only; "
                "on the card use the 'csc' kernel backend")

    def segment_sum(self, data, segment_ids, num_segments, plan=None):
        self._cpu_only(data)
        out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
        return out.index_add_(0, segment_ids.long(), data)

    def segment_max(self, data, segment_ids, num_segments, plan=None):
        """Empty segments give -inf, as ``jax.ops.segment_max`` does."""
        self._cpu_only(data)
        out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                            float("-inf"))
        return out.scatter_reduce_(0, _segment_index(data, segment_ids),
                                   data, "amax", include_self=True)

    def edge_softmax(self, logits, values, segment_ids, num_segments,
                     plan=None):
        """``logits`` are already NEG on inactive edges and ``values``
        zeroed there; denominators clamp at 1e-9 (the reference's
        ``aggregate.py:123``)."""
        ids = segment_ids.long()
        seg_max = self.segment_max(logits, ids, num_segments)
        seg_max = torch.clamp_min(seg_max, NEG)          # empty segments
        ex = torch.exp(logits - seg_max[ids])
        ex = torch.where(logits > NEG / 2, ex, torch.zeros_like(ex))
        den = self.segment_sum(ex, ids, num_segments)
        num = self.segment_sum(ex[..., None] * values, ids, num_segments)
        return num / torch.clamp_min(den, 1e-9)[..., None]


class _CSCSegmentSum(torch.autograd.Function):
    """``segment_sum_op`` with the plan-driven gather kernel as its
    backward (segment-sum is linear: ``d_data[e] = g[edge_dst[e]]``); only
    the plan is kept for the backward."""

    @staticmethod
    def forward(ctx, data, plan: CSCPlan):
        ctx.plan = plan
        return ops.segment_sum_op(data, plan)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        return ops.segment_sum_bwd_op(g, ctx.plan), None


class _CSCEdgeSoftmax(torch.autograd.Function):
    """``edge_softmax_fwd_op`` with the recompute-in-kernel backward: the
    forward's per-row statistics ``(m, den)`` are saved beside the
    operands and its output, so the backward rebuilds each edge's weight
    without an (E, H) probability tensor."""

    @staticmethod
    def forward(ctx, logits, values, plan: CSCPlan):
        out, m, den = ops.edge_softmax_fwd_op(logits, values, plan)
        ctx.plan = plan
        ctx.save_for_backward(logits, values, out, m, den)
        return out

    @staticmethod
    def backward(ctx, g):
        need_logits, need_values = ctx.needs_input_grad[:2]
        if not (need_logits or need_values):
            return None, None, None
        logits, values, out, m, den = ctx.saved_tensors
        d_logits, d_values = ops.edge_softmax_bwd_op(g, logits, values, out,
                                                     m, den, ctx.plan)
        return (d_logits if need_logits else None,
                d_values if need_values else None, None)


class CSCBackend(AggregationBackend):
    """The CUDA kernels behind the backend interface, driven by the
    block's plan (their plain versions for CPU tensors), differentiable
    through :class:`_CSCSegmentSum` and :class:`_CSCEdgeSoftmax`."""

    name = "csc"

    @staticmethod
    def _plan(plan: Optional[CSCPlan]) -> CSCPlan:
        if plan is None:
            raise ValueError("the 'csc' aggregation backend needs the "
                             "block's CSCPlan (stage with csc_plan=True)")
        return plan

    def segment_sum(self, data, segment_ids, num_segments, plan=None):
        return _CSCSegmentSum.apply(data, self._plan(plan))

    def segment_max(self, data, segment_ids, num_segments, plan=None):
        if data.requires_grad and torch.is_grad_enabled():
            # without a Function, autograd would train through
            # scatter_reduce's tie rule, which is neither reference's
            # (ROADMAP C.1)
            raise NotImplementedError(
                "the 'csc' max combine has no backward yet: "
                "segment_max_csc and segment_max_bwd_csc are still to be "
                "ported (ROADMAP B.5/B.6)")
        return ops.segment_max_op(data, self._plan(plan))

    def edge_softmax(self, logits, values, segment_ids, num_segments,
                     plan=None):
        return _CSCEdgeSoftmax.apply(logits, values, self._plan(plan))


_BACKENDS: Dict[str, Callable[[], AggregationBackend]] = {
    "reference": ReferenceBackend,
    "csc": CSCBackend,
}
_INSTANCES: Dict[str, AggregationBackend] = {}


def get_backend(backend: Union[None, str, AggregationBackend]
                ) -> AggregationBackend:
    """Resolve a backend name (or pass an instance through); ``None`` is
    ``"csc"``, the kernel backend."""
    if backend is None:
        backend = "csc"
    if isinstance(backend, AggregationBackend):
        return backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; "
                         f"registered: {sorted(_BACKENDS)}")
    if backend not in _INSTANCES:
        _INSTANCES[backend] = _BACKENDS[backend]()
    return _INSTANCES[backend]


def combine(mode: str, msg, dst, num_segments: int, edge_mask,
            backend: Union[None, str, AggregationBackend] = None,
            plan: Optional[CSCPlan] = None):
    """The Sum stage on one block.

    msg["value"]: (E, H, D); msg["logit"]: (E, H) when the mode needs it;
    dst (E,) int; edge_mask (E,) float. Returns (num_segments, H, D).
    Masked logits go to NEG, values are zeroed on masked edges, and empty
    max rows give 0 — as ``repro/core/aggregate.py:398-431``.
    """
    spec = combine_spec(mode)
    be = get_backend(backend)
    value = msg["value"]

    if spec.name == "softmax":
        logit = torch.where(edge_mask[:, None] > 0, msg["logit"],
                            torch.full_like(msg["logit"], NEG))
        masked_value = value * edge_mask[:, None, None]
        return be.edge_softmax(logit, masked_value, dst, num_segments, plan)

    if spec.name == "max":
        masked = torch.where(edge_mask[:, None, None] > 0, value,
                             torch.full_like(value, NEG))
        agg = be.segment_max(masked, dst, num_segments, plan)
        # empty destinations aggregate to the identity (0), not -inf/NEG
        return torch.where(agg > NEG / 2, agg, torch.zeros_like(agg))

    total = be.segment_sum(value * edge_mask[:, None, None], dst,
                           num_segments, plan)
    if spec.name == "mean":
        deg = be.segment_sum(edge_mask, dst, num_segments, plan)
        total = total / torch.clamp_min(deg, 1e-9)[:, None, None]
    return total
