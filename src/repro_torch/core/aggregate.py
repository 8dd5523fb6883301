"""The Sum stage (paper §3.1 / §4.2): per-destination aggregation of edge
messages, forward and backward (the counterpart of
``repro/core/aggregate.py``).

- :data:`COMBINE_SPECS` — the combine modes (``sum`` / ``mean`` /
  ``max`` / ``softmax``) with their algebraic properties.
- :class:`AggregationBackend` — segment primitives. ``"csc"`` runs the
  CUDA kernels through :mod:`repro_torch.kernels.ops` (their plain
  versions for CPU tensors) and needs the block's plan; its gradients
  are three ``torch.autograd.Function``s whose backwards are the backward
  kernels (the reference's ``custom_vjp``s). ``"reference"`` is plain
  segment math under torch's own autograd, for the CPU tests; it raises
  on CUDA tensors, so nothing on the card silently runs it.

The two backends differ on one point, as the reference's do (ROADMAP
C.1): where several entries tie for a row's max, ``"csc"`` gives each of
them the row's full cotangent (segment ids ``[0,0,0,1]``, data
``[1,3,3,2]`` -> gradient ``[0,1,1,1]``), ``"reference"`` splits it
evenly (``[0,.5,.5,1]``), torch's rule and ``jax.ops.segment_max``'s.
- :func:`combine` — the one Sum-stage implementation, on one block or,
  with a :class:`ShardContext`, on a process's shards of a partitioned
  graph, whose shard-local partials it finalizes through the halo (the
  distributed engine, :mod:`repro_torch.core.engine`).

The backends live in this package's own registry
(:func:`register_backend`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

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
        """Empty segments give -inf, as ``jax.ops.segment_max`` does;
        under autograd, tied maxima split the cotangent evenly (ids
        ``[0,0,0,1]``, data ``[1,3,3,2]`` -> ``[0,.5,.5,1]``), the JAX
        ``reference`` backend's rule (ROADMAP C.1)."""
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


class _CSCSegmentMax(torch.autograd.Function):
    """``segment_max_op`` with the argmax-hit gather kernel as its
    backward (the reference's ``_csc_segment_max``): the input and the
    output are saved, and ``d_data[e] = g[r] * (data[e] == out[r])`` for
    the edge's row ``r``. Every tied entry gets the full cotangent (ids
    ``[0,0,0,1]``, data ``[1,3,3,2]`` -> ``[0,1,1,1]``), the JAX ``csc``
    kernel's rule, not the ``reference`` backend's even split (ROADMAP
    C.1)."""

    @staticmethod
    def forward(ctx, data, plan: CSCPlan):
        out = ops.segment_max_op(data, plan)
        ctx.plan = plan
        ctx.save_for_backward(data, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        data, out = ctx.saved_tensors
        return ops.segment_max_bwd_op(g, out, data, ctx.plan), None


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
    through :class:`_CSCSegmentSum`, :class:`_CSCSegmentMax` and
    :class:`_CSCEdgeSoftmax`."""

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
        return _CSCSegmentMax.apply(data, self._plan(plan))

    def edge_softmax(self, logits, values, segment_ids, num_segments,
                     plan=None):
        return _CSCEdgeSoftmax.apply(logits, values, self._plan(plan))


_BACKENDS: Dict[str, Callable[[], AggregationBackend]] = {}
_INSTANCES: Dict[str, AggregationBackend] = {}


def register_backend(name: str, factory: Callable[[], AggregationBackend]):
    """Register (or replace) the backend ``name``; ``get_backend`` makes
    one instance of it on first use."""
    _BACKENDS[name] = factory
    _INSTANCES.pop(name, None)


register_backend("reference", ReferenceBackend)
register_backend("csc", CSCBackend)


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


class _PlannedGather(torch.autograd.Function):
    """``v[idx]`` whose backward is a segment sum over ``plan``, the plan
    over ``idx`` (``d_v[i]`` sums ``g`` over the edges with ``idx == i``,
    in plan order). torch's own backward of ``index_select`` is an
    ``index_add_``, atomic on CUDA and so not the same from run to run;
    this one is the ``segment_sum`` kernel: no atomics, the same bits on
    every run. Pad edges join no row of the plan: the combine masks
    their messages, so their cotangent is 0 and dropping it changes
    nothing."""

    @staticmethod
    def forward(ctx, v, idx, plan: CSCPlan):
        ctx.plan = plan
        return v.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        # autograd may hand the cotangent over expanded (stride 0)
        return ops.segment_sum_op(g.contiguous(), ctx.plan), None, None


def take(v: torch.Tensor, idx: torch.Tensor,
         plan: Optional[CSCPlan] = None) -> torch.Tensor:
    """``v[idx]`` along the leading axis; with ``plan`` (the plan over
    ``idx``) and a gradient to take, its backward is the deterministic
    segment sum of :class:`_PlannedGather`."""
    if plan is not None and v.requires_grad and torch.is_grad_enabled():
        return _PlannedGather.apply(v, idx, plan)
    return v.index_select(0, idx)


@dataclass(frozen=True)
class ShardContext:
    """Halo hooks for finalizing shard-local partial aggregates (the
    counterpart of the reference's ``ShardContext``).

    A process holds ``L`` shards side by side on one node axis: shard
    ``l``'s ``[masters ; mirrors]`` rows start at row ``l * (n_master +
    n_mirror)``. ``reduce(arr, op)`` maps mirror-slot partials (L *
    n_mirror, ...) to master-aligned values (L * n_master, ...),
    ``op`` "sum" or "max"; ``bcast(arr)`` maps master values back onto
    mirror slots. Together they are the paper's mirror→master reduce and
    master→mirror broadcast phases."""
    n_master: int
    n_mirror: int
    reduce: Callable[[Any, str], Any]
    bcast: Callable[[Any], Any]

    def split(self, arr: torch.Tensor):
        """(L * (n_master + n_mirror), ...) -> the masters' rows (L *
        n_master, ...) and the mirrors' (L * n_mirror, ...)."""
        n_tot = self.n_master + self.n_mirror
        a = arr.reshape((arr.shape[0] // n_tot, n_tot) + arr.shape[1:])
        rest = tuple(arr.shape[1:])
        return (a[:, :self.n_master].reshape((-1,) + rest),
                a[:, self.n_master:].reshape((-1,) + rest))

    def join(self, masters: torch.Tensor, mirrors: torch.Tensor):
        """The inverse of :meth:`split`."""
        rest = tuple(masters.shape[1:])
        L = masters.shape[0] // self.n_master
        return torch.cat(
            [masters.reshape((L, self.n_master) + rest),
             mirrors.to(masters.dtype).reshape((L, self.n_mirror) + rest)],
            dim=1).reshape((-1,) + rest)


def _finalize(partial, shard: Optional[ShardContext], op: str):
    """Local partials over [masters ; mirrors] -> per-master totals. A
    tie of the local max and the halo's splits the cotangent evenly, as
    ``jnp.maximum`` does in the reference; ties among the halo's
    partials follow :func:`repro_torch.core.engine._reduce_array`."""
    if shard is None:
        return partial
    local, mirrored = shard.split(partial)
    if op == "sum":
        return local + shard.reduce(mirrored, "sum")
    return torch.maximum(local, shard.reduce(mirrored, "max"))


def combine(mode: str, msg, dst, num_segments: int, edge_mask,
            backend: Union[None, str, AggregationBackend] = None,
            plan: Optional[CSCPlan] = None,
            shard: Optional[ShardContext] = None):
    """The Sum stage.

    msg["value"]: (E, H, D); msg["logit"]: (E, H) when the mode needs it;
    dst (E,) int; edge_mask (E,) float. Returns (num_segments, H, D) —
    or per-master totals (L * n_master, H, D) when ``shard`` is given and
    the arrays are a process's shard-local ones (``num_segments = L *
    (n_master + n_mirror)``). Masked logits go to NEG, values are zeroed
    on masked edges, and empty max rows give 0 — as
    ``repro/core/aggregate.py:385-431``.

    Under ``shard`` the softmax is the reference's three passes: the
    local ``segment_max``, clamped to NEG, max-finalized and broadcast
    back to the mirrors; then two sum-finalized ``segment_sum`` passes
    over the shifted exponentials, each edge's row max gathered through
    ``plan``. Its denominators clamp at 1e-9, the reference's
    ``aggregate.py:415``; one block's fused ``edge_softmax`` kernel
    clamps at 1e-20, the TPU kernel's (ROADMAP C.3).
    """
    spec = combine_spec(mode)
    be = get_backend(backend)
    value = msg["value"]

    if spec.name == "softmax":
        logit = torch.where(edge_mask[:, None] > 0, msg["logit"],
                            torch.full_like(msg["logit"], NEG))
        masked_value = value * edge_mask[:, None, None]
        if shard is None:
            return be.edge_softmax(logit, masked_value, dst, num_segments,
                                   plan)
        lmax = be.segment_max(logit, dst, num_segments, plan)
        lmax = torch.maximum(lmax, torch.full_like(lmax, NEG))  # clamp empty
        gmax_m = _finalize(lmax, shard, "max")
        gmax_all = shard.join(gmax_m, shard.bcast(gmax_m))
        ex = torch.exp(logit - take(gmax_all, dst, plan)) \
            * edge_mask[:, None]
        den = _finalize(be.segment_sum(ex, dst, num_segments, plan),
                        shard, "sum")
        num = _finalize(be.segment_sum(ex[..., None] * masked_value, dst,
                                       num_segments, plan), shard, "sum")
        return num / torch.clamp_min(den, 1e-9)[..., None]

    if spec.name == "max":
        masked = torch.where(edge_mask[:, None, None] > 0, value,
                             torch.full_like(value, NEG))
        agg = _finalize(be.segment_max(masked, dst, num_segments, plan),
                        shard, "max")
        # empty destinations aggregate to the identity (0), not -inf/NEG
        return torch.where(agg > NEG / 2, agg, torch.zeros_like(agg))

    total = _finalize(be.segment_sum(value * edge_mask[:, None, None], dst,
                                     num_segments, plan), shard, "sum")
    if spec.name == "mean":
        deg = _finalize(be.segment_sum(edge_mask, dst, num_segments, plan),
                        shard, "sum")
        total = total / torch.clamp_min(deg, 1e-9)[:, None, None]
    return total
