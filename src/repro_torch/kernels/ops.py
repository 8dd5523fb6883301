"""Wrappers around the CUDA kernels, with the plans they read.

For a tensor on the CPU a wrapper runs the kernel's plain version
(:mod:`repro_torch.kernels.ref`); for a CUDA tensor it launches the
kernel or raises — there is no fallback. Each launch adds one to
``launches[name]``, so a run can show that its path went through the
kernel. The backward wrappers are what the autograd Functions of
:mod:`repro_torch.core.aggregate` call.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.plan import CSCPlan
from repro_torch.kernels.ref import (NEG, edge_softmax_bwd_ref,
                                     edge_softmax_ref, segment_max_ref,
                                     segment_sum_bwd_ref, segment_sum_ref)

launches = {"segment_sum": 0, "edge_softmax": 0, "segment_sum_bwd": 0,
            "edge_softmax_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _ptr(t: torch.Tensor):
    return t.data_ptr() or None


def _check_cuda(name: str, index: tuple, *tensors: torch.Tensor) -> None:
    """Operands: float32, contiguous, on one device; ``index``: the plan
    tensors the kernel reads, contiguous int32 on the same device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in index:
        if t.device != dev:
            raise ValueError(f"{name}: plan on {t.device}, data on {dev}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: the plan's index arrays must be "
                            "contiguous int32")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _segment_sum_cuda(data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    _check_cuda("segment_sum", (plan.perm, plan.indptr), data)
    n, d = plan.num_segments, data.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    if n == 0 or d == 0:
        return out
    fn = build.kernel("segment_sum")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(_ptr(data), _ptr(plan.perm), _ptr(plan.indptr), _ptr(out),
                n, d, stream)
    _raise_on(rc, "segment_sum")
    launches["segment_sum"] += 1
    return out


def _edge_softmax_cuda(logits: torch.Tensor, values: torch.Tensor,
                       plan: CSCPlan):
    _check_cuda("edge_softmax", (plan.perm, plan.indptr), logits, values)
    n, (_, h, d) = plan.num_segments, values.shape
    out = torch.empty((n, h, d), dtype=torch.float32, device=values.device)
    m = torch.empty((n, h), dtype=torch.float32, device=values.device)
    den = torch.empty((n, h), dtype=torch.float32, device=values.device)
    if n == 0 or h == 0 or d == 0:
        return out, m.fill_(NEG), den.zero_()
    fn = build.kernel("edge_softmax")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(_ptr(logits), _ptr(values), _ptr(plan.perm),
                _ptr(plan.indptr), _ptr(out), _ptr(m), _ptr(den), n, h, d,
                stream)
    _raise_on(rc, "edge_softmax")
    launches["edge_softmax"] += 1
    return out, m, den


def _segment_sum_bwd_cuda(g: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    _check_cuda("segment_sum_bwd", (plan.edge_dst,), g)
    (n, d), e = g.shape, plan.num_edges
    if n == 0:
        return g.new_zeros((e, d))
    out = torch.empty((e, d), dtype=torch.float32, device=g.device)
    if e == 0 or d == 0:
        return out
    fn = build.kernel("segment_sum_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(_ptr(g), _ptr(plan.edge_dst), _ptr(out), e, n, d, stream)
    _raise_on(rc, "segment_sum_bwd")
    launches["segment_sum_bwd"] += 1
    return out


def _edge_softmax_bwd_cuda(g, logits, values, m, den, og, plan: CSCPlan):
    _check_cuda("edge_softmax_bwd", (plan.edge_dst,), g, logits, values, m,
                den, og)
    n, h, d = g.shape
    if n == 0:
        return torch.zeros_like(logits), torch.zeros_like(values)
    d_logits = torch.empty_like(logits)
    d_values = torch.empty_like(values)
    if plan.num_edges == 0 or h == 0 or d == 0:
        return d_logits, d_values
    fn = build.kernel("edge_softmax_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(_ptr(g), _ptr(logits), _ptr(values), _ptr(m), _ptr(den),
                _ptr(og), _ptr(plan.edge_dst), _ptr(d_logits),
                _ptr(d_values), plan.num_edges, n, h, d, stream)
    _raise_on(rc, "edge_softmax_bwd")
    launches["edge_softmax_bwd"] += 1
    return d_logits, d_values


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def segment_sum_op(data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """data (E,)/(E, D)/(E, H, D) -> (num_segments, ...trailing); multi-
    head messages fold into the feature axis, as the reference does."""
    if data.shape[0] != plan.num_edges:
        raise ValueError(f"data edge axis {data.shape[0]} != plan "
                         f"num_edges {plan.num_edges}")
    trailing = tuple(data.shape[1:])
    flat = data.reshape(data.shape[0], math.prod(trailing))
    if _route(data) == "cpu":
        out = segment_sum_ref(flat, plan.perm, plan.indptr,
                              plan.num_segments)
    else:
        out = _segment_sum_cuda(flat, plan)
    return out.reshape((plan.num_segments,) + trailing)


def segment_max_op(data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """Per-row max; empty rows give NEG. Only the plain version exists so
    far: ``segment_max_csc`` is still to be ported (ROADMAP B.5)."""
    if data.shape[0] != plan.num_edges:
        raise ValueError(f"data edge axis {data.shape[0]} != plan "
                         f"num_edges {plan.num_edges}")
    if _route(data) == "cuda":
        raise NotImplementedError(
            "segment_max has no CUDA kernel yet: segment_max_csc is still "
            "to be ported (ROADMAP B.5)")
    trailing = tuple(data.shape[1:])
    out = segment_max_ref(data.reshape(data.shape[0], math.prod(trailing)),
                          plan.perm,
                          plan.indptr, plan.num_segments)
    return out.reshape((plan.num_segments,) + trailing)


def edge_softmax_fwd_op(logits: torch.Tensor, values: torch.Tensor,
                        plan: CSCPlan):
    """Softmax-weighted neighbour sums plus the per-row statistics.

    Single-head: logits (E,), values (E, D) -> out (N, D).
    Multi-head:  logits (E, H), values (E, H, D) -> out (N, H, D).
    Returns ``(out, m (N, H), den (N, H))``."""
    if logits.shape[0] != plan.num_edges:
        raise ValueError(f"logits edge axis {logits.shape[0]} != plan "
                         f"num_edges {plan.num_edges}")
    single = logits.dim() == 1
    if single:
        logits, values = logits[:, None], values[:, None, :]
    if logits.dim() != 2 or values.shape[:2] != logits.shape \
            or values.dim() != 3:
        raise ValueError(f"expected (E, H) logits with (E, H, D) values, "
                         f"got {tuple(logits.shape)} / {tuple(values.shape)}")
    if _route(logits) == "cpu":
        out, m, den = edge_softmax_ref(logits, values, plan.perm,
                                       plan.indptr, plan.num_segments)
    else:
        out, m, den = _edge_softmax_cuda(logits, values, plan)
    return (out[:, 0, :] if single else out), m, den


def edge_softmax_op(logits: torch.Tensor, values: torch.Tensor,
                    plan: CSCPlan) -> torch.Tensor:
    return edge_softmax_fwd_op(logits, values, plan)[0]


def segment_sum_bwd_op(g: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """Backward of :func:`segment_sum_op`: g (num_segments, ...trailing)
    -> (E, ...trailing), ``d_data[e] = g[edge_dst[e]]`` (segment-sum is
    linear). Multi-head cotangents fold into the feature axis as in the
    forward; pad edges read the last row, as the TPU kernel clips."""
    if g.shape[0] != plan.num_segments:
        raise ValueError(f"cotangent segment axis {g.shape[0]} != plan "
                         f"num_segments {plan.num_segments}")
    trailing = tuple(g.shape[1:])
    # autograd may hand the cotangent over expanded (stride 0)
    flat = g.contiguous().reshape(g.shape[0], math.prod(trailing))
    if _route(g) == "cpu":
        out = segment_sum_bwd_ref(flat, plan.edge_dst)
    else:
        out = _segment_sum_bwd_cuda(flat, plan)
    return out.reshape((plan.num_edges,) + trailing)


def edge_softmax_bwd_op(g: torch.Tensor, logits: torch.Tensor,
                        values: torch.Tensor, out: torch.Tensor,
                        m: torch.Tensor, den: torch.Tensor, plan: CSCPlan):
    """Backward of :func:`edge_softmax_op` from the forward's saved
    operands and statistics: g / out (N, H, D) cotangent and forward
    output, logits (E, H), values (E, H, D), m / den (N, H). Returns
    ``(d_logits, d_values)``, single-head shapes lifted and lowered as in
    the forward. ``og = out . g`` is the node-sized contraction taken here,
    outside the kernel (the reference's ``ops.py:462``)."""
    if logits.shape[0] != plan.num_edges:
        raise ValueError(f"logits edge axis {logits.shape[0]} != plan "
                         f"num_edges {plan.num_edges}")
    single = logits.dim() == 1
    if single:
        logits, values = logits[:, None], values[:, None, :]
        g, out = g[:, None, :], out[:, None, :]
    if logits.dim() != 2 or values.shape[:2] != logits.shape \
            or values.dim() != 3:
        raise ValueError(f"expected (E, H) logits with (E, H, D) values, "
                         f"got {tuple(logits.shape)} / {tuple(values.shape)}")
    n, h = plan.num_segments, logits.shape[1]
    if g.shape != (n, h, values.shape[2]) or out.shape != g.shape \
            or m.shape != (n, h) or den.shape != (n, h):
        raise ValueError(f"cotangent {tuple(g.shape)} / out "
                         f"{tuple(out.shape)} / m {tuple(m.shape)} / den "
                         f"{tuple(den.shape)} do not fit {n} rows of "
                         f"{tuple(values.shape[1:])}")
    # autograd may hand the cotangent over expanded (stride 0)
    g = g.contiguous()
    og = (out * g).sum(-1)
    if _route(g) == "cpu":
        d_logits, d_values = edge_softmax_bwd_ref(g, logits, values, m, den,
                                                  og, plan.edge_dst)
    else:
        d_logits, d_values = _edge_softmax_bwd_cuda(g, logits, values, m,
                                                    den, og, plan)
    if single:
        return d_logits[:, 0], d_values[:, 0, :]
    return d_logits, d_values
