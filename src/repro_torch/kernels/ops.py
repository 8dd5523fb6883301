"""Wrappers around the CUDA kernels, with the plans they read: the
Sum-stage kernels of the GNN path and the LM zoo's ``flash_attention``
and ``wkv6``.

For a tensor on the CPU a wrapper runs the kernel's plain version
(:mod:`repro_torch.kernels.ref`); for a CUDA tensor it launches the
kernel or raises — there is no fallback. Each call that launches adds
one to ``launches[name]``, so a run can show that its path went through
the kernel; ``segment_sum``, ``segment_max`` and ``edge_softmax`` make
two CUDA launches a call (their rows and pieces, or chunks, then the
merge of the rows they cut) and count one. The backward wrappers are
what the autograd Functions of :mod:`repro_torch.core.aggregate` call.
``take_op``, NN-G's gather of node rows onto the edges, is the
``segment_sum_bwd`` kernel under its own name: a plan over the gather's
ids makes the two the same copy.

The Sum-stage wrappers size every grid and scratch from the plan's
shapes and its bound ``max_pieces``, never from a count that changes
within a bucket, so a CUDA graph captured over one view of a bucket
replays for every other. A call made while a graph is being captured
launches nothing yet: it counts into the capture's tally, which each
replay adds to ``launches`` (:mod:`repro_torch.utils.trace`, the one
tally of every captured count).

Every wrapper runs its route, plain or CUDA, inside a kernel scope
(:func:`kernel_scope`): an op recorder of :mod:`repro_torch.analysis`
logs one entry per call with the kernel's name and operands, and tags
the aten ops dispatched inside it with the kernel. The shims at the end
(``assert_pregather_free``, ``assert_sum_stage_fused``,
``count_segment_scatters``) run the analysis rules over such a log.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.plan import CSCPlan
from repro_torch.kernels.ref import (NEG, edge_softmax_bwd_ref,
                                     edge_softmax_ref, flash_attention_ref,
                                     segment_max_bwd_ref, segment_max_ref,
                                     segment_sum_bwd_ref, segment_sum_ref,
                                     wkv6_ref)
from repro_torch.utils import trace

launches = {"segment_sum": 0, "edge_softmax": 0, "segment_sum_bwd": 0,
            "edge_softmax_bwd": 0, "segment_max": 0, "segment_max_bwd": 0,
            "take": 0, "flash_attention": 0, "wkv6": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_sinks: list = []                 # the op recorders running (analysis)
_scope = threading.local()        # each thread's stack of kernel scopes


def add_sink(sink) -> None:
    """Start sending kernel scopes to ``sink.enter_kernel(name, route,
    operands)`` (an op recorder of :mod:`repro_torch.analysis.oplog`)."""
    _sinks.append(sink)


def remove_sink(sink) -> None:
    _sinks.remove(sink)


def current_kernel() -> str:
    """The kernel scope this thread is inside ("" outside every one)."""
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else ""


@contextlib.contextmanager
def kernel_scope(name: str, route: str, *operands: torch.Tensor):
    """One kernel wrapper's call on ``route`` ("cpu": the plain version,
    "cuda": the kernel): each op recorder logs it with its operands, and
    the aten ops dispatched inside are tagged with ``name``. Free when no
    recorder runs."""
    if not _sinks:
        yield
        return
    for sink in tuple(_sinks):
        sink.enter_kernel(name, route, operands)
    if not hasattr(_scope, "stack"):
        _scope.stack = []
    _scope.stack.append(name)
    try:
        yield
    finally:
        _scope.stack.pop()


def _count(name: str) -> None:
    trace.count(name, into=launches)


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


def _scratch(name: str, *sizes: int, device) -> torch.Tensor:
    """The scratch of ``segment_sum``, ``segment_max`` or
    ``edge_softmax`` (the partials of the rows their schedule cuts),
    sized by the kernel source from the plan's shapes, its
    ``max_pieces`` and the widths; from the caching allocator, never
    zeroed."""
    nbytes = build.kernel(name, f"{name}_scratch_bytes")(*sizes)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _plan_index(plan: CSCPlan) -> tuple:
    """The plan arrays the row-and-piece kernels read."""
    return plan.perm, plan.indptr, plan.piece_ptr


def _segment_sum_cuda(data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """One op, two CUDA launches (``csrc/segment_sum.cu``): rows several
    to a warp when they are narrow, a warp per 64-edge piece of a long
    row, then the merge of the rows that were cut; both sized by the
    plan's ``max_pieces``."""
    _check_cuda("segment_sum", _plan_index(plan), data)
    n, x, d = plan.num_segments, plan.max_pieces, data.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    if n == 0 or d == 0:
        return out
    fn = build.kernel("segment_sum")
    scratch = _scratch("segment_sum", x, d, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(_ptr(data), *map(_ptr, _plan_index(plan)), _ptr(out),
                _ptr(scratch), n, x, d, stream)
    _raise_on(rc, "segment_sum")
    _count("segment_sum")
    return out


def _segment_max_cuda(data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """One op, two CUDA launches (``csrc/segment_max.cu``): a warp per
    row and per 64-edge piece of a long row, then the merge of the rows
    that were cut; both sized by the plan's ``max_pieces``."""
    _check_cuda("segment_max", _plan_index(plan), data)
    n, x, d = plan.num_segments, plan.max_pieces, data.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    if n == 0 or d == 0:
        return out
    fn = build.kernel("segment_max")
    scratch = _scratch("segment_max", n, x, d, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(_ptr(data), *map(_ptr, _plan_index(plan)), _ptr(out),
                _ptr(scratch), n, x, d, stream)
    _raise_on(rc, "segment_max")
    _count("segment_max")
    return out


def _edge_softmax_cuda(logits: torch.Tensor, values: torch.Tensor,
                       plan: CSCPlan):
    """One op, two CUDA launches (``csrc/edge_softmax.cu``): a warp per row
    and per 64-edge piece of a long row, or from 2^19 rows plus edges a
    warp per merge-path chunk of the same units, then the merge of the
    rows that were cut."""
    _check_cuda("edge_softmax", _plan_index(plan), logits, values)
    n, e, x = plan.num_segments, plan.num_edges, plan.max_pieces
    _, h, d = values.shape
    out = torch.empty((n, h, d), dtype=torch.float32, device=values.device)
    m = torch.empty((n, h), dtype=torch.float32, device=values.device)
    den = torch.empty((n, h), dtype=torch.float32, device=values.device)
    if n == 0 or h == 0 or d == 0:
        return out, m.fill_(NEG), den.zero_()
    fn = build.kernel("edge_softmax")
    scratch = _scratch("edge_softmax", n, e, x, h, d, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(_ptr(logits), _ptr(values), *map(_ptr, _plan_index(plan)),
                _ptr(out), _ptr(m), _ptr(den), _ptr(scratch), n, e, x, h, d,
                stream)
    _raise_on(rc, "edge_softmax")
    _count("edge_softmax")
    return out, m, den


SUM_BWD_SCHEDULES = ("rows", "edges")


def sum_bwd_schedule(dim: int) -> str:
    """The schedule ``csrc/segment_sum_bwd.cu`` takes by its own rule for
    a cotangent of rows of ``dim`` floats: "rows" (walk the destination
    plan, each row of g read once) from 16 floats a row, else "edges" (a
    gather in edge order). For reports; a launch does not ask it."""
    rule = build.kernel("segment_sum_bwd", "segment_sum_bwd_rows")
    return SUM_BWD_SCHEDULES[0 if rule(dim) else 1]


def _segment_sum_bwd_cuda(g: torch.Tensor, plan: CSCPlan,
                          schedule: Optional[str] = None,
                          name: str = "segment_sum_bwd") -> torch.Tensor:
    """One launch (``csrc/segment_sum_bwd.cu``) under the kernel's rule:
    the destination plan's rows (several to a warp), 64-edge pieces and
    64-edge runs of pad edges, each unit holding its row of g in
    registers, the grid sized by bounds on the pieces and runs; or a
    sub-warp per edge through ``edge_dst``. ``schedule``
    forces one of :data:`SUM_BWD_SCHEDULES`, a hook for tests and
    timings; ``name`` is the wrapper the launch counts under."""
    _check_cuda(name, _plan_index(plan) + (plan.edge_dst,), g)
    (n, d), e = g.shape, plan.num_edges
    if n == 0:
        return g.new_zeros((e, d))
    out = torch.empty((e, d), dtype=torch.float32, device=g.device)
    if e == 0 or d == 0:
        return out
    if schedule not in (None,) + SUM_BWD_SCHEDULES:
        raise ValueError(f"{name}: no schedule {schedule!r}")
    rows = -1 if schedule is None else int(schedule == "rows")
    fn = build.kernel("segment_sum_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(_ptr(g), *map(_ptr, _plan_index(plan)), _ptr(plan.edge_dst),
                _ptr(out), e, n, plan.max_pieces, d, rows, stream)
    _raise_on(rc, name)
    _count(name)
    return out


_SECTOR_FLOATS = 8   # float32s in a 32-byte sector of device memory


def _edge_softmax_bwd_cuda(g, logits, values, out, m, den, plan: CSCPlan):
    """One launch (``csrc/edge_softmax_bwd.cu``) over the destination
    plan's rows (several to a warp), 64-edge pieces and 64-edge runs of
    pad edges, the grid sized by bounds on the pieces and runs; each unit
    takes ``og = out . g`` of its row in registers."""
    _check_cuda("edge_softmax_bwd", _plan_index(plan), g, logits, values,
                out, m, den)
    n, h, d = g.shape
    if n == 0:
        return torch.zeros_like(logits), torch.zeros_like(values)
    e = plan.num_edges
    # d_logits' rows padded to whole 32-byte sectors (zeros past column
    # h) where the call's traffic exceeds the L2 cache, which would
    # otherwise complete each half-written sector by a read; a view of
    # the first h columns is returned
    traffic = 4 * e * h * (2 * d + 2)
    l2 = torch.cuda.get_device_properties(g.device).L2_cache_size
    stride = -(-h // _SECTOR_FLOATS) * _SECTOR_FLOATS if traffic > l2 else h
    d_logits = torch.empty((e, stride), dtype=torch.float32,
                           device=g.device)
    d_values = torch.empty_like(values)
    if e == 0 or h == 0 or d == 0:
        return d_logits[:, :h], d_values
    fn = build.kernel("edge_softmax_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(_ptr(g), _ptr(logits), _ptr(values), _ptr(m), _ptr(den),
                _ptr(out), *map(_ptr, _plan_index(plan)), _ptr(d_logits),
                _ptr(d_values), e, n, plan.max_pieces, h, stride, d, stream)
    _raise_on(rc, "edge_softmax_bwd")
    _count("edge_softmax_bwd")
    return d_logits[:, :h], d_values


def _segment_max_bwd_cuda(g: torch.Tensor, fwd_out: torch.Tensor,
                          data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    _check_cuda("segment_max_bwd", (plan.edge_dst,), g, fwd_out, data)
    (n, d), e = g.shape, plan.num_edges
    if n == 0:
        return g.new_zeros((e, d))
    out = torch.empty((e, d), dtype=torch.float32, device=g.device)
    if e == 0 or d == 0:
        return out
    fn = build.kernel("segment_max_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(_ptr(g), _ptr(fwd_out), _ptr(data), _ptr(plan.edge_dst),
                _ptr(out), e, n, d, stream)
    _raise_on(rc, "segment_max_bwd")
    _count("segment_max_bwd")
    return out


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
    route = _route(data)
    with kernel_scope("segment_sum", route, flat):
        if route == "cpu":
            out = segment_sum_ref(flat, plan.perm, plan.indptr,
                                  plan.num_segments)
        else:
            out = _segment_sum_cuda(flat, plan)
    return out.reshape((plan.num_segments,) + trailing)


def segment_max_op(data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """data (E,)/(E, D)/(E, H, D) -> (num_segments, ...trailing): the
    per-row, feature-wise max; empty rows give NEG (callers clamp), and a
    NaN entry makes its row's output NaN, as ``segment_max_csc`` does."""
    if data.shape[0] != plan.num_edges:
        raise ValueError(f"data edge axis {data.shape[0]} != plan "
                         f"num_edges {plan.num_edges}")
    trailing = tuple(data.shape[1:])
    flat = data.reshape(data.shape[0], math.prod(trailing))
    route = _route(data)
    with kernel_scope("segment_max", route, flat):
        if route == "cpu":
            out = segment_max_ref(flat, plan.perm, plan.indptr,
                                  plan.num_segments)
        else:
            out = _segment_max_cuda(flat, plan)
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
    route = _route(logits)
    with kernel_scope("edge_softmax", route, logits, values):
        if route == "cpu":
            out, m, den = edge_softmax_ref(logits, values, plan.perm,
                                           plan.indptr, plan.num_segments)
        else:
            out, m, den = _edge_softmax_cuda(logits, values, plan)
    return (out[:, 0, :] if single else out), m, den


def edge_softmax_op(logits: torch.Tensor, values: torch.Tensor,
                    plan: CSCPlan) -> torch.Tensor:
    return edge_softmax_fwd_op(logits, values, plan)[0]


def _gather_rows_op(name: str, v: torch.Tensor, plan: CSCPlan
                    ) -> torch.Tensor:
    """v (num_segments, ...trailing) -> (E, ...trailing), ``out[e] =
    v[edge_dst[e]]``: trailing axes fold into the feature axis, and pad
    edges read the last row, as the TPU kernel clips."""
    if v.shape[0] != plan.num_segments:
        raise ValueError(f"{name}: segment axis {v.shape[0]} != plan "
                         f"num_segments {plan.num_segments}")
    trailing = tuple(v.shape[1:])
    # autograd may hand a cotangent over expanded (stride 0)
    flat = v.contiguous().reshape(v.shape[0], math.prod(trailing))
    route = _route(v)
    with kernel_scope(name, route, flat):
        if route == "cpu":
            out = segment_sum_bwd_ref(flat, plan.edge_dst)
        else:
            out = _segment_sum_bwd_cuda(flat, plan, name=name)
    return out.reshape((plan.num_edges,) + trailing)


def segment_sum_bwd_op(g: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """Backward of :func:`segment_sum_op`: g (num_segments, ...trailing)
    -> (E, ...trailing), ``d_data[e] = g[edge_dst[e]]`` (segment-sum is
    linear). Multi-head cotangents fold into the feature axis as in the
    forward; pad edges read the last row, as the TPU kernel clips."""
    return _gather_rows_op("segment_sum_bwd", g, plan)


def take_op(v: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """NN-G's gather ``v[idx]`` for ``plan``, the plan over ``idx``: v
    (num_segments, ...trailing) -> (E, ...trailing), every real edge's
    row copied exactly, pad edges the last row. The ``segment_sum_bwd``
    kernel counted as ``"take"``: rows of 16 floats or more are read once
    each and written to their edges, narrower ones gathered in edge
    order."""
    return _gather_rows_op("take", v, plan)


def segment_max_bwd_op(g: torch.Tensor, fwd_out: torch.Tensor,
                       data: torch.Tensor, plan: CSCPlan) -> torch.Tensor:
    """Backward of :func:`segment_max_op` from its saved input ``data``
    (E, ...trailing) and output ``fwd_out`` (num_segments, ...trailing):
    ``d_data[e] = g[edge_dst[e]] * (data[e] == fwd_out[edge_dst[e]])``.
    Every entry that attains its row's max gets the full cotangent —
    ties do not split it, the rule of the JAX ``csc`` kernel (the
    ``reference`` backend splits it evenly, ROADMAP C.1). Pad edges read
    the last row, as the TPU kernel clips."""
    if g.shape[0] != plan.num_segments:
        raise ValueError(f"cotangent segment axis {g.shape[0]} != plan "
                         f"num_segments {plan.num_segments}")
    if data.shape[0] != plan.num_edges:
        raise ValueError(f"data edge axis {data.shape[0]} != plan "
                         f"num_edges {plan.num_edges}")
    trailing = tuple(g.shape[1:])
    if fwd_out.shape != g.shape or tuple(data.shape[1:]) != trailing:
        raise ValueError(f"cotangent {tuple(g.shape)} / forward output "
                         f"{tuple(fwd_out.shape)} / data "
                         f"{tuple(data.shape)} do not fit one another")
    d = math.prod(trailing)
    # autograd may hand the cotangent over expanded (stride 0)
    gf = g.contiguous().reshape(g.shape[0], d)
    ff = fwd_out.contiguous().reshape(g.shape[0], d)
    df = data.contiguous().reshape(data.shape[0], d)
    route = _route(g)
    with kernel_scope("segment_max_bwd", route, gf, ff, df):
        if route == "cpu":
            out = segment_max_bwd_ref(gf, ff, df, plan.edge_dst)
        else:
            out = _segment_max_bwd_cuda(gf, ff, df, plan)
    return out.reshape((plan.num_edges,) + trailing)


def edge_softmax_bwd_op(g: torch.Tensor, logits: torch.Tensor,
                        values: torch.Tensor, out: torch.Tensor,
                        m: torch.Tensor, den: torch.Tensor, plan: CSCPlan):
    """Backward of :func:`edge_softmax_op` from the forward's saved
    operands and statistics: g / out (N, H, D) cotangent and forward
    output, logits (E, H), values (E, H, D), m / den (N, H). Returns
    ``(d_logits, d_values)``, single-head shapes lifted and lowered as in
    the forward. ``og = out . g``, the node-sized contraction, is the
    plain version's input (the reference's ``ops.py:462``); the kernel
    takes it per row in registers."""
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
    g, out = g.contiguous(), out.contiguous()
    route = _route(g)
    with kernel_scope("edge_softmax_bwd", route, g, logits, values, out, m,
                      den):
        if route == "cpu":
            d_logits, d_values = edge_softmax_bwd_ref(
                g, logits, values, m, den, (out * g).sum(-1), plan.edge_dst)
        else:
            d_logits, d_values = _edge_softmax_bwd_cuda(
                g, logits, values, out, m, den, plan)
    if single:
        return d_logits[:, 0], d_values[:, 0, :]
    return d_logits, d_values


# -- the LM zoo's kernels ---------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
FLASH_HEAD_DIMS = (32, 64, 128)
WKV6_HEAD_DIMS = (32, 64)


def _check_lm_cuda(name: str, typed: tuple, f32: tuple = ()) -> str:
    """``typed`` operands: one dtype, float32 or bfloat16; ``f32``:
    float32. All contiguous on one device. Returns the symbol suffix."""
    dev, dtype = typed[0].device, typed[0].dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for t in typed + f32:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in typed:
        if t.dtype != dtype:
            raise TypeError(f"{name}: operands in {t.dtype} and {dtype}")
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: w and u must be float32, got "
                            f"{t.dtype}")
    return _SUFFIX[dtype]


def _check_aligned(name: str, tensors: tuple) -> None:
    """The tensor-core and staged kernels copy 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must start on a 16-byte "
                             "boundary")


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    """The LM kernels have no backward (nor do the TPU kernels): a call
    that autograd would record raises rather than give a zero gradient.
    The model's training path takes the plain functions instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel is forward-only and an "
                           "input requires grad; train through the "
                           "model's loss (train=True), or call it under "
                           "torch.no_grad()")


def _flash_attention_cuda(q, k, v, kv_start, causal, sliding_window,
                          seq_len):
    suffix = _check_lm_cuda("flash_attention", (q, k, v))
    B, T, Hq, D = q.shape
    if D not in FLASH_HEAD_DIMS or v.shape[-1] != D:
        raise ValueError(f"flash_attention: the kernel takes q/k/v head "
                         f"dims equal and in {FLASH_HEAD_DIMS}, got "
                         f"{D}/{v.shape[-1]}")
    if (kv_start.device != q.device or kv_start.dtype != torch.int32
            or not kv_start.is_contiguous()):
        raise TypeError("flash_attention: kv_start must be contiguous "
                        "int32 on the operands' device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # float32 runs on the CUDA cores, bf16 on the tensor cores; both
    # count as one ``flash_attention`` launch
    source = "flash_attention" if suffix == "f32" else "flash_attention_tc"
    if suffix == "bf16":
        _check_aligned("flash_attention", (q, k, v, out))
    fn = build.kernel(source, f"flash_attention_{suffix}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(kv_start), _ptr(out), B, T,
                Hq, k.shape[2], D, int(causal), int(sliding_window),
                seq_len, stream)
    _raise_on(rc, "flash_attention")
    _count("flash_attention")
    return out


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, sliding_window: int = 0,
                       seq_len: int = 0,
                       kv_start: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Blockwise attention (the counterpart of
    ``repro/kernels/ops.py:flash_attention_op``): q (B, T, Hq, D), k and
    v (B, T, Hkv, D) -> (B, T, Hq, D) in q's dtype.

    GQA by index (q head ``h`` reads kv head ``h // (Hq / Hkv)``), no
    repeated K/V; ragged T is masked in the kernel, so nothing is padded.
    ``seq_len`` (0 = T) masks keys at and past it; ``kv_start`` (B,) int
    masks the keys before ``kv_start[b]`` of row ``b`` (the left pad of a
    served batch; None = 0, the TPU kernel). A query row with no visible
    key gives 0. See :func:`repro_torch.kernels.ref.flash_attention_ref`
    for the exact function. Forward-only: raises ``RuntimeError`` when
    autograd would record the call."""
    _forward_only("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects (B, T, H, D) q, k, v")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if (k.shape[:2] != (B, T) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != D or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(same B and T; Hq a multiple of Hkv)")
    seq_len = int(seq_len) or T
    if seq_len > T:
        raise ValueError(f"seq_len {seq_len} exceeds the length {T}")
    if kv_start is None:
        kv_start = torch.zeros(B, dtype=torch.int32, device=q.device)
    elif kv_start.shape != (B,):
        raise ValueError(f"kv_start must be ({B},), got "
                         f"{tuple(kv_start.shape)}")
    route = _route(q)
    with kernel_scope("flash_attention", route, q, k, v, kv_start):
        if route == "cpu":
            return flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=sliding_window,
                                       seq_len=seq_len, kv_start=kv_start)
        return _flash_attention_cuda(q, k, v, kv_start, causal,
                                     sliding_window, seq_len)


def _wkv6_cuda(r, k, v, w, u, out_dtype):
    suffix = _check_lm_cuda("wkv6", (r, k, v), (w, u))
    B, T, H, K = r.shape
    if K not in WKV6_HEAD_DIMS or v.shape[-1] != K:
        raise ValueError(f"wkv6: the kernel takes K = V in "
                         f"{WKV6_HEAD_DIMS}, got {K}/{v.shape[-1]}")
    o = torch.empty(v.shape, dtype=out_dtype, device=r.device)
    s = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return o, s
    _check_aligned("wkv6", (r, k, v, w, o))
    fn = build.kernel("wkv6", f"wkv6_{suffix}_{_SUFFIX[out_dtype]}")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(o),
                _ptr(s), B, T, H, K, stream)
    _raise_on(rc, "wkv6")
    _count("wkv6")
    return o, s


def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None):
    """The RWKV-6 recurrence from a zero state (the counterpart of
    ``repro/kernels/ops.py:wkv6_op``): r, k, w (B, T, H, K), v (B, T, H,
    V), u (H, K) -> (o (B, T, H, V), S_final (B, H, K, V) float32). o is
    in r's dtype when ``out_dtype`` is None (the TPU kernel's contract)
    and float32 when it is ``torch.float32`` (what the model's
    ``wkv_chunked`` returns, so ``ln_x`` rounds once). Any T: the kernel
    runs the steps in order, so nothing is padded to a chunk. See
    :func:`repro_torch.kernels.ref.wkv6_ref`. Forward-only: raises
    ``RuntimeError`` when autograd would record the call."""
    _forward_only("wkv6", r, k, v, w, u)
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3] \
            or u.shape != r.shape[2:]:
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)} do not fit")
    if out_dtype not in (None, torch.float32):
        raise ValueError(f"wkv6: out_dtype is None (r's dtype) or "
                         f"torch.float32, got {out_dtype}")
    route = _route(r)
    with kernel_scope("wkv6", route, r, k, v, w, u):
        if route == "cpu":
            return wkv6_ref(r, k, v, w, u, out_dtype)
        return _wkv6_cuda(r, k, v, w, u, out_dtype or r.dtype)


# -- the contract shims ------------------------------------------------------
# The memory and fusion contracts live as rules in
# :mod:`repro_torch.analysis.oplog`; these keep the reference's ops-level
# API (``repro/kernels/ops.py:272-300``) over a recorded OpLog and raise
# its ContractError, an AssertionError.


def assert_pregather_free(log, plan: CSCPlan) -> None:
    """Shim over ``ops.pregather``: outside the kernels, the recorded
    step never gathers a float tensor through the plan's ``perm`` (the
    message tensor in plan order that the fused kernels eliminated).
    Integer gathers through the plan are allowed."""
    from repro_torch.analysis.oplog import (OpContext, check_or_raise,
                                            run_rules)
    check_or_raise(run_rules(OpContext(log, plan=plan),
                             ids=["ops.pregather"]))


def assert_sum_stage_fused(log, plan: CSCPlan) -> None:
    """Shim over the Sum-stage ruleset on the csc path, forward and
    backward: ``ops.pregather``, ``ops.segment-scatter`` (no
    accumulating scatter with edge-axis updates outside the kernels: the
    atomic fallback) and ``ops.backward-gather`` (no ``(N, ...) -> (E,
    ...)`` gather outside the kernels). Exact on the log of a
    combine-level loss and its backward, where the only segment-shaped
    traffic is the Sum stage; on model-level steps compare
    :func:`count_segment_scatters` across backends instead."""
    from repro_torch.analysis.oplog import (OpContext, check_or_raise,
                                            run_rules)
    check_or_raise(run_rules(
        OpContext(log, plan=plan),
        ids=["ops.pregather", "ops.segment-scatter",
             "ops.backward-gather"]))


def count_segment_scatters(log, plan: CSCPlan) -> int:
    """Accumulating scatters with edge-axis updates outside the kernels
    (see :func:`repro_torch.analysis.oplog.count_segment_scatters`)."""
    from repro_torch.analysis.oplog import count_segment_scatters as count
    return count(log, plan)
