"""A step of the port traced on fake tensors: what it computes, moves and
holds, at full size, allocating nothing (the dry-run's counterpart of
the reference's compile for placeholder devices).

:func:`fake_model` builds a :class:`~repro_torch.arch.TransformerLM`
under a ``FakeTensorMode``: every weight is drawn as the real model's
is, but as a fake tensor, which has a shape, a dtype and a device and no
storage, so Jamba-1.5-Large's 398B parameters cost nothing.
:func:`trace` runs a step (the port's own ``loss`` + backward + AdamW,
``prefill`` or ``decode_step``, :func:`train_step`) over such a model on
the CPU and records:

- FLOPs, by ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  ``mm``, ``bmm``, ``addmm``, ...; elementwise work is not counted);
- bytes accessed: the sum of each aten op's input and output bytes, an
  input counted once and at most its storage's bytes (a broadcast view
  reads its storage), an output that is an input written in place
  counted as that input; an op that only makes a view or an alias of
  its input moves nothing and is skipped;
- every storage the step allocates and when it is freed (a weak
  reference on the storage), from which :meth:`StepTrace.peak_bytes`
  reads the peak of what the step holds beyond the state it was given,
  the gradients it returns told apart from the activations. An op's
  own buffers are not dispatched and so not seen, except those that
  matter most here, plain attention's softmax over (B, H, S, S) scores:
  the softmax copies a non-contiguous input, and its backward on the
  card holds one buffer of its output's size besides (measured with
  torch 2.11); the trace books them for the op's duration.

A kernel runs as its own wrapper's plain version on the CPU, but what
the card runs is the kernel: inside a kernel scope of
:mod:`repro_torch.kernels.ops` the trace counts the kernel's operands and
outputs, and the plain version is replaced by a stand-in that makes the
outputs and books the kernel's FLOPs (``flash_attention``: 4 D FLOPs a
visible query-key pair a head, with no left pad; ``wkv6``: 4 K V a
token a head, the output product and the state's update). Plain
attention at ``prefill_32k`` would otherwise book a (B, H, S, S) score
tensor that the kernel never holds.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops

_ACTIVE: Optional["_Tracker"] = None


def fake_model(cfg, **kw):
    """``(mode, model)``: ``build_model(cfg, **kw)`` with every weight a
    fake tensor of a new ``FakeTensorMode``, in which real constants
    (RoPE's frequencies, made in numpy) may meet fake tensors."""
    from repro_torch.arch.model import build_model
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        model = build_model(cfg, torch.Generator().manual_seed(0), **kw)
    return mode, model


def _tensors(x) -> list:
    """The tensors in an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def visible_pairs(T: int, seq_len: int = 0, causal: bool = True,
                  sliding_window: int = 0) -> int:
    """The (query, key) pairs ``flash_attention`` attends over in a row of
    T queries with no left pad: key ``j`` visible to query ``i`` when ``j
    < seq_len``, and as asked ``j <= i`` and ``j > i - window``."""
    seq_len = seq_len or T
    i = np.arange(T, dtype=np.int64)
    hi = np.minimum(i, seq_len - 1) if causal else np.full(T, seq_len - 1)
    lo = np.maximum(i - sliding_window + 1, 0) if sliding_window else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_stand_in(q, k, v, *, causal=True, sliding_window=0, seq_len=0,
                    kv_start=None):
    out = torch.empty(q.shape[:3] + (v.shape[-1],), dtype=q.dtype,
                      device=q.device)
    B, T, Hq, D = q.shape
    _ACTIVE.kernel_flops += 4 * B * Hq * D * visible_pairs(
        T, seq_len, causal, sliding_window)
    _ACTIVE.bytes += sum(map(_nbytes, (q, k, v, out))) + (
        0 if kv_start is None else _nbytes(kv_start))
    return out


def _wkv6_stand_in(r, k, v, w, u, out_dtype=None):
    B, T, H, K = r.shape
    V = v.shape[-1]
    o = torch.empty(v.shape, dtype=out_dtype or r.dtype, device=r.device)
    s = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    _ACTIVE.kernel_flops += 4 * B * T * H * K * V
    _ACTIVE.bytes += sum(map(_nbytes, (r, k, v, w, u, o, s)))
    return o, s


# softmax and its backward, whose kernels hold buffers the dispatched ops
# do not show (read on the H100 with torch 2.11: the backward holds one
# more tensor of its output's size, two when its gradient input is not
# contiguous)
_aten = torch.ops.aten
_SOFTMAX = frozenset((_aten._softmax.default,
                      _aten._softmax_backward_data.default))


class _Tracker(TorchDispatchMode):
    """Counts bytes and storages of every aten op dispatched while it is
    active, and the kernel scopes entered (as a sink of
    :mod:`repro_torch.kernels.ops`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kernel_flops = 0
        self.ops = 0
        self.kernels: Dict[str, int] = {}
        self.sizes: list = []         # bytes of allocation i
        self.events: list = []        # i: allocated; ~i: freed
        self._index: dict = {}        # id(storage) -> i, while alive

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        held = {}
        for a in ins:
            st = a.untyped_storage()
            held[id(st)] = max(held.get(id(st), 0),
                               min(_nbytes(a), st.nbytes()))
        new = [o for o in outs if id(o.untyped_storage()) not in held]
        if not ops.current_kernel() and (new or func._schema.is_mutable):
            self.bytes += sum(held.values()) + sum(map(_nbytes, new))
        for o in new:
            st = o.untyped_storage()
            key = id(st)
            if key in self._index:
                continue
            i = len(self.sizes)
            self.sizes.append(st.nbytes())
            self.events.append(i)
            self._index[key] = i
            weakref.finalize(st, self._free, key)
        if func in _SOFTMAX:
            # the kernel's own buffers, made and freed inside the op: a
            # contiguous copy of each non-contiguous input, and in the
            # backward one more of the output's size
            temps = [_nbytes(a) for a in ins if not a.is_contiguous()]
            if func == _aten._softmax_backward_data.default:
                temps.append(_nbytes(outs[0]))
            first = len(self.sizes)
            self.sizes += temps
            self.events += list(range(first, len(self.sizes)))
            self.events += [~i for i in range(first, len(self.sizes))]
            self.bytes += 2 * sum(temps)
        return out

    def _free(self, key) -> None:
        self.events.append(~self._index.pop(key))

    def index_of(self, t: torch.Tensor) -> Optional[int]:
        return self._index.get(id(t.untyped_storage()))

    def enter_kernel(self, name: str, route: str, operands) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + 1


@dataclass
class StepTrace:
    """What one traced step computed, moved and allocated (global: the
    whole batch in one program)."""

    flops: float
    bytes_accessed: float
    ops: int
    kernels: Dict[str, int]
    sizes: np.ndarray                 # bytes of each allocation
    events: np.ndarray                # i allocated, ~i freed, in order
    grad: np.ndarray                  # allocation i is a returned gradient
    flops_by_op: Dict[str, float] = field(default_factory=dict)

    def peak_bytes(self, act_div: float = 1.0, grad_div: float = 1.0
                   ) -> float:
        """The peak, over the step, of what it allocated and still held:
        the gradients over ``grad_div`` (a card's share of them) and
        everything else over ``act_div``."""
        if not len(self.events):
            return 0.0
        idx = np.where(self.events >= 0, self.events, ~self.events)
        sign = np.where(self.events >= 0, 1.0, -1.0)
        w = np.where(self.grad[idx], 1.0 / grad_div, 1.0 / act_div)
        return float(max(np.cumsum(sign * self.sizes[idx] * w).max(), 0.0))


@contextlib.contextmanager
def _stand_ins():
    saved = ops.flash_attention_ref, ops.wkv6_ref
    ops.flash_attention_ref, ops.wkv6_ref = _flash_stand_in, _wkv6_stand_in
    try:
        yield
    finally:
        ops.flash_attention_ref, ops.wkv6_ref = saved


def trace(fn: Callable, mode: FakeTensorMode, grads: Callable = None):
    """Run ``fn()`` under ``mode`` and return ``(its result, the
    StepTrace)``. ``grads(result)``, when given, returns the tensors of
    the result that are gradients (their storages are booked as such);
    the state ``fn`` reads (parameters, moments, inputs, caches) was made
    before and is not counted."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a trace is already running")
    tracker = _Tracker()
    counter = FlopCounterMode(display=False)
    _ACTIVE = tracker
    ops.add_sink(tracker)
    try:
        with mode, _stand_ins(), counter, tracker:
            result = fn()
        is_grad = np.zeros(len(tracker.sizes), dtype=bool)
        for g in (grads(result) if grads is not None else ()):
            i = tracker.index_of(g)
            if i is not None:
                is_grad[i] = True
    finally:
        ops.remove_sink(tracker)
        _ACTIVE = None
    by_op = {str(k): float(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return result, StepTrace(
        flops=float(counter.get_total_flops() + tracker.kernel_flops),
        bytes_accessed=float(tracker.bytes), ops=tracker.ops,
        kernels=dict(tracker.kernels),
        sizes=np.asarray(tracker.sizes, dtype=np.float64),
        events=np.asarray(tracker.events, dtype=np.int64),
        grad=is_grad, flops_by_op=by_op)


def train_step(model, opt, state: dict, params: dict, batch: dict,
               n_micro: int = 1):
    """One training step as the dry-run plans it and the card runs it:
    the loss and its gradients (``n_micro`` micro-batches,
    :mod:`repro_torch.launch.microbatch`), then ``opt``'s update of
    ``params`` and ``state`` in place. Returns ``(loss, grads)``."""
    from repro_torch.launch.microbatch import microbatched_value_and_grad
    loss, grads = microbatched_value_and_grad(model.loss, n_micro)(
        params, batch)
    opt.update(grads, state, params)
    return loss, grads


__all__ = ["fake_model", "trace", "train_step", "StepTrace",
           "visible_pairs"]
