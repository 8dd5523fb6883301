"""The bucketed single-device trainer (the counterpart of the reference's
``core/trainer.py:BaseTrainer`` and ``CompactTrainer``).

The paper's training strategies (global-, mini- and cluster-batch,
§2.3/§4.3) are all streams of views, so one loop drives every strategy:
each view is staged into a size-bucketed block (a
:class:`~repro_torch.core.views.CompactBlockBuilder` ring, or the graph's
base block for the global view), copied to the device, and run through
one step: forward, masked cross-entropy, ``backward()``, optimizer
update. On the card the Sum stage's forward and backward are the CUDA
kernels (:mod:`repro_torch.core.aggregate`).

Not ported yet, and refused with an error that names the ROADMAP item:
the prefetch pools and sampler processes, the fault-tolerance runtime
and checkpoints (A.8). Views are built inline on the calling thread.

Usage::

    trainer = CompactTrainer(model, g, adam(5e-3))    # on the card
    out = trainer.fit(strategy_views(g, "mini", 2, compact=True), steps=30)
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.mpgnn import accuracy_block, loss_block
from repro_torch.core.views import (CompactBlockBuilder, CompactView,
                                    GraphView)
from repro_torch.device import resolve_device

RUNTIME_TODO = ("the fault-tolerant runtime, prefetch pools and "
                "checkpoints are not ported yet (ROADMAP A.8)")


class RetraceError(AssertionError):
    """The step's per-bucket contract was broken (or never exercised)."""


class BaseTrainer:
    """The shared trainer surface: the ``fit`` loop (loss sync policy,
    eval cadence, host/device timing). Subclasses provide
    ``_make_prepare()`` (a ``view -> staged`` callable), ``_dispatch(
    staged)`` (one step, returning the loss as a tensor on the device),
    ``evaluate`` and ``assert_trace_contract``."""

    def _init_common(self, opt, fault_policy, injector) -> None:
        if fault_policy is not None or injector is not None:
            raise NotImplementedError(f"fault_policy/injector: {RUNTIME_TODO}")
        self.opt = opt
        self.step_num = 0
        # host-clock seconds: view build + staging + copy to the device,
        # and the step (its launches, plus any wait on the device)
        self.timing = {"stage_s": 0.0, "step_s": 0.0}

    def _make_prepare(self):
        raise NotImplementedError

    def _dispatch(self, staged):
        raise NotImplementedError

    def evaluate(self, view, mask: Optional[np.ndarray] = None) -> float:
        raise NotImplementedError

    def assert_trace_contract(self) -> None:
        raise NotImplementedError

    def fit(self, views, steps: Optional[int] = None,
            prefetch_workers: Optional[int] = None,
            prefetch_mode: str = "thread",
            eval_every: int = 0, eval_view=None,
            eval_mask: Optional[np.ndarray] = None,
            checkpoint_every: int = 0,
            checkpoint_dir: Optional[str] = None,
            max_in_flight: int = 2,
            log_every: int = 0, log=print,
            resume: bool = False) -> dict:
        """Run ``steps`` views (all of ``views`` if None) through the
        step. Returns ``{"losses", "evals", "steps", "events"}``.

        Losses stay on the device: before dispatching step *i* the loop
        reads the loss of step *i - max_in_flight* (one scalar wait, which
        bounds how far the host runs ahead of the device), and the rest
        are read at the end. ``prefetch_workers`` above 1, the process
        mode, checkpoints and resume are refused (ROADMAP A.8)."""
        if prefetch_workers is not None and prefetch_workers > 1:
            raise NotImplementedError(
                f"prefetch_workers={prefetch_workers}: {RUNTIME_TODO}")
        if prefetch_mode == "process":
            raise NotImplementedError(f"prefetch_mode='process': "
                                      f"{RUNTIME_TODO}")
        if prefetch_mode != "thread":
            raise ValueError(f"prefetch_mode={prefetch_mode!r} — expected "
                             "'thread' or 'process'")
        if checkpoint_dir or checkpoint_every or resume:
            raise NotImplementedError(f"checkpoints/resume: {RUNTIME_TODO}")
        prepare = self._make_prepare()
        it = iter(itertools.islice(views, steps) if steps is not None
                  else views)
        losses, pending, evals = [], [], []
        while True:
            t0 = time.perf_counter()
            view = next(it, None)
            if view is None:
                break
            staged = prepare(view)
            t1 = time.perf_counter()
            if max_in_flight > 0 and len(pending) >= max_in_flight:
                losses.append(float(pending.pop(0)))
            loss = self._dispatch(staged)
            self.timing["stage_s"] += t1 - t0
            self.timing["step_s"] += time.perf_counter() - t1
            self.step_num += 1
            pending.append(loss)
            if (eval_every and eval_view is not None
                    and self.step_num % eval_every == 0):
                rec = {"step": self.step_num, "loss": float(loss),
                       "eval_acc": self.evaluate(eval_view, eval_mask)}
                evals.append(rec)
                if log_every:
                    log(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
                        f"eval_acc {rec['eval_acc']:.4f}")
        losses.extend(float(x) for x in pending)
        return {"losses": losses, "evals": evals, "steps": self.step_num,
                "events": []}


class CompactTrainer(BaseTrainer):
    """Single-device trainer over size-bucketed blocks.

    Every :class:`~repro_torch.core.views.CompactView` is staged into one
    of a small fixed menu of padded ``(n_pad, e_pad)`` shapes
    (:class:`~repro_torch.core.views.BucketSpec`); a
    :class:`~repro_torch.core.views.GraphView` (the global strategy)
    stages the graph's base block, copied to the device once and reused.

    The trainer trains ``model`` itself, moved to ``device`` (the card
    unless ``device="cpu"``), after loading ``params`` (a ``state_dict``)
    when given. ``self.params`` maps parameter names to the live
    parameters, which the optimizer updates in place; after a step each
    parameter's ``.grad`` holds that step's gradient.
    """

    def __init__(self, model, g, opt, params: Optional[Mapping] = None,
                 buckets=None, slots: int = 2, gcn_norm: bool = True,
                 device=None, fault_policy=None, injector=None):
        self._init_common(opt, fault_policy, injector)
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device)
        self.g = g
        csc = model.aggregate_backend == "csc"
        self.stager = CompactBlockBuilder(
            g, model.K, buckets=buckets, slots=slots, gcn_norm=gcn_norm,
            csc_plan=csc, src_plan=csc)
        self.params = dict(self.model.named_parameters())
        self.opt_state = opt.init(self.params)
        # (n_pad, e_pad) -> steps run on blocks of that shape
        self.step_calls: dict = {}
        # staging fills per-bucket ring buffers: one fill at a time, and
        # the block is copied to the device before the lock releases
        self._stage_lock = threading.Lock()
        self._static: Optional[tuple] = None   # (GraphView, device block)

    def _prepare(self, view):
        with self._stage_lock:
            if self._static is not None and self._static[0] is view:
                return self._static[1]
            block = self.stager.stage(view).to(self.device, copy=True)
            if isinstance(view, GraphView):
                # a static view stages once; the step only reads it
                self._static = (view, block)
            return block

    def _make_prepare(self):
        return self._prepare

    def _dispatch(self, block) -> torch.Tensor:
        key = (block.num_nodes_padded, block.num_edges_padded)
        self.step_calls[key] = self.step_calls.get(key, 0) + 1
        self.model.zero_grad(set_to_none=True)
        loss = loss_block(self.model, block)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        self.opt.update(grads, self.opt_state, self.params)
        return loss.detach()

    @property
    def buckets_touched(self) -> set:
        return set(self.step_calls)

    def evaluate(self, view, mask: Optional[np.ndarray] = None) -> float:
        """Accuracy over ``view``'s block on ``mask`` (default: the
        graph's test mask, else the view's loss mask); a CompactView
        stages a tight-padded one-off block."""
        block = view.as_block(gcn_norm=self.stager.gcn_norm,
                              csc_plan=self.stager.csc_plan).to(self.device)
        if mask is None:
            mask = view.graph.test_mask
        if mask is not None:
            flat = np.asarray(mask).astype(np.float32)
            if isinstance(view, CompactView):   # global -> local ids
                flat = flat[view.nodes]
            m = np.zeros(block.num_nodes_padded, np.float32)
            m[:len(flat)] = flat
            m = torch.from_numpy(m).to(self.device)
        else:
            m = block.loss_mask
        with torch.no_grad():
            return float(accuracy_block(self.model, block, m))

    def assert_trace_contract(self) -> None:
        """Eager PyTorch compiles nothing per bucket, so there is no trace
        count to certify, as for serving's ``BucketedFn`` (ROADMAP C.5):
        this checks that the step ran, and ``step_calls`` counts steps per
        touched bucket. The certificate returns with CUDA graphs per
        bucket (ROADMAP A.7)."""
        if not self.step_calls:
            raise RetraceError(
                "train step never ran — call fit() before asserting the "
                "per-bucket contract")
