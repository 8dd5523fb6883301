"""The trainers and their fault-tolerant runtime (the counterpart of the
reference's ``core/trainer.py``): ``BaseTrainer``, the bucketed
single-device ``CompactTrainer`` and the engine ``Trainer``, which
drives the distributed engine (:mod:`repro_torch.core.engine`) with one
step captured once.

The paper's training strategies (global-, mini- and cluster-batch,
§2.3/§4.3) are all streams of views, so one loop drives every strategy:
each view is staged into a size-bucketed block (a
:class:`~repro_torch.core.views.CompactBlockBuilder` ring, or the graph's
base block with a dense view's masks), copied to the device, and run
through one step: forward, masked cross-entropy, ``backward()``,
optimizer update. On the card the Sum stage's forward and backward are
the CUDA kernels (:mod:`repro_torch.core.aggregate`), and the whole step
is one CUDA graph per bucket, captured once and replayed (the
reference's step compiled once per bucket, and its certificate,
:meth:`CompactTrainer.assert_compiled_per_bucket`).

Views are built ahead of the step by a pool of builder threads or of
sampler processes (:mod:`repro_torch.runtime`). View i is a pure
function of ``(seed, i)`` and the pools emit in index order, so the
trajectory is bit-identical for any worker count, in either mode, and
with prefetch off.

**Fault tolerance**: the trainer takes a ``fault_policy`` (retry and
backoff, per-stage timeouts, divergence action) and an ``injector``
(deterministic chaos for tests). View builds, device staging, step
dispatch and checkpoint saves and loads become retryable units; prefetch
workers are supervised; ``check_finite`` guards each step's loss and
``on_divergence`` picks ``raise | skip_view | rollback``.
``fit(..., resume=True)`` resumes from the newest *valid* checkpoint.
Every retried unit is a pure function of its inputs, so the trajectory
under injected faults is bit-identical to a fault-free run.

Unlike the reference's immutable arrays, the optimizer updates the
parameters and moments in place: undoing a step copies a snapshot back
into the live tensors, and a guarded step (only) takes that snapshot
first, so the default path copies nothing.

Usage::

    trainer = CompactTrainer(model, g, adam(5e-3))    # on the card
    out = trainer.fit(strategy_views(g, "mini", 2, compact=True), steps=30,
                      checkpoint_dir="ck", checkpoint_every=10)
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import math
import os
import threading
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (checkpoint_path, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.core.engine import VIEW_KEYS
from repro_torch.core.mpgnn import accuracy_block, loss_block
from repro_torch.core.strategies import shard_view
from repro_torch.core.views import (CompactBlockBuilder, CompactView,
                                    GlobalViewStream, GraphView, ViewStream)
from repro_torch.device import resolve_device
from repro_torch.graph.csr import GraphBlock, base_block
from repro_torch.optim.optimizers import write_scalars
from repro_torch.runtime.faults import (DivergenceError, FaultInjector,
                                        FaultPolicy, Retrier,
                                        TrainingInterrupted,
                                        sync_with_timeout, take_interrupt)
from repro_torch.runtime.prefetch import StreamPrefetcher, ViewPrefetcher
from repro_torch.runtime.procpool import (ProcessViewService,
                                          ProcPoolUnavailable,
                                          warn_unavailable_once)
from repro_torch.utils import trace
from repro_torch.weights import (opt_state_from_jax, opt_state_to_jax,
                                 params_from_jax, params_to_jax)

_END = object()


class RetraceError(AssertionError):
    """The step's per-bucket contract was broken (or never exercised)."""


def _assert_once_per_bucket(traces: int, touched: int, what: str) -> None:
    """The bucketed contract, shared by the train step
    (:meth:`CompactTrainer.assert_compiled_per_bucket`) and the serving
    paths (:class:`~repro_torch.serving.server.BucketedFn`): exactly one
    capture (the reference's trace) per touched bucket shape."""
    if touched == 0:
        raise RetraceError(
            f"{what} never ran — exercise it before asserting the "
            "once-per-bucket contract")
    if traces != touched:
        raise RetraceError(
            f"{what} was captured {traces} times over {touched} touched "
            f"bucket shapes (expected exactly one capture per bucket): "
            "an input was staged with a shape or layout not determined by "
            "its bucket")


def block_tensors(block: GraphBlock) -> tuple:
    """A block's tensors in a fixed order: its fields, then each plan's;
    absent ones are skipped (see :func:`block_layout`)."""
    out = []
    for f in dataclasses.fields(block):
        v = getattr(block, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif v is not None:        # a plan
            out.extend((v.perm, v.indptr, v.edge_dst, v.piece_ptr))
    return tuple(out)


def block_layout(block: GraphBlock) -> tuple:
    """Which of a block's fields are present, and its tensors' shapes: with
    the bucket, what a captured graph's inputs must match."""
    return tuple((f.name, getattr(block, f.name) is not None)
                 for f in dataclasses.fields(block)) + tuple(
        tuple(t.shape) for t in block_tensors(block))


def static_block(block: GraphBlock, keep=frozenset()) -> GraphBlock:
    """A copy of ``block`` on its device that a captured graph reads:
    fresh tensors, except those whose storage is in ``keep`` (tensors that
    never change, such as the graph's base block on the device), which it
    shares."""
    def own(t):
        return t if t.data_ptr() in keep else t.clone()
    moved = {}
    for f in dataclasses.fields(block):
        v = getattr(block, f.name)
        if isinstance(v, torch.Tensor):
            moved[f.name] = own(v)
        elif v is not None:
            moved[f.name] = dataclasses.replace(
                v, perm=own(v.perm), indptr=own(v.indptr),
                edge_dst=own(v.edge_dst), piece_ptr=own(v.piece_ptr))
    return dataclasses.replace(block, **moved)


def load_block(static: GraphBlock, block: GraphBlock) -> None:
    """Copy ``block`` into the captured graph's inputs ``static`` (the
    same layout) on the current stream; shared tensors are skipped."""
    with torch.no_grad():
        for dst, src in zip(block_tensors(static), block_tensors(block)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)


def load_view(static: dict, view: dict) -> None:
    """:func:`load_block` for a dict of tensors (the engine's staged
    view)."""
    with torch.no_grad():
        for k, dst in static.items():
            if dst.data_ptr() != view[k].data_ptr():
                dst.copy_(view[k])


class CapturedStep:
    """One bucket's captured graph: the inputs it reads (``static``), the
    outputs it writes, and what one replay counts (``counts``: kernel
    launches by kernel name, and the bytes its collectives send by
    ``comm.<collective>.bytes``; :mod:`repro_torch.utils.trace`).
    ``load`` copies a staged input into ``static``."""

    def __init__(self, graph, static, out, counts: dict,
                 load=load_block):
        self.graph = graph
        self.static = static
        self.out = out
        self.counts = counts
        self.load = load

    def replay(self, block):
        """Load ``block`` into the inputs and replay; the outputs stay
        valid until the next replay."""
        self.load(self.static, block)
        self.graph.replay()
        trace.add(self.counts)
        return self.out


@contextlib.contextmanager
def _no_collection():
    """Python's cycle collector held off for the block, after one
    collection. A collection inside a capture may free an unreachable
    captured graph, whose ``cudaGraphExecDestroy`` is not permitted while
    a stream captures: it invalidates the capture (CUDA error 901 at the
    next launch, ROADMAP C.22)."""
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def capture(fn, static, side, lock=None, load=load_block) -> CapturedStep:
    """Capture ``fn(static)`` into a CUDA graph on the stream ``side``
    (the one its warm-up ran on), holding ``lock`` so that no staging
    thread touches the device meanwhile, and the cycle collector off
    (:func:`_no_collection`). A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    with (lock or contextlib.nullcontext()), trace.capture_tally() as tally, \
            _no_collection():
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = fn(static)
    return CapturedStep(graph, static, out, dict(tally), load)


def warm_up(fn, static: GraphBlock, side):
    """Run ``fn(static)`` eagerly on the stream ``side`` (PyTorch's
    warm-up before a capture on it) and hand its result back to the
    current stream."""
    cur = torch.cuda.current_stream(side.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(static)
    cur.wait_stream(side)
    return out


def _make_runtime(fault_policy: Optional[FaultPolicy],
                  injector: Optional[FaultInjector]) -> Optional[Retrier]:
    """A Retrier when any fault handling is configured, else None (the
    production default: no retry wrappers, no per-step loss sync)."""
    if fault_policy is None and injector is None:
        return None
    return Retrier(fault_policy or FaultPolicy(), injector)


class BaseTrainer:
    """The shared trainer surface: the ``fit`` loop (prefetch pipelines,
    loss sync policy, divergence handling, eval and checkpoint cadence,
    its spans) and ``save``/``restore``/``reset``. Subclasses
    provide ``_make_prepare()`` (a ``view -> staged`` callable, which
    prefetch workers call concurrently), ``_dispatch(staged)`` (one step,
    returning the loss as a tensor on the device), ``evaluate`` and
    ``assert_trace_contract``, and hold ``params`` (``state_dict`` names
    to the live parameters) and ``opt_state``."""

    def _init_common(self, opt, prefetch_depth: int,
                     fault_policy: Optional[FaultPolicy],
                     injector: Optional[FaultInjector]) -> None:
        self.opt = opt
        self.runtime = _make_runtime(fault_policy, injector)
        self.step_num = 0
        self.history: list = []
        self.prefetch_depth = prefetch_depth
        # the view stream's position, checkpointed so that restore() can
        # move the stream itself
        self.view_cursor = 0
        self._resume_cursor: Optional[int] = None

    def _make_prepare(self):
        raise NotImplementedError

    def _dispatch(self, staged):
        raise NotImplementedError

    def evaluate(self, view, mask: Optional[np.ndarray] = None) -> float:
        raise NotImplementedError

    def assert_trace_contract(self) -> None:
        raise NotImplementedError

    # -- the training loop ----------------------------------------------------

    def fit(self, views, steps: Optional[int] = None,
            prefetch: bool = True, prefetch_workers: Optional[int] = None,
            prefetch_mode: str = "thread",
            eval_every: int = 0, eval_view=None,
            eval_mask: Optional[np.ndarray] = None,
            checkpoint_every: int = 0,
            checkpoint_dir: Optional[str] = None,
            keep_checkpoints: Optional[int] = None,
            max_in_flight: int = 2,
            log_every: int = 0, log=print,
            resume: bool = False) -> dict:
        """Run ``steps`` views (all of ``views`` if None) through the
        step. Returns ``{"losses", "evals", "steps", "events"}``.

        Losses stay on the device: before dispatching step *i* the loop
        reads the loss of step *i - max_in_flight* (one scalar wait, which
        bounds how far the host runs ahead of the device), and the rest
        are read at the end.

        Each step's host time is in three spans
        (:mod:`repro_torch.utils.trace`): ``step.stage_wait``, the wait
        for the next staged view; ``step.loss_wait``, each read of a
        loss; ``step.dispatch``, the step's launch or replay (a bucket's
        first holds ``step.warm_up`` and ``step.capture``).

        ``resume=True`` restores the newest *valid* checkpoint in
        ``checkpoint_dir`` first (a fresh start if there is none) and
        moves a ViewStream to its recorded cursor. With a policy whose
        ``check_finite`` is on, or whose ``on_divergence`` is not
        ``"raise"``, every step's loss is read and guarded: a non-finite
        loss undoes the step, then ``skip_view`` moves on and
        ``rollback`` restores the last valid checkpoint and continues past
        the poison view. A ``step`` timeout arms a watchdog around the
        loss read. ``keep_checkpoints`` is the retention of ``save``.
        A signal handler's :func:`~repro_torch.runtime.faults.
        request_interrupt` raises ``TrainingInterrupted`` between steps,
        never inside one.

        Over an indexable :class:`ViewStream` with ``prefetch`` on, views
        are built by ``prefetch_workers`` builder threads (``"thread"``,
        default ``min(4, cpu_count - 1)``) or sampler processes
        (``"process"``, :class:`~repro_torch.runtime.procpool.
        ProcessViewService`; where shared memory is unavailable it
        degrades to threads with one warning). The trajectory is
        bit-identical for any worker count, either mode and
        ``prefetch=False``. A :class:`GlobalViewStream` (one static view)
        is staged inline, since a pool would only hand back the same
        block. Plain iterators use the single-thread double-buffered
        pipeline. After a fit the stream's cursor counts
        the views the loop consumed, not those built ahead."""
        rt = self.runtime
        if prefetch_mode not in ("thread", "process"):
            raise ValueError(f"prefetch_mode={prefetch_mode!r} — expected "
                             "'thread' or 'process'")
        if resume and checkpoint_dir and latest_step(checkpoint_dir) \
                is not None:
            self.restore(checkpoint_dir)
        prepare = self._make_prepare()
        stream = views if isinstance(views, ViewStream) else None
        # any fit consumes a pending restore cursor, so that it cannot
        # move a later, unrelated stream
        resume_cur, self._resume_cursor = self._resume_cursor, None
        if stream is not None and resume_cur is not None \
                and stream.cursor < resume_cur:
            stream.seek(resume_cur)
        staged_iter = self._staged_views(views, stream, prepare, steps,
                                         prefetch, prefetch_workers,
                                         prefetch_mode)
        policy = rt.policy if rt is not None else None
        inj = rt.injector if rt is not None else None
        # the finite guard reads every loss (serialising host and device):
        # on only when asked for, or when the divergence action needs it
        guard = policy is not None and (policy.check_finite
                                        or policy.on_divergence != "raise")
        watchdog = policy.timeout("step") if policy is not None else None
        sync_now = guard or watchdog is not None
        events = rt.events if rt is not None else []
        losses, pending, evals = [], [], []
        try:
            # idx counts the views this fit consumed, monotonic across a
            # rollback, so a keyed "diverge" fires once per poison view
            for idx in itertools.count():
                with trace.span("step.stage_wait"):
                    # the state is whole here: the last step's update,
                    # counters and checkpoint are done
                    signum = take_interrupt()
                    if signum is not None:
                        raise TrainingInterrupted(signum)
                    staged = next(staged_iter, _END)
                if staged is _END:
                    break
                if max_in_flight > 0 and len(pending) >= max_in_flight:
                    with trace.span("step.loss_wait"):
                        losses.append(float(pending.pop(0)))
                with trace.span("step.dispatch"):
                    prev = self._snapshot() if guard else None
                    if rt is None:
                        loss = self._dispatch(staged)
                    else:
                        # a transient failure re-dispatches the same
                        # (params, staged): the injected fault fires
                        # before the step
                        loss = rt("step", lambda: self._dispatch(staged),
                                  key=self.step_num)
                    self.step_num += 1
                    self.view_cursor = (stream.cursor if stream is not None
                                        else self.step_num)
                if sync_now:
                    with trace.span("step.loss_wait"):
                        loss_val = sync_with_timeout(lambda: float(loss),
                                                     watchdog)
                    if inj is not None and inj.fires("diverge", key=idx):
                        loss_val = float("nan")   # simulated divergence
                    if guard and not math.isfinite(loss_val):
                        self._diverged(prev, loss_val, checkpoint_dir,
                                       events)
                        continue
                    losses.append(loss_val)
                else:
                    pending.append(loss)
                if (eval_every and eval_view is not None
                        and self.step_num % eval_every == 0):
                    rec = {"step": self.step_num, "loss": float(loss),
                           "eval_acc": self.evaluate(eval_view, eval_mask)}
                    evals.append(rec)
                    if log_every:
                        log(f"step {rec['step']:5d}  loss {rec['loss']:.4f}"
                            f"  eval_acc {rec['eval_acc']:.4f}")
                if (checkpoint_every and checkpoint_dir
                        and self.step_num % checkpoint_every == 0):
                    self.save(checkpoint_dir, keep_checkpoints)
        finally:
            if isinstance(staged_iter, (ViewPrefetcher, StreamPrefetcher,
                                        ProcessViewService)):
                staged_iter.close()
            if isinstance(staged_iter, ProcessViewService) and rt is None:
                # with a runtime the service already appended its
                # supervision events into rt.events
                events.extend(staged_iter.events)
        with trace.span("step.loss_wait"):
            losses.extend(float(x) for x in pending)
        self.history.extend(evals)
        return {"losses": losses, "evals": evals, "steps": self.step_num,
                "events": list(events)}

    def _staged_views(self, views, stream, prepare, steps, prefetch,
                      workers, mode):
        """The iterator of staged views for one fit."""
        rt = self.runtime
        # inline staging is still a retryable view_build stage under a
        # runtime (the prefetchers wrap build and prepare themselves)
        prep = prepare if rt is None else (
            lambda v: rt("view_build", lambda: prepare(v)))
        if stream is None:
            if steps is not None:
                views = itertools.islice(views, steps)
            if prefetch:
                return ViewPrefetcher(views, prepare, self.prefetch_depth,
                                      runtime=rt)
            return (prep(v) for v in views)
        if not prefetch or isinstance(stream, GlobalViewStream):
            bounded = (itertools.islice(stream, steps) if steps is not None
                       else stream)
            return (prep(v) for v in bounded)
        if workers is None:
            workers = max(1, min(4, (os.cpu_count() or 2) - 1))
        if mode == "process":
            try:
                return ProcessViewService(stream, prepare, steps,
                                          workers=workers,
                                          depth=self.prefetch_depth,
                                          runtime=rt)
            except ProcPoolUnavailable as e:
                warn_unavailable_once(str(e))
        return StreamPrefetcher(stream, prepare, steps, workers=workers,
                                depth=self.prefetch_depth, runtime=rt)

    # -- state: snapshots, divergence, checkpoints ----------------------------

    def _snapshot(self) -> tuple:
        """A copy of (parameters, optimizer state, step): the optimizer
        writes in place, so this is what undoing a step needs."""
        with torch.no_grad():
            params = {k: p.detach().clone() for k, p in self.params.items()}
            state = {k: ({n: t.clone() for n, t in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in self.opt_state.items()}
        return params, state, self.step_num

    def _load_state(self, params: Mapping, opt_state: Mapping,
                    step_num: int) -> None:
        """Copy a state into the live parameters and moments. The model
        trains the tensors in ``self.params``: rebinding them would leave
        it training the old ones."""
        for what, want, have in (
                ("params", set(params), set(self.params)),
                ("optimizer state", set(opt_state), set(self.opt_state))):
            if want != have:
                raise ValueError(
                    f"{what} do not match the trainer's: missing "
                    f"{sorted(have - want)}, unexpected {sorted(want - have)}")
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(params[k])
            for k, v in opt_state.items():
                if isinstance(v, dict):
                    live = self.opt_state[k]
                    if set(v) != set(live):
                        raise ValueError(f"optimizer state {k!r} does not "
                                         "match the parameters")
                    for n, t in v.items():
                        live[n].copy_(t)
                else:
                    self.opt_state[k] = v
        self.step_num = int(step_num)

    def _diverged(self, prev: tuple, loss_val: float,
                  checkpoint_dir: Optional[str], events: list) -> None:
        """Apply ``runtime.policy.on_divergence`` to a non-finite step:
        the poison update is undone first (``prev`` is the pre-step
        snapshot)."""
        self._load_state(*prev)
        action = self.runtime.policy.on_divergence
        events.append({"stage": "diverge", "step": prev[2] + 1,
                       "loss": loss_val, "action": action,
                       "view_cursor": self.view_cursor})
        if action == "skip_view":
            return   # poison view consumed, update undone: move on
        if action == "rollback":
            if checkpoint_dir:
                try:
                    # falls back past any corrupt file to the newest valid
                    self.restore(checkpoint_dir)
                except FileNotFoundError:
                    # no checkpoint yet: the raise below says so
                    pass  # lint: waive=src.silent-except
                else:
                    # the stream already stands past the poison view; the
                    # restored cursor must not rewind a later fit
                    self._resume_cursor = None
                    return
            raise DivergenceError(
                f"non-finite loss {loss_val} at step {prev[2] + 1} with "
                "on_divergence='rollback' but no valid checkpoint to "
                "roll back to (pass checkpoint_dir and checkpoint_every)")
        raise DivergenceError(
            f"non-finite loss {loss_val} at step {prev[2] + 1} "
            f"(view cursor {self.view_cursor})")

    def save(self, directory: str, keep: Optional[int] = None) -> str:
        """Write ``step_<N>.npz`` in the reference's tree and format
        (``params`` and ``opt_state`` as the JAX package holds them, and
        int64 ``step`` and ``view_cursor``), so either package loads it,
        keeping the newest ``keep`` (0 = all; None = the policy's
        ``keep_checkpoints``, all without a policy)."""
        rt = self.runtime
        if keep is None:
            keep = rt.policy.keep_checkpoints if rt is not None else 0

        def do():
            return save_checkpoint(directory, self.step_num, {
                "params": params_to_jax(self.params),
                "opt_state": opt_state_to_jax(self.opt_state),
                "step": np.asarray(self.step_num, np.int64),
                "view_cursor": np.asarray(self.view_cursor, np.int64),
            }, keep=keep)

        if rt is None:
            return do()
        # a failed save never poisons disk (atomic rename): retry it
        return rt("checkpoint_save", do)

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Load parameters, optimizer state and step from a checkpoint of
        either package (the newest valid one unless ``step`` is given),
        into the live tensors. The next ``fit`` over a
        :class:`ViewStream` moves the stream to the checkpoint's
        cursor."""
        rt = self.runtime
        if rt is None:
            ck = load_checkpoint(directory, step)
        else:
            ck = rt("checkpoint_load",
                    lambda: load_checkpoint(directory, step))
        self._load_state(params_from_jax(ck["params"]),
                         opt_state_from_jax(ck["opt_state"]),
                         int(ck["step"]))
        if "view_cursor" in ck:      # older checkpoints predate the key
            self.view_cursor = int(ck["view_cursor"])
            self._resume_cursor = self.view_cursor
        return self.step_num

    def _record_step(self, staged, static=None, load=None):
        """The OpLog (:mod:`repro_torch.analysis.oplog`) of ``_step`` over
        ``staged`` as a captured step runs it: its update reads the
        optimizer's scalars from the tensor written before (as before
        each replay), and with ``static`` (a capture's inputs) the step
        first loads ``staged`` into them with ``load``. The step runs
        eagerly and is undone: parameters, gradients and optimizer state
        are put back; no counter is touched."""
        from repro_torch.analysis.oplog import record_ops
        if self._scal is None:
            self._scal = torch.zeros(len(self.opt.scalars(self.opt_state)),
                                     dtype=torch.float32, device=self.device)
        write_scalars(self._scal, self.opt.scalars(self.opt_state))

        def update(grads):
            self.opt.apply(grads, self.opt_state, self.params, self._scal)

        def loaded():
            load(static, staged)
            return self._step(static, update)

        state = self._snapshot()
        grads = {k: p.grad for k, p in self.params.items()}
        try:
            if static is None:
                return record_ops(self._step, staged, update)[1]
            inputs = (block_tensors(static) if isinstance(static, GraphBlock)
                      else tuple(static.values()))
            return record_ops(loaded, static=inputs)[1]
        finally:
            self._load_state(*state)
            for k, p in self.params.items():
                p.grad = grads[k]

    def reset(self, params: Optional[Mapping] = None) -> None:
        """Fresh optimizer state and counters, with ``params`` (a
        ``state_dict``; default: the parameters the trainer started
        from) copied into the live parameters, and the fresh moments into
        the live ones (a captured step keeps reading both)."""
        self._load_state(params if params is not None else self._initial,
                         self.opt.init(self.params), 0)
        self.history = []
        self.view_cursor = 0
        self._resume_cursor = None


class CompactTrainer(BaseTrainer):
    """Single-device trainer over size-bucketed blocks.

    Every :class:`~repro_torch.core.views.CompactView` is staged into one
    of a small fixed menu of padded ``(n_pad, e_pad)`` shapes
    (:class:`~repro_torch.core.views.BucketSpec`). A
    :class:`~repro_torch.core.views.GraphView` (the global view, or a
    dense mini or cluster view) is the whole graph, the dense path's one
    bucket: the graph's base block (features, edges, norms, plans) goes to
    the device once, and a view copies only its masks.

    On the card (``cuda_graphs=True``, the default there) the step is
    captured once per bucket into a CUDA graph, the counterpart of the
    reference's step compiled once per bucket: the bucket's first step
    runs eagerly on a side stream (the warm-up), then forward, backward
    and the optimizer update are captured together over the bucket's
    input buffers; every later step in the bucket copies its staged block
    into those buffers and replays. Replays compute what eager steps
    compute, bit for bit. ``cuda_graphs=False`` runs every step eagerly,
    as the CPU always does. Evaluation stays eager.

    The trainer trains ``model`` itself, moved to ``device`` (the card
    unless ``device="cpu"``), after loading ``params`` (a ``state_dict``)
    when given. ``self.params`` maps parameter names to the live
    parameters, which the optimizer updates in place; after a step each
    parameter's ``.grad`` holds that step's gradient.
    """

    def __init__(self, model, g, opt, params: Optional[Mapping] = None,
                 buckets=None, slots: int = 2, gcn_norm: bool = True,
                 device=None, prefetch_depth: int = 2,
                 fault_policy: Optional[FaultPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 cuda_graphs: bool = True):
        self._init_common(opt, prefetch_depth, fault_policy, injector)
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
        # what reset() goes back to, on the host
        self._initial = {k: p.detach().cpu().clone()
                         for k, p in self.params.items()}
        # (n_pad, e_pad) -> steps run on blocks of that shape
        self.step_calls: dict = {}
        # staging fills per-bucket ring buffers, and prefetch workers call
        # _prepare concurrently: one fill at a time, and the block is
        # copied to the device before the lock releases. The copy from
        # pageable memory returns once the host buffer has been read, so
        # the next fill of the slot cannot race it; the copy and the step
        # go to the same (default) stream, so the step reads it complete.
        # A capture holds it too, so no staging touches the device then
        self._stage_lock = threading.Lock()
        self._static: Optional[tuple] = None   # (global view, its block)
        self._base: Optional[tuple] = None     # (host base, device base)
        self.graphs_on = bool(cuda_graphs) and self.device.type == "cuda"
        self.captures: dict = {}
        """(n_pad, e_pad) -> graphs captured for that bucket; the engine
        ``Trainer`` keeps its count in ``trace_counts["train_step"]``."""
        self._graphs: dict = {}     # (bucket, layout) -> CapturedStep
        self._side = None           # the warm-up and capture stream
        self._scal = None           # the optimizer's scalars, on the card

    def _prepare(self, view):
        with self._stage_lock:
            if self._static is not None and self._static[0] is view:
                return self._static[1]
            rt = self.runtime
            put = (self._to_device if rt is None else
                   lambda v: rt("device_put", lambda: self._to_device(v)))
            block = put(view)
            if (isinstance(view, GraphView) and view.node_active is None
                    and view.edge_active is None):
                # the global view is static: it stages once
                self._static = (view, block)
            return block

    def _to_device(self, view) -> GraphBlock:
        """The view's staged block on the device. A GraphView shares the
        graph's base block, which goes to the device once, and copies its
        masks."""
        host = self.stager.stage(view)
        if not isinstance(view, GraphView):
            return host.to(self.device, copy=True)
        base = base_block(view.graph, gcn_norm=self.stager.gcn_norm,
                          csc_plan=self.stager.csc_plan)
        if self._base is None or self._base[0] is not base:
            self._base = (base, base.to(self.device, copy=True))

        def put(t):
            return None if t is None else t.to(self.device, copy=True)
        return dataclasses.replace(
            self._base[1], loss_mask=put(host.loss_mask),
            node_active=put(host.node_active),
            edge_active=put(host.edge_active))

    def _make_prepare(self):
        return self._prepare

    def _step(self, block, update) -> torch.Tensor:
        """Forward, backward and ``update(grads)``."""
        self.model.zero_grad(set_to_none=True)
        loss = loss_block(self.model, block)
        loss.backward()
        update({k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in self.params.items()})
        return loss.detach()

    def _dispatch(self, block) -> torch.Tensor:
        key = (block.num_nodes_padded, block.num_edges_padded)
        self.step_calls[key] = self.step_calls.get(key, 0) + 1
        if not self.graphs_on:
            return self._step(block, lambda grads: self.opt.update(
                grads, self.opt_state, self.params))
        if self._scal is None:
            self._scal = torch.zeros(len(self.opt.scalars(self.opt_state)),
                                     dtype=torch.float32, device=self.device)
            self._side = torch.cuda.Stream(self.device)
        write_scalars(self._scal, self.opt.scalars(self.opt_state))
        gkey = (key, block_layout(block))
        step = self._graphs.get(gkey)
        if step is None:
            loss = self._first_step(key, gkey, block)
        else:
            loss = step.replay(block)[0].clone()
            for k, p in self.params.items():
                p.grad = step.out[1][k]
        self.opt_state["step"] += 1
        return loss

    def _kept(self) -> frozenset:
        """The storages a captured step shares instead of copying per
        step, since they never change: the graph's base block on the
        device, and the global view's block."""
        fixed = [b for b in (self._base and self._base[1],
                             self._static and self._static[1]) if b]
        return frozenset(t.data_ptr() for b in fixed
                         for t in block_tensors(b) if t.data_ptr())

    def _first_step(self, key, gkey, block) -> torch.Tensor:
        """A bucket's first step: eager on the side stream, through the
        bucket's own input buffers; then the capture over them."""
        static = static_block(block, self._kept())

        def body(b):
            # the update reads the optimizer's scalars from the tensor
            # that each replay's write_scalars refreshes
            loss = self._step(b, lambda grads: self.opt.apply(
                grads, self.opt_state, self.params, self._scal))
            return loss, {k: p.grad for k, p in self.params.items()}

        with trace.span("step.warm_up"):
            loss, grads = warm_up(body, static, self._side)
        self.model.zero_grad(set_to_none=True)   # the graph owns its grads
        with trace.span("step.capture"):
            self._graphs[gkey] = capture(body, static, self._side,
                                         self._stage_lock)
        self.captures[key] = self.captures.get(key, 0) + 1
        for k, p in self.params.items():
            p.grad = grads[k]
        return loss

    @property
    def buckets_touched(self) -> set:
        return set(self.step_calls)

    def evaluate(self, view, mask: Optional[np.ndarray] = None) -> float:
        """Accuracy over ``view``'s block on ``mask`` (default: the
        graph's test mask, else the view's loss mask); a CompactView
        stages a tight-padded one-off block. Eager, never captured."""
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

    def assert_compiled_per_bucket(self) -> None:
        """The reference's certificate: under CUDA graphs, exactly one
        capture per touched bucket, so repeat epochs over the same
        buckets add none. Eager (the CPU, or ``cuda_graphs=False``),
        nothing is captured, and it checks that the step ran."""
        touched = len(self.buckets_touched)
        if self.graphs_on:
            _assert_once_per_bucket(sum(self.captures.values()), touched,
                                    "train step")
        elif touched == 0:
            _assert_once_per_bucket(0, 0, "train step")

    def assert_trace_contract(self) -> None:
        self.assert_compiled_per_bucket()

    # -- static analysis hooks ------------------------------------------------

    def expected_static(self, view) -> int:
        """How many tensors of ``view``'s staged block a captured step
        loads into its static inputs per step (the ``ops.static-inputs``
        contract, the counterpart of the reference's
        ``expected_donated``): under CUDA graphs every tensor the capture
        does not share (the base block and the global view's block never
        change); eagerly, as on the CPU, none."""
        if not self.graphs_on:
            return 0
        keep = self._kept()
        return sum(1 for t in block_tensors(self._prepare(view))
                   if t.data_ptr() and t.data_ptr() not in keep)

    def traced_step_ops(self, view):
        """The OpLog of one step over ``view``'s staged block, as the
        captured step runs it: forward, backward and the optimizer's
        update, and under CUDA graphs first the load of the block into
        the capture's static inputs (:meth:`BaseTrainer._record_step`).
        Parameters, gradients, optimizer state, ``step_calls`` and the
        capture counters are left as they were, so analysis cannot change
        the once-per-bucket certificate."""
        block = self._prepare(view)
        if not self.graphs_on:
            return self._record_step(block)
        key = (block.num_nodes_padded, block.num_edges_padded)
        step = self._graphs.get((key, block_layout(block)))
        static = (step.static if step is not None
                  else static_block(block, self._kept()))
        return self._record_step(block, static, load_block)


class Trainer(BaseTrainer):
    """Drives any view stream through a
    :class:`~repro_torch.core.engine.HybridParallelEngine` with one
    shape-stable step (the counterpart of the reference's engine
    ``Trainer``).

    The step's shapes are fixed by the partition plan — ``(P, K,
    n_m_pad)`` node masks, ``(P, K, e_pad)`` edge masks, ``(P, n_m_pad)``
    loss masks — so global, mini and cluster views, dense or compact, all
    run the same step. On the card (``cuda_graphs=True``, the default
    there, over a capturable communicator) the step — forward over every
    shard, halo exchanges, backward, NN-Reduce and the optimizer update —
    is captured once into a CUDA graph, the counterpart of the
    reference's step compiled once: the first step runs eagerly on a side
    stream, then the capture; every later step copies its staged masks
    into the captured inputs and replays. ``trace_counts`` counts the
    captures of the step and of ``infer`` (evaluation runs eagerly, so
    none); :meth:`assert_compiled_once` is the reference's certificate.

    The trainer trains the engine's model, after loading ``params`` (a
    ``state_dict``) when given; ``self.params`` maps names to the live
    parameters, which the optimizer updates in place.

    Over a :class:`~repro_torch.core.comm.ProcessGroupComm` every rank
    runs this trainer on its own partitions: each captures the same step,
    whose collectives come in the same order on every rank (NCCL's
    capture needs the eager first step to have connected the peers); the
    loss is the group's, the same bits on every rank, so every rank
    takes the same divergence decision; evaluation gathers every
    partition's logits on every rank; rank 0 writes the checkpoints and
    the others wait for the file (:meth:`save`), and every rank reads it
    back on ``resume``.
    """

    def __init__(self, engine, opt, params: Optional[Mapping] = None,
                 prefetch_depth: int = 2,
                 fault_policy: Optional[FaultPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 cuda_graphs: bool = True):
        self.engine = engine
        self.plan = engine.plan
        self._init_common(opt, prefetch_depth, fault_policy, injector)
        self.device = engine.device
        self.model = engine.model
        if params is not None:
            self.model.load_state_dict(params)
        self.params = dict(self.model.named_parameters())
        self.opt_state = opt.init(self.params)
        self._initial = {k: p.detach().cpu().clone()
                         for k, p in self.params.items()}
        self.trace_counts = {"train_step": 0, "infer": 0}
        """Captures of the step and of ``infer``; ``CompactTrainer`` keeps
        its step's by bucket in ``captures``."""
        self.steps_run = 0
        self.graphs_on = (bool(cuda_graphs) and self.device.type == "cuda"
                          and engine.comm.capturable)
        # builder threads copy staged views to the device; a capture
        # holds the lock so that none does meanwhile
        self._stage_lock = threading.Lock()
        self._graph: Optional[CapturedStep] = None
        self._side = None           # the warm-up and capture stream
        self._scal = None           # the optimizer's scalars, on the card
        self._infer = engine.make_infer()
        # one-slot (view, sharded arrays) cache; holding the view itself
        # keeps the identity check sound
        self._eval_cache: Optional[tuple] = None

    # -- BaseTrainer hooks ----------------------------------------------------

    def _make_prepare(self):
        rt = self.runtime

        def stage(v):
            arrays = shard_view(self.plan, v)
            with self._stage_lock:
                return self.engine.stage_view(arrays, retry=rt)

        # a static stream (the global strategy yields one view object) is
        # staged once: the staged tensors are only read, and prefetch
        # workers that race here at worst stage it twice
        cache = {"view": None, "staged": None}

        def prepare(v):
            if cache["view"] is v:
                return cache["staged"]
            staged = stage(v)
            cache["staged"] = staged
            cache["view"] = v
            return staged

        return prepare

    def _step(self, view: dict, update) -> torch.Tensor:
        loss, grads = self.engine.make_loss_and_grad()(view)
        update(grads)
        return loss

    def _dispatch(self, staged) -> torch.Tensor:
        self.steps_run += 1
        if not self.graphs_on:
            return self._step(staged, lambda grads: self.opt.update(
                grads, self.opt_state, self.params))
        if self._scal is None:
            self._scal = torch.zeros(len(self.opt.scalars(self.opt_state)),
                                     dtype=torch.float32, device=self.device)
            self._side = torch.cuda.Stream(self.device)
        write_scalars(self._scal, self.opt.scalars(self.opt_state))
        if self._graph is None:
            loss = self._first_step(staged)
        else:
            out = self._graph.replay(staged)
            loss = out[0].clone()
            for k, p in self.params.items():
                p.grad = out[1][k]
        self.opt_state["step"] += 1
        return loss

    def _first_step(self, staged: dict) -> torch.Tensor:
        """The first step: eager on the side stream through the captured
        inputs, then the capture over them."""
        static = {k: v.clone() for k, v in staged.items()}

        def body(view):
            # the update reads the optimizer's scalars from the tensor
            # that each replay's write_scalars refreshes
            loss = self._step(view, lambda grads: self.opt.apply(
                grads, self.opt_state, self.params, self._scal))
            return loss, {k: p.grad for k, p in self.params.items()}

        with trace.span("step.warm_up"):
            loss, grads = warm_up(body, static, self._side)
        self.model.zero_grad(set_to_none=True)   # the graph owns its grads
        with trace.span("step.capture"):
            self._graph = capture(body, static, self._side,
                                  self._stage_lock, load=load_view)
        self.trace_counts["train_step"] += 1
        for k, p in self.params.items():
            p.grad = grads[k]
        return loss

    def save(self, directory: str, keep: Optional[int] = None) -> str:
        """:meth:`BaseTrainer.save` by the group's rank 0 (every rank
        holds the same state); every rank returns once the file is in
        place."""
        comm = self.engine.comm
        path = (super().save(directory, keep) if comm.rank == 0
                else checkpoint_path(directory, self.step_num))
        comm.barrier()
        return path

    def reset(self, params: Optional[Mapping] = None) -> None:
        """:meth:`BaseTrainer.reset`, keeping the captured step; the eval
        cache is dropped."""
        super().reset(params)
        self._eval_cache = None

    def assert_trace_contract(self) -> None:
        self.assert_compiled_once()

    # -- eval -----------------------------------------------------------------

    def evaluate(self, view, mask: Optional[np.ndarray] = None) -> float:
        """Distributed inference over ``view``; accuracy on ``mask``
        (default: the graph's test mask, else the view's loss mask)."""
        if self._eval_cache is None or self._eval_cache[0] is not view:
            self._eval_cache = (view, shard_view(self.plan, view))
        logits = self._infer(self._eval_cache[1])
        preds = self.engine.gather_predictions(logits).argmax(-1)
        g = view.graph
        if mask is None:
            dense = view.to_dense() if isinstance(view, CompactView) \
                else view
            mask = (g.test_mask if g.test_mask is not None
                    else dense.loss_mask > 0)
        mask = np.asarray(mask) > 0
        if not mask.any():
            return 0.0
        return float((preds[mask] == g.labels[mask]).mean())

    # -- contracts ------------------------------------------------------------

    def assert_compiled_once(self) -> None:
        """The reference's certificate: after any number of steps across
        any mix of strategies, the step was captured exactly once (under
        CUDA graphs) and ``infer`` at most once. Eager (the CPU, or
        ``cuda_graphs=False``), nothing is captured, and it checks that
        the step ran."""
        n = self.trace_counts["train_step"]
        if self.steps_run == 0:
            raise RetraceError(
                "assert_compiled_once: the train step never ran — call "
                "fit() before asserting the contract")
        if self.graphs_on and n != 1:
            raise RetraceError(
                f"train step was captured {n} times (expected exactly 1): "
                "view arrays must come from shard_view over one "
                "PartitionPlan")
        if self.trace_counts["infer"] > 1:
            raise RetraceError(
                f"eval infer was captured {self.trace_counts['infer']} "
                "times (expected at most 1)")

    # -- static analysis hooks ------------------------------------------------

    def expected_static(self, view=None) -> int:
        """How many staged view tensors a captured step loads into its
        static inputs per step (the ``ops.static-inputs`` contract, the
        counterpart of the reference's ``expected_donated``): the view's
        masks under CUDA graphs, none eagerly (as on the CPU). The same
        for every view."""
        return len(VIEW_KEYS) if self.graphs_on else 0

    def traced_step_ops(self, view):
        """The OpLog of one step over ``view``, staged as ``fit`` stages
        it, run as the captured step runs it: forward over every shard,
        halo exchanges, backward, NN-Reduce and the optimizer's update,
        and under CUDA graphs first the load of the view into the
        capture's static inputs (:meth:`BaseTrainer._record_step`).
        Parameters, gradients, optimizer state, ``trace_counts`` and
        ``steps_run`` are left as they were (the compiled-once
        certificate must survive analysis)."""
        staged = self.engine.stage_view(shard_view(self.plan, view))
        if not self.graphs_on:
            return self._record_step(staged)
        static = (self._graph.static if self._graph is not None
                  else {k: v.clone() for k, v in staged.items()})
        return self._record_step(staged, static, load_view)

    def traced_infer_ops(self, view):
        """The OpLog of the eval/infer computation over ``view``'s staged
        arrays (the staging itself is not part of it)."""
        from repro_torch.analysis.oplog import record_ops
        staged = self.engine.stage_view(shard_view(self.plan, view))
        return record_ops(self.engine.infer_staged, staged)[1]
