"""Supervised host-side prefetch pipelines (the counterpart of
``repro/runtime/prefetch.py``).

The prefetch pool makes view construction parallel and deterministic,
and supervision makes it *survivable*. The design premise (and the
reason recovery is cheap): view *i* of a
:class:`~repro_torch.core.views.ViewStream` is a pure function of
``(seed, i)``, so any failed or hung build can be
retried — on the same worker, or on a different one — and the recovered
stream is **bit-identical** to a fault-free run. Supervision therefore
never costs reproducibility, which is the trajectory-invariance
contract ``tests/test_torch_runtime.py`` asserts.

Two pipelines, which :mod:`repro_torch.core.trainer` drives:

- :class:`ViewPrefetcher` — the double-buffered daemon pipeline for
  plain iterators. Hardened ``close()``: the producer is drained and
  unblocked deterministically (cancel flag checked on every bounded
  put), and a thread that refuses to die raises
  :class:`~repro_torch.runtime.faults.PrefetchShutdownError` instead of
  being silently leaked.
- :class:`StreamPrefetcher` — the worker pool over an indexable
  ViewStream, supervised: per-index builds are retryable units (a
  :class:`~repro_torch.runtime.faults.Retrier` wraps build+prepare), a
  worker killed mid-build
  (:class:`~repro_torch.runtime.faults.WorkerKilled` — the OOM-kill
  stand-in) has its claimed index **requeued** and a
  replacement worker respawned (capped by
  ``policy.max_worker_respawns``), and a build that exceeds the
  policy's ``view_build`` timeout is reassigned to another worker (the
  stale claim's eventual result is discarded by generation check).
  Emit order is by index throughout, so none of this is observable in
  the staged sequence.

With ``runtime=None`` both classes are the zero-overhead production
pipelines (no retry wrapper, no watchdog) plus the hardened close.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

from repro_torch.runtime.faults import (PrefetchShutdownError, Retrier,
                                        WorkerKilled)


class ViewPrefetcher:
    """Double-buffered host pipeline over a plain view iterator.

    A daemon thread pulls views, runs ``prepare`` (staging onto the
    device) and parks up to ``depth`` staged views in a bounded queue, so
    staging for step *i+1* overlaps device compute for step *i*.
    Exceptions in the thread re-raise in the consumer; exhaustion is
    signalled with a sentinel. With a ``runtime`` retrier, ``prepare``
    becomes a retryable ``view_build`` stage (the pulled view is in hand,
    so a transient staging failure re-prepares the same view).
    """

    _END = object()

    def __init__(self, views: Iterable, prepare, depth: int = 2,
                 runtime: Optional[Retrier] = None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._cancel = threading.Event()
        if runtime is not None:
            raw = prepare
            prepare = lambda v: runtime("view_build", lambda: raw(v))
        self._thread = threading.Thread(
            target=self._run, args=(views, prepare), daemon=True,
            name="view-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer cancelled (so an
        abandoned fit can't leave the thread pinning staged buffers)."""
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, views, prepare):
        try:
            for v in views:
                if self._cancel.is_set() or not self._put(prepare(v)):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced in __next__
            self._err = e
        finally:
            self._put(self._END)

    def close(self, timeout: float = 5.0):
        """Unblock and retire the producer; staged-but-unconsumed views
        are dropped. The queue is drained *while* joining (a producer
        mid-``put`` wakes on the drain or the cancel flag, whichever is
        first), and a thread still alive past ``timeout`` raises — a
        silently leaked daemon pins staged device buffers and hides a
        hung view source."""
        self._cancel.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                # drain is opportunistic; the join below is the real wait
                pass  # lint: waive=src.silent-except
            self._thread.join(timeout=0.05)
            if time.monotonic() >= deadline:
                break
        if self._thread.is_alive():
            raise PrefetchShutdownError(
                f"prefetch thread {self._thread.name!r} still alive "
                f"{timeout}s after close() — the view iterator or "
                "prepare() is blocked in non-cancellable code")

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class StreamPrefetcher:
    """Supervised worker pool over an indexable ViewStream.

    ``workers`` threads each own a private ViewBuilder and claim view
    indices — requeued (recovered) indices first, then a shared counter;
    finished (built + staged) views land in a reorder buffer and are
    emitted strictly in index order. Since ``stream.build(i)``
    derives its RNG from ``(seed, i)``, the emitted sequence is
    bit-identical to sequential construction no matter how the OS
    schedules the workers — or how many of them fault.

    Run-ahead is bounded: no worker starts index i until
    ``i - emitted < depth + workers - 1``, so at most ~depth staged views
    wait in the buffer while every worker stays busy. The stream's cursor
    advances only as views are *emitted* (not as they are built), which is
    what makes the cursor checkpointable mid-pipeline.

    Supervision (only with a ``runtime`` retrier):

    - build+prepare runs under the retrier's ``view_build`` stage —
      transient failures back off and retry the same index;
    - :class:`WorkerKilled` escaping a build requeues the claimed index
      and respawns a replacement thread (up to
      ``policy.max_worker_respawns`` deaths, then the pool aborts);
    - a claim older than the policy's ``view_build`` timeout is
      reassigned by the consumer; the stale build's result is discarded
      via a per-claim generation id (rebuilds are bit-identical, so a
      double build is waste, never corruption).
    """

    def __init__(self, stream, prepare, steps: Optional[int],
                 workers: int = 1, depth: int = 2,
                 runtime: Optional[Retrier] = None):
        self._stream = stream
        self._start = stream.cursor
        left = (None if stream.length is None
                else max(0, stream.length - self._start))
        if steps is None:
            self._limit = left
        else:
            self._limit = steps if left is None else min(steps, left)
        self._prepare = prepare
        self._runtime = runtime
        self._cond = threading.Condition()
        self._results: dict = {}
        self._next_build = 0
        self._emitted = 0
        self._requeue: list = []        # recovered indices, claimed first
        self._claims: dict = {}         # index -> (claim_id, t_claimed)
        self._claim_ids = itertools.count()
        self._err: Optional[BaseException] = None
        self._cancel = False
        self._cancel_evt = threading.Event()   # cancellable injected hangs
        # keyed injections are pure functions of the index, so a requeued
        # index would fault again forever; each index gets at most one
        # shot per injection point (marked at first claim, under the lock)
        self._hang_armed: set = set()
        self._kill_armed: set = set()
        self._corrupt_armed: set = set()
        self._respawns = 0
        self._worker_seq = itertools.count()
        # materialize the graph's lazy CSC index before the fan-out so
        # worker-thread builders never race the unlocked cache
        stream.g.csc()
        workers = max(1, workers)
        self._workers = workers
        self._max_ahead = max(1, depth) + workers - 1
        self._threads: list = []
        with self._cond:
            for _ in range(workers):
                self._spawn()

    # -- worker lifecycle --------------------------------------------------

    def _spawn(self):
        """Start one worker thread (caller holds the cond lock or is
        __init__)."""
        t = threading.Thread(target=self._work, daemon=True,
                             name=f"view-stream-{next(self._worker_seq)}")
        self._threads.append(t)
        t.start()

    def _claimable(self) -> bool:
        if self._requeue:
            return True
        if self._limit is not None and self._next_build >= self._limit:
            return False
        return (self._next_build - self._emitted) < self._max_ahead

    def _done_producing(self) -> bool:
        """No index left to claim, now or after any future requeue."""
        return (not self._requeue and not self._claims
                and self._limit is not None
                and self._next_build >= self._limit)

    def _claim(self) -> Optional[tuple]:
        """Blocking claim of the next index; None = pool shutting down.
        Caller must NOT hold the cond lock."""
        with self._cond:
            while (not self._cancel and self._err is None
                   and not self._claimable() and not self._done_producing()):
                self._cond.wait()
            if (self._cancel or self._err is not None
                    or self._done_producing()):
                return None
            if self._requeue:
                i = self._requeue.pop(0)
            else:
                i = self._next_build
                self._next_build += 1
            cid = next(self._claim_ids)
            self._claims[i] = (cid, time.monotonic())
            return i, cid

    def _build_one(self, i: int, builder):
        def build():
            item = self._prepare(
                self._stream.build(self._start + i, builder))
            return item

        rt = self._runtime
        if rt is None:
            return build()
        inj = rt.injector
        if inj is not None:
            with self._cond:
                do_hang = i not in self._hang_armed
                self._hang_armed.add(i)
            if do_hang:
                # an injected stall: cancellable (wakes on close()), and
                # the consumer-side watchdog reassigns i meanwhile.
                # proc_hang is the process-level point's thread analog,
                # so one chaos plan covers both prefetch modes
                inj.maybe_hang("view_hang", i, inj.hang_seconds,
                               self._cancel_evt.wait)
                inj.maybe_hang("proc_hang", i, inj.hang_seconds,
                               self._cancel_evt.wait)
            with self._cond:
                do_kill = i not in self._kill_armed
                self._kill_armed.add(i)
            if do_kill:
                inj.maybe_fail("worker_kill", key=i)
                # SIGKILL's thread analog: maybe_fail maps proc_kill to
                # WorkerKilled (requeue + respawn, same supervision)
                inj.maybe_fail("proc_kill", key=i)
            with self._cond:
                do_corrupt = i not in self._corrupt_armed
                self._corrupt_armed.add(i)
            if do_corrupt and inj.fires("slot_corrupt", key=i):
                # a corrupted handoff's thread analog: the first build
                # is discarded (as a corrupt slot would be) and the
                # pure view rebuilt bit-exactly below
                self._stream.build(self._start + i, builder)
        return rt("view_build", build, key=i, label=f"view[{i}]")

    def _work(self):
        try:
            builder = self._stream.make_builder()
            while True:
                claim = self._claim()
                if claim is None:
                    return
                i, cid = claim
                try:
                    item = self._build_one(i, builder)
                except WorkerKilled:
                    with self._cond:
                        if self._claims.get(i, (None,))[0] == cid:
                            del self._claims[i]
                            self._requeue.append(i)
                        self._respawns += 1
                        policy = (self._runtime.policy if self._runtime
                                  else None)
                        cap = (policy.max_worker_respawns if policy
                               else 0)
                        if self._respawns > cap:
                            self._err = RuntimeError(
                                f"prefetch pool: {self._respawns} worker "
                                f"deaths exceed max_worker_respawns={cap}")
                        else:
                            self._spawn()
                        self._cond.notify_all()
                    return
                with self._cond:
                    if self._claims.get(i, (None,))[0] == cid:
                        # still ours — a watchdog reassignment would have
                        # dropped the claim (discard the stale build)
                        del self._claims[i]
                        self._results[i] = item
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — surfaced in __next__
            with self._cond:
                if self._err is None:
                    self._err = e
                self._cond.notify_all()

    # -- consumer side -----------------------------------------------------

    def close(self, timeout: float = 5.0):
        with self._cond:
            self._cancel = True
            self._results.clear()
            self._cond.notify_all()
        self._cancel_evt.set()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        stuck = [t.name for t in self._threads if t.is_alive()]
        if stuck:
            raise PrefetchShutdownError(
                f"prefetch workers {stuck} still alive {timeout}s after "
                "close() — a build is blocked in non-cancellable code")

    def _stall_timeout(self) -> Optional[float]:
        if self._runtime is None:
            return None
        return self._runtime.policy.timeout("view_build")

    def _reassign_stale(self, now: float, stall: float) -> None:
        """Requeue any claim older than the view_build timeout (caller
        holds the cond lock). The claim entry is dropped, so the hung
        build's eventual result fails its generation check."""
        stale = [i for i, (_, t0) in self._claims.items()
                 if now - t0 > stall]
        for i in stale:
            del self._claims[i]
            self._requeue.append(i)
        if stale:
            self._cond.notify_all()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        stall = self._stall_timeout()
        with self._cond:
            if self._limit is not None and self._emitted >= self._limit:
                raise StopIteration
            while self._emitted not in self._results and self._err is None:
                if stall is None:
                    self._cond.wait()
                else:
                    self._cond.wait(timeout=min(0.05, stall / 4))
                    self._reassign_stale(time.monotonic(), stall)
            if self._emitted not in self._results:
                err = self._err
                raise err
            item = self._results.pop(self._emitted)
            self._emitted += 1
            self._cond.notify_all()
        # cursor = views handed to the consumer, exact for checkpointing
        self._stream.seek(self._start + self._emitted)
        return item
