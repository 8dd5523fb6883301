"""Supervised multi-process sampler service over shared-memory view slots
(the counterpart of ``repro/runtime/procpool.py``).

View construction moves out of the trainer process: the paper's regime
(1,024 small-memory workers, §5) makes sampler failure the steady state,
and the GIL makes in-process builder threads a scaling ceiling — in the
port they also compete with the step's eager launches for it.
:class:`ProcessViewService` is a drop-in replacement for
:class:`~repro_torch.runtime.prefetch.StreamPrefetcher` (same
constructor shape, same iterator contract) that spawns N sampler
**processes** (``spawn`` context — each re-opens the graph read-only
from its own pickled copy, caches pruned) and moves finished views back
through shared-memory ring slots::

    trainer process                      sampler process (x N)
    ---------------                      ---------------------
    _schedule() --- task queue (i, slot) ---> build view i
    _poll_done() <- per-worker done queue --  write slot: seqlock odd
                    (ready/ok/err)            -> payload -> len/crc32/i
    verify seq even + crc  <== shm ring ====  -> seqlock even
    unpickle -> prepare() -> emit in order    heartbeat[wid] = monotonic

Only numpy crosses to a sampler and back: the graph's caches (which hold
torch plans and blocks) are pruned before the stream is pickled, a view
travels as its numpy arrays, and ``prepare`` (staging onto the device)
runs in the parent, so a sampler never initialises CUDA. Every sampler
imports ``repro_torch`` and therefore torch when it unpickles its
stream, which sets the pool's start-up time.

Integrity is layered: the per-slot **seqlock** (odd = writer inside,
even = stable; re-checked after the payload copy) means a half-written
slot is never *consumed*, and the **crc32** over the payload means a
torn or corrupted write is *detected* — both downgrade to a requeue,
because view ``i`` is a pure function of ``(seed, i)`` and a rebuild is
bit-exact. The same purity makes every recovery invisible in the
emitted sequence: kill -9 mid-build, a hung worker, a corrupted slot —
the trainer sees the identical view stream, in index order.

Supervision (the heart of it):

- **heartbeats** — each worker stamps a shared ``float64`` slot while
  polling and around every build; the parent's claim-age watchdog
  declares a worker hung when its claim AND its heartbeat are both
  older than ``FaultPolicy.worker_heartbeat_s``, then terminate→kill→
  respawns it and requeues the claim (``worker_heartbeat_s`` must
  exceed an honest build time — a false positive costs a rebuild,
  never correctness);
- **capped respawn** — dead or hung processes are respawned up to
  ``FaultPolicy.max_proc_respawns``, then the pool aborts with a typed
  :class:`~repro_torch.runtime.faults.FaultRetriesExceeded`;
- **graceful close()** — stop scheduling, send exit sentinels, join
  with a deadline, escalate terminate→kill for stragglers, unlink the
  shared segments; zero child processes survive a clean close.

Fault injection: the child rebuilds its own deterministic
:class:`~repro_torch.runtime.faults.FaultInjector` from the parent's plan and
applies the process-level points keyed by view index — ``proc_kill``
(os.kill SIGKILL), ``proc_hang`` (sleep without heartbeats),
``slot_corrupt`` (flip payload bytes after the crc was computed).
Because ``fires(point, key=i)`` is a pure function, the parent *replays
the same decision* when it detects the failure, so the parent-side
injector's ``fired`` record (what chaos scenarios assert on) matches
the child's without any cross-process channel.

When shared memory is unavailable the trainers degrade to the
in-process :class:`~repro_torch.runtime.prefetch.StreamPrefetcher` with a
one-time warning (see :func:`warn_unavailable_once`).
"""
from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import queue as _queue
import signal
import struct
import threading
import time
import traceback
import warnings
import zlib
from typing import Iterator, Optional

from repro_torch.runtime.faults import (FaultInjector, FaultPolicy,
                                  FaultRetriesExceeded,
                                  PrefetchShutdownError, Retrier,
                                  SlotCorruptionError)

try:
    import multiprocessing
    from multiprocessing import connection as _mpconn
    from multiprocessing import shared_memory as _shm
except ImportError:                      # pragma: no cover - stdlib
    multiprocessing = None
    _mpconn = None
    _shm = None

import numpy as np


class ProcPoolUnavailable(RuntimeError):
    """Shared memory / process spawning is unusable here — callers
    degrade to the in-process thread pool."""


# injection points the child process owns (everything else — staging,
# step, checkpoint — fires parent-side as usual)
PROC_POINTS = ("proc_kill", "proc_hang", "slot_corrupt")

# slot layout: | seq u64 | length u64 | crc32 u32 | view index i64 | pad |
# payload starts at byte 32. seq is the seqlock generation: odd while a
# writer is inside, even when stable.
_SEQ = struct.Struct("<Q")
_META = struct.Struct("<QIq")
_PAYLOAD_OFF = 32

_DEGRADE_WARNED = False


def warn_unavailable_once(reason: str) -> None:
    """One-time RuntimeWarning when ``prefetch_mode='process'`` degrades
    to the in-process StreamPrefetcher."""
    global _DEGRADE_WARNED
    if not _DEGRADE_WARNED:
        warnings.warn(
            f"prefetch_mode='process' unavailable ({reason}); degrading "
            "to in-process thread prefetch (StreamPrefetcher)",
            RuntimeWarning, stacklevel=3)
        _DEGRADE_WARNED = True


def shared_memory_available() -> bool:
    """Probe: can we create (and unlink) a shared-memory segment?"""
    if _shm is None or multiprocessing is None:
        return False
    try:
        seg = _shm.SharedMemory(create=True, size=8)
    except Exception:  # noqa: BLE001 — the probe IS the error handling
        return False
    try:
        seg.close()
        seg.unlink()
    except OSError:
        # already gone / platform quirk: the probe still succeeded
        pass  # lint: waive=src.silent-except
    return True


# ---------------------------------------------------------------------------
# view (de)serialization: everything but the graph crosses the boundary
# ---------------------------------------------------------------------------


def _strip_view(view) -> tuple:
    """A picklable graph-free snapshot of a view (the graph is shared
    state both sides already hold)."""
    from repro_torch.core.views import CompactView, GraphView
    if isinstance(view, CompactView):
        return ("compact", view.K, view.strategy, view.nodes,
                view.hop_offsets, view.src_local, view.dst_local,
                view.edge_ids, view.loss_local, dict(view.meta))
    if isinstance(view, GraphView):
        return ("dense", view.K, view.strategy, view.node_active,
                view.edge_active, view.loss_mask, dict(view.meta))
    raise TypeError(f"cannot serialize view of type {type(view).__name__}")


def _restore_view(g, state: tuple):
    from repro_torch.core.views import CompactView, GraphView
    kind = state[0]
    if kind == "compact":
        return CompactView(g, state[1], state[2], state[3], state[4],
                           state[5], state[6], state[7], state[8],
                           state[9])
    return GraphView(g, state[1], state[2], state[3], state[4], state[5],
                     state[6])


def _sampler_stream(stream):
    """A copy of ``stream`` fit to ship to a spawn worker: builder
    detached, the graph's lazy caches (CSR/CSC, the destination and
    source plans, base blocks) pruned so each sampler re-derives what it
    needs read-only instead of shipping megabytes of parent state — and
    no torch tensor, on the card or off it, crosses to a sampler."""
    s = copy.copy(stream)
    s._builder = None
    g = copy.copy(stream.g)
    g._csr = g._csc = g._gcn_norm = None
    g._csc_plans = {}
    g._src_plans = {}
    g._base_blocks = {}
    s.g = g
    view = getattr(s, "_view", None)     # GlobalViewStream
    if view is not None and view.graph is stream.g:
        s._view = dataclasses.replace(view, graph=g)
    cache = getattr(s, "cache", None)    # ClusterViewStream
    if cache is not None and getattr(cache, "g", None) is stream.g:
        cache = copy.copy(cache)
        cache.g = g
        s.cache = cache
    return s


def _slot_bytes_for(stream) -> int:
    """A capacity bound covering any view the stream can emit (dense
    mask views and compact relabeled views alike), plus headroom for
    pickle framing."""
    g, K = stream.g, stream.K
    n, e = int(g.num_nodes), int(g.num_edges)
    dense = 4 * K * (n + e) + 4 * n
    compact = 16 * n + 24 * e + 8 * (K + 2)
    return max(dense, compact) + 65536


# ---------------------------------------------------------------------------
# the sampler process
# ---------------------------------------------------------------------------


def _write_slot(buf, base: int, payload: bytes, index: int) -> None:
    """Seqlocked slot write: odd seq while inside, even when stable."""
    seq0 = _SEQ.unpack_from(buf, base)[0]
    if seq0 % 2:
        seq0 += 1     # previous writer died mid-write; realign to even
    _SEQ.pack_into(buf, base, seq0 + 1)
    buf[base + _PAYLOAD_OFF:base + _PAYLOAD_OFF + len(payload)] = payload
    _META.pack_into(buf, base + 8, len(payload), zlib.crc32(payload),
                    index)
    _SEQ.pack_into(buf, base, seq0 + 2)


def _mute_child_shm_tracking() -> None:
    """Stop this (sampler) process registering shm attachments with the
    shared resource tracker: the parent owns both segments' lifetimes
    (close+unlink in ``close()``), and N children registering then
    unregistering the same names races the tracker's bookkeeping."""
    try:
        from multiprocessing import resource_tracker

        def _noop_register(name, rtype):
            if rtype != "shared_memory":
                resource_tracker._real_register(name, rtype)

        if not hasattr(resource_tracker, "_real_register"):
            resource_tracker._real_register = resource_tracker.register
            resource_tracker.register = _noop_register
    except Exception:  # noqa: BLE001
        # best-effort: worst case is a spurious tracker warning at exit
        pass  # lint: waive=src.silent-except


def _worker_main(wid: int, start: int, shm_name: str,
                 hb_name: str, nworkers: int, slot_bytes: int,
                 task_q, done_q, inj_spec) -> None:
    """One sampler process: take the pickled stream from ``task_q``, then
    claim tasks from it, build views (pure in ``(seed, i)``), write them
    into shared-memory slots, report on ``done_q``. Heartbeats via the
    shared ``hb`` array."""
    # ctrl-C belongs to the trainer: the parent's close() retires us
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    _mute_child_shm_tracking()
    seg = _shm.SharedMemory(name=shm_name)
    hbseg = _shm.SharedMemory(name=hb_name)
    hb = np.ndarray((nworkers,), np.float64, buffer=hbseg.buf)
    inj = FaultInjector(*inj_spec) if inj_spec is not None else None
    try:
        # unpickling the stream imports repro_torch (and torch) here,
        # after start() has returned in the parent (see _spawn)
        stream = pickle.loads(task_q.get())
        builder = stream.make_builder()
        hb[wid] = time.monotonic()
        done_q.put(("ready", wid, os.getpid()))
        while True:
            hb[wid] = time.monotonic()
            try:
                task = task_q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if task is None:
                return
            i, slot, inject = task
            hb[wid] = time.monotonic()
            if inject and inj is not None:
                if inj.fires("proc_hang", key=i):
                    # a stall with NO heartbeats — exactly what the
                    # parent's claim-age watchdog exists to catch
                    time.sleep(inj.hang_seconds)
                if inj.fires("proc_kill", key=i):
                    os.kill(os.getpid(), signal.SIGKILL)
            try:
                view = stream.build(start + i, builder)
                payload = pickle.dumps(
                    _strip_view(view), protocol=pickle.HIGHEST_PROTOCOL)
                if len(payload) > slot_bytes - _PAYLOAD_OFF:
                    raise ValueError(
                        f"view {i} serialized to {len(payload)} bytes > "
                        f"slot capacity {slot_bytes - _PAYLOAD_OFF}")
                base = slot * slot_bytes
                _write_slot(seg.buf, base, payload, i)
                if inject and inj is not None and inj.fires(
                        "slot_corrupt", key=i):
                    # flip a payload byte AFTER the crc went in: the
                    # parent must detect this, never consume it
                    off = base + _PAYLOAD_OFF
                    seg.buf[off] = seg.buf[off] ^ 0xFF
            except Exception:  # noqa: BLE001 — reported to the parent
                done_q.put(("err", wid, i, slot, traceback.format_exc()))
            else:
                hb[wid] = time.monotonic()
                done_q.put(("ok", wid, i, slot))
    finally:
        seg.close()
        hbseg.close()


# ---------------------------------------------------------------------------
# the parent-side service
# ---------------------------------------------------------------------------


class _Worker:
    """Parent-side record of one sampler process.

    ``done`` is per-worker on purpose: a multiprocessing queue shared by
    N writers serializes sends on one cross-process write lock, and a
    worker SIGKILLed while its feeder thread holds that lock blocks
    every *other* worker's replies forever (observed as a livelock with
    fresh heartbeats, so the watchdog never fires). With exactly one
    writer per queue, a dying writer can only poison its own channel —
    which dies with it and is retired **without draining**.
    """

    __slots__ = ("wid", "proc", "q", "done", "ready")

    def __init__(self, wid: int):
        self.wid = wid
        self.proc = None
        self.q = None
        self.done = None
        self.ready = False


class ProcessViewService:
    """Iterator of prepared views built by supervised sampler processes.

    Drop-in for :class:`~repro_torch.runtime.prefetch.StreamPrefetcher`:
    same constructor shape ``(stream, prepare, steps, workers, depth,
    runtime)``, same strict index-order emission, same cursor contract
    (``stream.seek`` advances only as views are *emitted*), and the same
    determinism guarantee — the emitted sequence is bit-identical to
    sequential construction for any worker count and through any
    supervised recovery. ``prepare`` (staging onto the device) runs in
    the parent, where the step runs.
    """

    def __init__(self, stream, prepare, steps: Optional[int],
                 workers: int = 1, depth: int = 2,
                 runtime: Optional[Retrier] = None):
        if not shared_memory_available():
            raise ProcPoolUnavailable(
                "multiprocessing.shared_memory cannot allocate segments "
                "on this platform")
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
        self._policy = runtime.policy if runtime is not None \
            else FaultPolicy()
        workers = max(1, workers)
        self._nworkers = workers
        self._max_ahead = max(1, depth) + workers - 1
        self._slot_bytes = _slot_bytes_for(stream)
        self._nslots = workers + 2
        self.events: list = []
        self._err: Optional[BaseException] = None
        self._closed = False
        self._respawns = 0
        self._emitted = 0
        self._next_build = 0
        self._requeue: list = []
        self._suppress: set = set()     # recovered indices: no re-inject
        self._results: dict = {}
        self._claims: dict = {}         # wid -> (i, slot, t_assigned)
        self._free = list(range(self._nslots))

        try:
            self._ctx = multiprocessing.get_context("spawn")
        except ValueError as e:
            raise ProcPoolUnavailable(f"no spawn context: {e}") from e
        self._seg = _shm.SharedMemory(
            create=True, size=self._nslots * self._slot_bytes)
        self._hbseg = _shm.SharedMemory(create=True, size=8 * workers)
        self._hb = np.ndarray((workers,), np.float64,
                              buffer=self._hbseg.buf)
        self._hb[:] = time.monotonic()
        # what ships to every sampler: caches pruned, builder detached,
        # pickled once
        self._stream_blob = pickle.dumps(_sampler_stream(stream),
                                         protocol=pickle.HIGHEST_PROTOCOL)
        inj = runtime.injector if runtime is not None else None
        self._inj = inj
        self._inj_spec = None
        if inj is not None:
            plan = {p: inj.plan[p] for p in PROC_POINTS if p in inj.plan}
            if plan:
                self._inj_spec = (plan, inj.seed, inj.hang_seconds)
        self._workers = [_Worker(w) for w in range(workers)]
        try:
            for w in self._workers:
                self._spawn(w)
        except BaseException:
            self.close()
            raise

    # -- worker lifecycle --------------------------------------------------

    def _spawn(self, w: _Worker) -> None:
        w.q = self._ctx.Queue()
        w.done = self._ctx.Queue()   # single-writer reply channel
        w.ready = False
        self._hb[w.wid] = time.monotonic()
        proc = self._ctx.Process(
            target=_worker_main, name=f"view-sampler-{w.wid}",
            args=(w.wid, self._start, self._seg.name, self._hbseg.name,
                  self._nworkers, self._slot_bytes, w.q, w.done,
                  self._inj_spec),
            daemon=True)
        # assigned only after a successful start: close() must never try
        # to join a process that was never launched
        proc.start()
        w.proc = proc
        # the stream goes on the task queue (a feeder thread writes it),
        # not in the spawn payload: start() writes its payload to a pipe
        # the child reads only after its imports, so a payload larger
        # than the pipe's buffer would block start() for the child's
        # whole start-up (serialising N spawns), and forever if the child
        # died first
        w.q.put(self._stream_blob)

    def _kill_proc(self, proc) -> None:
        """terminate → join → kill → join escalation."""
        proc.terminate()
        proc.join(timeout=1.0)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=5.0)

    def _retire_queue(self, q) -> None:
        if q is None:
            return
        q.close()
        q.cancel_join_thread()

    def _record_detected(self, point: str, i: int) -> None:
        """Replay the child's (pure) injection decision into the
        parent-side injector, so ``fired`` reflects detected process
        faults without a cross-process channel. A genuine (un-injected)
        fault replays to False and is recorded only in ``events``."""
        if self._inj is not None:
            self._inj.fires(point, key=i)

    def _event(self, rec: dict) -> None:
        self.events.append(rec)
        rt = self._runtime
        if rt is not None:
            with rt._lock:
                rt.events.append(rec)

    def _requeue_index(self, i: int, slot: int) -> None:
        """Claim recovery: the index rebuilds bit-exactly (pure in
        ``(seed, i)``), with injection suppressed so a keyed fault fires
        at most once per index."""
        self._suppress.add(i)
        self._requeue.append(i)
        self._free.append(slot)

    def _on_worker_death(self, w: _Worker, reason: str) -> None:
        claim = self._claims.pop(w.wid, None)
        if claim is not None:
            i, slot, _ = claim
            self._requeue_index(i, slot)
        self._event({"stage": reason, "worker": w.wid,
                     "view": None if claim is None else claim[0]})
        # retired WITHOUT draining: a write torn by the death can leave
        # the pipe with a length prefix and no body, and a recv on it
        # would block forever. The requeue above makes any lost reply
        # moot — the index rebuilds bit-exactly.
        self._retire_queue(w.q)
        self._retire_queue(w.done)
        w.q = None
        w.done = None
        w.proc = None
        self._respawns += 1
        if self._respawns > self._policy.max_proc_respawns:
            if self._err is None:
                self._err = FaultRetriesExceeded(
                    f"process pool: {self._respawns} sampler deaths "
                    "exceed max_proc_respawns="
                    f"{self._policy.max_proc_respawns}")
            return
        self._spawn(w)

    # -- the scheduling / supervision loop (consumer-driven) ---------------

    def _next_task(self) -> Optional[int]:
        if self._requeue:
            return self._requeue.pop(0)
        if self._limit is not None and self._next_build >= self._limit:
            return None
        if (self._next_build - self._emitted) >= self._max_ahead:
            return None
        i = self._next_build
        self._next_build += 1
        return i

    def _schedule(self) -> None:
        for w in self._workers:
            if (w.proc is None or not w.ready
                    or self._claims.get(w.wid) is not None
                    or not self._free):
                continue
            i = self._next_task()
            if i is None:
                return
            slot = self._free.pop()
            self._claims[w.wid] = (i, slot, time.monotonic())
            w.q.put((i, slot, i not in self._suppress))

    def _read_slot(self, slot: int, i: int):
        base = slot * self._slot_bytes
        buf = self._seg.buf
        seq = _SEQ.unpack_from(buf, base)[0]
        length, crc, idx = _META.unpack_from(buf, base + 8)
        if seq % 2:
            raise SlotCorruptionError(
                f"slot {slot}: seqlock odd ({seq}) — writer died inside")
        if idx != i:
            raise SlotCorruptionError(
                f"slot {slot}: holds view {idx}, expected {i}")
        if length > self._slot_bytes - _PAYLOAD_OFF:
            raise SlotCorruptionError(
                f"slot {slot}: length {length} exceeds capacity")
        payload = bytes(buf[base + _PAYLOAD_OFF:
                            base + _PAYLOAD_OFF + length])
        if _SEQ.unpack_from(buf, base)[0] != seq:
            raise SlotCorruptionError(f"slot {slot}: torn read "
                                      "(seq advanced during copy)")
        if zlib.crc32(payload) != crc:
            raise SlotCorruptionError(
                f"slot {slot}: crc mismatch for view {i} — corrupted "
                "or torn write")
        return _restore_view(self._stream.g, pickle.loads(payload))

    def _prepare_view(self, view, i: int):
        rt = self._runtime
        if rt is None:
            return self._prepare(view)
        return rt("view_build", lambda: self._prepare(view), key=i,
                  label=f"view[{i}]")

    def _handle_msg(self, msg) -> None:
        kind, wid = msg[0], msg[1]
        w = self._workers[wid]
        if kind == "ready":
            # pid-tagged: a stale ready from a crashed predecessor must
            # not mark its respawned replacement ready prematurely
            if w.proc is not None and w.proc.pid == msg[2]:
                w.ready = True
            return
        i, slot = msg[2], msg[3]
        claim = self._claims.get(wid)
        if claim is None or claim[0] != i or claim[1] != slot:
            return   # stale message from a claim the watchdog reassigned
        del self._claims[wid]
        if kind == "err":
            self._free.append(slot)
            if self._err is None:
                self._err = RuntimeError(
                    f"sampler process {wid} failed building view "
                    f"{i}:\n{msg[4]}")
            return
        try:
            view = self._read_slot(slot, i)
        except SlotCorruptionError as e:
            self._record_detected("slot_corrupt", i)
            self._event({"stage": "slot_corrupt", "worker": wid,
                         "view": i, "error": str(e)})
            self._requeue_index(i, slot)
            return
        self._free.append(slot)
        self._results[i] = self._prepare_view(view, i)

    def _poll_done(self, timeout: float) -> None:
        """Non-blocking sweep of every live worker's reply queue (see
        :class:`_Worker` for why the channel is per-worker). When the
        sweep comes up empty, a select-style ``connection.wait`` on the
        live reply pipes blocks until a message lands (or ``timeout``
        passes, so the supervision loop keeps its cadence) — read-side
        only, no locks shared with the children."""
        got = False
        alive = []
        for w in self._workers:
            # skip dead workers' queues: reading a pipe torn by a death
            # can block, and _supervise requeues their claims anyway
            if w.done is None or w.proc is None or not w.proc.is_alive():
                continue
            alive.append(w)
            while True:
                try:
                    msg = w.done.get_nowait()
                except _queue.Empty:
                    break
                got = True
                self._handle_msg(msg)
        if got:
            return
        if alive:
            _mpconn.wait([w.done._reader for w in alive], timeout)
        else:
            time.sleep(timeout)

    def _supervise(self) -> None:
        now = time.monotonic()
        hb_s = self._policy.worker_heartbeat_s
        for w in self._workers:
            if w.proc is None:
                continue
            if not w.proc.is_alive():
                claim = self._claims.get(w.wid)
                if claim is not None:
                    self._record_detected("proc_kill", claim[0])
                self._on_worker_death(w, "proc_kill")
                continue
            claim = self._claims.get(w.wid)
            if claim is None:
                continue
            i, _, t0 = claim
            if (now - t0 > hb_s and now - self._hb[w.wid] > hb_s):
                # claim-age watchdog: no heartbeat AND no progress on
                # the claim — terminate→kill, requeue, respawn
                self._record_detected("proc_hang", i)
                self._kill_proc(w.proc)
                self._on_worker_death(w, "proc_hang")

    # -- iterator ----------------------------------------------------------

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._limit is not None and self._emitted >= self._limit:
            raise StopIteration
        while self._emitted not in self._results:
            if self._err is not None:
                raise self._err
            if self._closed:
                raise PrefetchShutdownError(
                    "ProcessViewService used after close()")
            self._schedule()
            self._poll_done(timeout=0.05)
            self._supervise()
        item = self._results.pop(self._emitted)
        self._emitted += 1
        # cursor = views handed to the consumer, exact for checkpointing
        self._stream.seek(self._start + self._emitted)
        return item

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Drain and retire every sampler: exit sentinels, join with a
        deadline, escalate terminate→kill, release the shared segments.
        After a clean close zero child processes remain."""
        if self._closed:
            return
        self._closed = True
        workers = getattr(self, "_workers", [])
        for w in workers:
            if w.proc is not None and w.proc.is_alive():
                try:
                    w.q.put_nowait(None)
                except (ValueError, OSError):
                    # queue already broken — escalation below handles it
                    pass  # lint: waive=src.silent-except
        deadline = time.monotonic() + timeout
        for w in workers:
            if w.proc is None:
                continue
            w.proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                self._kill_proc(w.proc)
        stuck = [w.wid for w in workers
                 if w.proc is not None and w.proc.is_alive()]
        for w in workers:
            if w.proc is not None and not w.proc.is_alive():
                w.proc.join()       # reap
                w.proc = None
            self._retire_queue(w.q)
            self._retire_queue(w.done)
            w.q = w.done = None
        self._results.clear()
        for seg in (getattr(self, "_seg", None),
                    getattr(self, "_hbseg", None)):
            if seg is None:
                continue
            try:
                seg.close()
                seg.unlink()
            except OSError:
                # double-unlink on interpreter teardown paths is benign
                pass  # lint: waive=src.silent-except
        self._seg = self._hbseg = None
        self._hb = None
        if stuck:
            raise PrefetchShutdownError(
                f"sampler processes {stuck} survived terminate+kill "
                f"{timeout}s after close()")
