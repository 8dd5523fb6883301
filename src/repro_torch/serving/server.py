"""Request-batched online GNN inference over bucketed compact views (the
counterpart of ``repro/serving/server.py``).

    clients --> request(node_id) --> [batching queue]
                                         | deadline / size trigger
                                         v
                  coverage split: cache-hit targets | miss targets
                       |                                  |
                1-hop CompactView                  K-hop CompactView
              (features = cached h^{K-1})       (raw node features)
                       |                                  |
              top layer + decoder               K layers + decoder,
                       |                        also emits h^{K-1}
                       +----------- gather rows ----------+--> responses
                                                          |
                                             cache.put (write-back)

A staged block is copied to the device before the next view can
overwrite its ring buffers. On the card each path's forward is captured
once per bucket into a CUDA graph (:class:`BucketedFn`): the bucket's
first batch runs eagerly and the capture follows, and every later batch
copies its staged block into the bucket's input buffers and replays;
``cuda_graphs=False`` serves every batch eagerly, as the CPU does. The
Sum stage runs the CUDA kernels on the card. Why a hit equals a full
recompute at ``staleness=0``: hop ordering
makes the 1-hop node set a prefix of a K-hop view, the write-back stores
the true h^{K-1} of that prefix, and the 1-hop view aggregates the same
edges in the same plan order; the kernels sum in plan order without
atomics, and cut a row of more than 64 edges into pieces counted from
the row's start, so a target's row sums the same way at its offset in
the 1-hop view and in the K-hop one, at every bucket (ROADMAP C.14:
``edge_softmax``'s merge-path chunks, which run plans of 2^19 rows plus
edges or more, balance the same row-relative units over warps); and the
dense products run over row tiles of one fixed size
(:func:`~repro_torch.nn.layers.fixed_row_tiles`, the ladder's largest
node count), so cuBLAS computes a row the same way in a small block and
a large one. So a hit is bitwise a full recompute, whatever the
buckets.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tgar import layer_forward_block
from repro_torch.core.trainer import (_assert_once_per_bucket, block_layout,
                                      capture, warm_up)
from repro_torch.core.views import BucketSpec, CompactBlockBuilder, ViewBuilder
from repro_torch.device import resolve_device
from repro_torch.graph.csr import Graph
from repro_torch.nn.layers import fixed_row_tiles
from repro_torch.serving.cache import EmbeddingCache


class ServerClosedError(RuntimeError):
    """The server was closed: the request was refused at the door, or it
    was still queued when ``close()`` failed the pending futures."""


class ServerOverloadedError(RuntimeError):
    """The bounded request queue is full — the server sheds load instead
    of buffering unboundedly (clients should back off and retry)."""


@dataclass
class ServeStats:
    """Per-stage timing + batching counters; ``summary()`` folds in
    latency percentiles."""
    requests: int = 0
    batches: int = 0
    queue_wait_s: float = 0.0
    view_build_s: float = 0.0
    device_step_s: float = 0.0
    gather_s: float = 0.0
    latencies_s: list = field(default_factory=list)

    def record_batch(self, n: int, queue_wait: float = 0.0) -> None:
        self.requests += n
        self.batches += 1
        self.queue_wait_s += queue_wait

    @staticmethod
    def _pct(xs, q):
        if not xs:
            return 0.0
        return float(np.percentile(np.asarray(xs), q))

    def summary(self) -> dict:
        lat = self.latencies_s
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": (self.requests / self.batches
                           if self.batches else 0.0),
            "stage_s": {"queue_wait": self.queue_wait_s,
                        "view_build": self.view_build_s,
                        "device_step": self.device_step_s,
                        "gather": self.gather_s},
            "latency_ms": {"p50": 1e3 * self._pct(lat, 50),
                           "p99": 1e3 * self._pct(lat, 99),
                           "mean": (1e3 * float(np.mean(lat))
                                    if lat else 0.0)},
        }


class BucketedFn:
    """``fn(block)`` over bucket-padded blocks staged on the host, with
    the reference's once-per-bucket accounting. On the card
    (``cuda_graphs``) a bucket's first call runs ``fn`` eagerly on a side
    stream and then captures it into a CUDA graph over the bucket's own
    input buffers; every later call copies the block into them and
    replays. Its outputs are the graph's and stay valid until the next
    call in that bucket. Eager (the CPU, or ``cuda_graphs=False``), each
    call runs ``fn`` on a fresh device copy of the block.
    :meth:`assert_compiled_per_bucket` certifies one capture per touched
    bucket."""

    def __init__(self, fn, name: str = "infer", device=None,
                 cuda_graphs: bool = False):
        self.fn = fn
        self.name = name
        self.device = torch.device("cpu") if device is None else device
        self.graphs_on = bool(cuda_graphs) and self.device.type == "cuda"
        self.calls: dict = {}      # (n_pad, e_pad) -> calls
        self.captures: dict = {}   # (n_pad, e_pad) -> graphs captured
        self._graphs: dict = {}    # (bucket, layout) -> CapturedStep
        self._side = None

    def __call__(self, block):
        key = (block.num_nodes_padded, block.num_edges_padded)
        self.calls[key] = self.calls.get(key, 0) + 1
        if not self.graphs_on:
            return self.fn(block.to(self.device, copy=True))
        gkey = (key, block_layout(block))
        step = self._graphs.get(gkey)
        if step is not None:
            return step.replay(block)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        static = block.to(self.device, copy=True)   # the graph's inputs
        out = warm_up(self.fn, static, self._side)
        self._graphs[gkey] = capture(self.fn, static, self._side)
        self.captures[key] = self.captures.get(key, 0) + 1
        return out

    @property
    def buckets_touched(self) -> set:
        return set(self.calls)

    def assert_compiled_per_bucket(self) -> None:
        """Exactly one capture per touched bucket under CUDA graphs;
        eager, that the path ran."""
        touched = len(self.buckets_touched)
        if self.graphs_on:
            _assert_once_per_bucket(sum(self.captures.values()), touched,
                                    f"{self.name} step")
        elif touched == 0:
            _assert_once_per_bucket(0, 0, f"{self.name} step")

    def ops(self, block):
        """The OpLog (:mod:`repro_torch.analysis.oplog`) of ``fn`` over
        ``block`` (staged on the host), run eagerly on a device copy of
        it: what the analysis rules walk. Neither calls nor captures are
        counted, so the once-per-bucket certificate survives analysis."""
        from repro_torch.analysis.oplog import record_ops
        return record_ops(self.fn, block.to(self.device, copy=True))[1]

    def trace(self) -> dict:
        """Captures and calls per bucket, for ``server_stats()``."""
        return {"captures": {k: self.captures.get(k, 0)
                             for k in sorted(self.calls)},
                "calls": {k: self.calls[k] for k in sorted(self.calls)},
                "buckets": sorted(self.calls)}


class _Pending:
    """One queued request: a node id, its enqueue time, and a completion
    event the client blocks on."""

    __slots__ = ("node", "t_in", "done", "result", "error")

    def __init__(self, node: int):
        self.node = int(node)
        self.t_in = time.perf_counter()
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class GNNServer:
    """Online inference over an MPGNN: micro-batches node-id requests into
    size-bucketed compact views and answers with per-node logits.

    - **miss** — K-hop compact view over raw features; the forward also
      returns the layer-(K-1) rows, written back to the
      :class:`EmbeddingCache` (nodes within 1 hop, a prefix).
    - **hit** — 1-hop compact view whose ``x`` rows come from the cache
      table; only the top layer and decoder run. A target is admitted
      when it and all its in-neighbours are fresh within ``staleness``.

    The server serves a private copy of ``model`` on ``device`` (the card
    unless ``device="cpu"``), with ``params`` (a ``state_dict``) loaded
    into it when given; on the card each path is a CUDA graph per bucket
    unless ``cuda_graphs=False``. ``request()`` is the concurrent client API
    (deadline/size-triggered batching on a dispatcher thread, see
    :meth:`start`); ``submit()`` serves one batch synchronously.
    """

    def __init__(self, model, params: Optional[Mapping], g: Graph,
                 buckets: Optional[BucketSpec] = None,
                 cache: object = True, staleness: int = 0,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 gcn_norm: bool = True, slots: int = 2,
                 max_queue: Optional[int] = None, device=None,
                 cuda_graphs: bool = True):
        self.device = resolve_device(device)
        model = copy.deepcopy(model)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.g = g
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.max_queue = (8 * self.max_batch if max_queue is None
                          else max(1, int(max_queue)))
        backend = model.aggregate_backend
        csc = backend == "csc"
        K = model.K
        self.buckets = buckets or BucketSpec.for_graph(g)
        self._builder = ViewBuilder(g, K, compact=True)
        self._stager = CompactBlockBuilder(
            g, K, buckets=self.buckets, slots=slots, gcn_norm=gcn_norm,
            csc_plan=csc)
        # the historical-embedding fast path needs a layer below the top
        # one to cache — K=1 models always take the full (1-hop) path
        if cache is True and K >= 2:
            cache = EmbeddingCache(g, dim=model.layers[-2].out_dim,
                                   staleness=staleness)
        elif cache is True:
            cache = None
        self.cache: Optional[EmbeddingCache] = cache or None
        if self.cache is not None:
            self._hit_builder = ViewBuilder(g, 1, compact=True)
            self._hit_stager = CompactBlockBuilder(
                g, 1, buckets=self.buckets, slots=slots, gcn_norm=gcn_norm,
                csc_plan=csc, features=self.cache.table)
        else:
            self._hit_builder = self._hit_stager = None
        self.stats = ServeStats()
        # one batch in flight at a time: staging mutates per-bucket ring
        # buffers and the cache write-back must be ordered
        self._serve_lock = threading.Lock()

        # every dense product of a served forward runs over tiles of
        # this many rows, whatever the block's bucket
        row_tile = max(shape[0] for shape in self.buckets.shapes)

        def full_fn(block):
            with torch.inference_mode(), fixed_row_tiles(row_tile):
                h = block.x
                n = block.num_nodes_padded
                penult = h
                for k, layer in enumerate(self.model.layers):
                    if k == K - 1:
                        penult = h     # the layer-(K-1) rows the cache stores
                    h = layer_forward_block(layer, h, block, k, n,
                                            backend=backend)
                return self.model.decode(h), penult

        def hit_fn(block):
            with torch.inference_mode(), fixed_row_tiles(row_tile):
                h = layer_forward_block(self.model.layers[-1], block.x,
                                        block, 0, block.num_nodes_padded,
                                        backend=backend)
                return self.model.decode(h)

        self._full_step = BucketedFn(full_fn, "serve_full", self.device,
                                     cuda_graphs)
        self._hit_step = BucketedFn(hit_fn, "serve_hit", self.device,
                                    cuda_graphs)

        # batching queue state (armed by start())
        self._queue: list = []
        self._cv = threading.Condition()
        self._dispatcher: Optional[threading.Thread] = None
        self._running = False
        self._closed = False

    # -- the device paths ------------------------------------------------------

    def _infer_full(self, targets: np.ndarray) -> np.ndarray:
        """K-hop path for (sorted unique) targets; writes back h^{K-1}."""
        t0 = time.perf_counter()
        view = self._builder.khop_compact(targets)
        staged = self._stager.stage(view)
        t1 = time.perf_counter()
        # the outputs are read before the path's next call
        logits, penult = self._full_step(staged)
        logits = logits[:len(targets)].cpu().numpy()
        t2 = time.perf_counter()
        if self.cache is not None:
            m = int(view.hop_offsets[1])     # nodes within 1 hop: a prefix
            self.cache.put(view.nodes[:m], penult[:m].cpu().numpy())
        self.stats.view_build_s += t1 - t0
        self.stats.device_step_s += t2 - t1
        return logits

    def _infer_hit(self, targets: np.ndarray) -> np.ndarray:
        """1-hop top-layer path over cached h^{K-1} rows."""
        t0 = time.perf_counter()
        view = self._hit_builder.khop_compact(targets)
        staged = self._hit_stager.stage(view)
        t1 = time.perf_counter()
        logits = self._hit_step(staged)
        logits = logits[:len(targets)].cpu().numpy()
        t2 = time.perf_counter()
        self.stats.view_build_s += t1 - t0
        self.stats.device_step_s += t2 - t1
        return logits

    def submit(self, node_ids: Sequence[int]) -> np.ndarray:
        """Serve one batch synchronously: returns ``(len(node_ids),
        num_classes)`` logits, one row per requested node (duplicates
        allowed)."""
        if self._closed:
            raise ServerClosedError("GNNServer is closed")
        nodes = np.asarray(node_ids, np.int64)
        if nodes.ndim != 1 or len(nodes) == 0:
            raise ValueError("submit() expects a non-empty 1-D sequence "
                             "of node ids")
        if nodes.min() < 0 or nodes.max() >= self.g.num_nodes:
            raise ValueError(
                f"node ids must lie in [0, {self.g.num_nodes})")
        t0 = time.perf_counter()
        with self._serve_lock:
            out = self._serve_locked(nodes)
        lat = time.perf_counter() - t0
        self.stats.latencies_s.extend([lat] * len(nodes))
        self.stats.record_batch(len(nodes))
        return out

    def _serve_locked(self, nodes: np.ndarray) -> np.ndarray:
        targets = np.unique(nodes)           # sorted — hop-0 view order
        if self.cache is not None:
            hit_mask = self.cache.coverage(targets)
            self.cache.hits += int(hit_mask.sum())
            self.cache.misses += int((~hit_mask).sum())
        else:
            hit_mask = np.zeros(len(targets), bool)
        out = np.empty((len(targets), self.model.num_classes), np.float32)
        miss = targets[~hit_mask]
        if len(miss):
            out[~hit_mask] = self._infer_full(miss)
        hit = targets[hit_mask]
        if len(hit):
            out[hit_mask] = self._infer_hit(hit)
        t0 = time.perf_counter()
        rows = np.searchsorted(targets, nodes)
        result = out[rows]
        self.stats.gather_s += time.perf_counter() - t0
        return result

    # -- the batching queue (concurrent clients) -------------------------------

    def start(self) -> "GNNServer":
        """Arm the dispatcher thread; clients then call :meth:`request`
        concurrently. A batch fires when ``max_batch`` requests are
        queued or the oldest has waited ``max_wait_ms``."""
        with self._cv:
            if self._closed:
                raise ServerClosedError(
                    "GNNServer is closed — build a new server")
            if self._running:
                return self
            self._running = True
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="gnn-serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()
        return self

    def stop(self) -> None:
        """Retire the dispatcher after draining: every already-queued
        request is still served (:meth:`close` fails them instead)."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join()
            self._dispatcher = None

    def close(self) -> None:
        """Stop accepting requests (:class:`ServerClosedError`), let the
        batch being served flush, fail every still-queued request with
        :class:`ServerClosedError`, and retire the dispatcher.
        Idempotent; the server cannot be restarted."""
        with self._cv:
            self._closed = True
            self._running = False
            pending, self._queue = self._queue, []
            self._cv.notify_all()
        err = ServerClosedError(
            "GNNServer closed while the request was queued")
        for p in pending:
            p.error = err
            p.done.set()
        if self._dispatcher is not None:
            self._dispatcher.join()     # flushes the in-flight batch
            self._dispatcher = None

    def request(self, node_id: int,
                timeout: Optional[float] = 30.0) -> np.ndarray:
        """Enqueue one node-id request and block until its logits are
        ready (requires :meth:`start`). Raises
        :class:`ServerOverloadedError` when the bounded queue is full and
        :class:`ServerClosedError` after :meth:`close`."""
        with self._cv:
            if self._closed:
                raise ServerClosedError("GNNServer is closed")
            if not self._running:
                raise RuntimeError("GNNServer.request() needs start() — "
                                   "or use submit() for synchronous "
                                   "batches")
            if len(self._queue) >= self.max_queue:
                raise ServerOverloadedError(
                    f"request queue full ({self.max_queue} pending) — "
                    "back off and retry")
            p = _Pending(node_id)
            self._queue.append(p)
            self._cv.notify_all()
        if not p.done.wait(timeout):
            raise TimeoutError(f"request for node {node_id} timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(0.1)
                if not self._running and not self._queue:
                    return
                # deadline/size trigger: wait for more work until the
                # oldest request's deadline, then take up to max_batch
                deadline = self._queue[0].t_in + self.max_wait_s
                while (self._running
                       and len(self._queue) < self.max_batch):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch = self._queue[:self.max_batch]
                del self._queue[:self.max_batch]
            self._serve_pending(batch)

    def _serve_pending(self, batch: list) -> None:
        t_go = time.perf_counter()
        waited = sum(t_go - p.t_in for p in batch)
        nodes = np.asarray([p.node for p in batch], np.int64)
        try:
            with self._serve_lock:
                out = self._serve_locked(nodes)
        except Exception as e:      # deliver to the clients, keep serving
            for p in batch:
                p.error = e
                p.done.set()
            return
        t_end = time.perf_counter()
        for i, p in enumerate(batch):
            p.result = out[i]
            self.stats.latencies_s.append(t_end - p.t_in)
            p.done.set()
        self.stats.record_batch(len(batch), waited)

    # -- contracts and observability ----------------------------------------

    def assert_compiled_per_bucket(self) -> None:
        """The reference's serving certificate: each device path captured
        exactly once per bucket it touched over the whole request trace
        (the hit path only once it has run)."""
        self._full_step.assert_compiled_per_bucket()
        if self._hit_step.buckets_touched:
            self._hit_step.assert_compiled_per_bucket()

    def server_stats(self) -> dict:
        s = self.stats.summary()
        s["cache"] = (self.cache.stats() if self.cache is not None
                      else {"enabled": False})
        s["buckets"] = {
            "full": {k: self._full_step.calls[k]
                     for k in sorted(self._full_step.calls)},
            "hit": {k: self._hit_step.calls[k]
                    for k in sorted(self._hit_step.calls)},
        }
        s["trace"] = {"full": self._full_step.trace(),
                      "hit": self._hit_step.trace()}
        return s

    # -- lifecycle -------------------------------------------------------------

    def update_params(self, params: Mapping) -> None:
        """Swap the served params (a ``state_dict``). The cache ages one
        version: with ``staleness=0`` every pre-update embedding stops
        hitting immediately. Holds the serve lock, so every response is
        computed under one ``(params, cache version)``."""
        with self._serve_lock:
            self.model.load_state_dict(params)
            if self.cache is not None:
                self.cache.advance()

    def update_features(self, nodes: np.ndarray,
                        values: np.ndarray) -> None:
        """In-place node-feature update + cache invalidation: the updated
        nodes' cached embeddings are wrong at any staleness, and so are
        those of every node whose 1..(K-1)-hop in-neighbourhood touches
        ``nodes``. Holds the serve lock."""
        nodes = np.asarray(nodes, np.int64)
        with self._serve_lock:
            self.g.node_features[nodes] = values
            # whole-graph blocks hold a copy of the features
            self.g._base_blocks.clear()
            if self.cache is None:
                return
            stale = [nodes]
            frontier = nodes
            for _ in range(self.model.K - 1):
                # out-neighbours of the frontier: edges whose src is stale
                sel = np.isin(self.g.src, frontier)
                frontier = np.unique(self.g.dst[sel])
                stale.append(frontier)
            self.cache.invalidate(np.unique(np.concatenate(stale)))
