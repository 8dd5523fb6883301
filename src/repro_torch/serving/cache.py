"""Historical-embedding cache for online GNN inference (the counterpart of
``repro/serving/cache.py``, host-side numpy as there).

Keeps the layer-(K-1) hidden embeddings computed by earlier requests. A
request whose 1-hop ego-net is covered by fresh rows runs only the top
layer and the decoder over them. Freshness is version-based: an entry is
fresh iff ``version - entry_version <= staleness``; ``advance()`` bumps
the version when the served params change, and ``invalidate(nodes)``
drops entries whose inputs changed.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.graph.csr import Graph


class EmbeddingCache:
    """Host-side ``(N, dim)`` table of layer-(K-1) embeddings, updated in
    place (a :class:`~repro_torch.core.views.CompactBlockBuilder` holding
    it as its feature source always gathers current rows);
    ``entry_version[v] == -1`` means never written. ``hits``/``misses``
    count per-target admission decisions."""

    def __init__(self, g: Graph, dim: int, staleness: int = 0):
        if int(dim) <= 0:
            raise ValueError(f"EmbeddingCache dim must be positive, "
                             f"got {dim}")
        self.g = g
        self.dim = int(dim)
        self.staleness = int(staleness)
        self.table = np.zeros((g.num_nodes, self.dim), np.float32)
        self.entry_version = np.full(g.num_nodes, -1, np.int64)
        self.version = 0
        self.hits = 0
        self.misses = 0
        # every version/table access takes this lock, so a param swap's
        # advance() cannot land between coverage()'s two freshness reads;
        # RLock: coverage() calls fresh()
        self._lock = threading.RLock()

    def put(self, nodes: np.ndarray, values: np.ndarray) -> None:
        """Write embeddings for ``nodes`` at the current version."""
        nodes = np.asarray(nodes)
        values = np.asarray(values, np.float32)
        if values.shape != (len(nodes), self.dim):
            raise ValueError(
                f"EmbeddingCache.put: values shape {values.shape} != "
                f"({len(nodes)}, {self.dim})")
        with self._lock:
            self.table[nodes] = values
            self.entry_version[nodes] = self.version

    def advance(self) -> int:
        """Bump the global version (served params changed)."""
        with self._lock:
            self.version += 1
            return self.version

    def invalidate(self, nodes: Optional[np.ndarray] = None) -> None:
        """Drop entries for ``nodes`` (all nodes if None)."""
        with self._lock:
            if nodes is None:
                self.entry_version.fill(-1)
            else:
                self.entry_version[np.asarray(nodes)] = -1

    def fresh(self, nodes: np.ndarray) -> np.ndarray:
        """Bool mask: which of ``nodes`` have a usable entry."""
        with self._lock:
            ver = self.entry_version[np.asarray(nodes)]
            return (ver >= 0) & ((self.version - ver) <= self.staleness)

    def coverage(self, targets: np.ndarray) -> np.ndarray:
        """Bool mask over ``targets``: t is covered iff t and every
        in-neighbour of t are fresh — the rows the top layer reads on a
        1-hop view. Holds the lock across both freshness reads."""
        targets = np.asarray(targets)
        if len(targets) == 0:
            return np.zeros(0, bool)
        indptr, order = self.g.csc()
        starts, stops = indptr[targets], indptr[targets + 1]
        counts = (stops - starts).astype(np.int64)
        with self._lock:
            covered = self.fresh(targets)
            total = int(counts.sum())
            if total == 0:
                return covered
            flat = np.repeat(starts, counts) + (
                np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                             counts))
            srcs = self.g.src[order[flat]]
            stale = ~self.fresh(srcs)
        seg = np.zeros(len(targets), np.int64)
        nz = counts > 0
        if nz.any():
            bounds = (np.cumsum(counts) - counts)[nz]
            seg[nz] = np.add.reduceat(stale.astype(np.int64), bounds)
        return covered & (seg == 0)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": int(self.hits), "misses": int(self.misses),
                "hit_rate": (self.hits / total) if total else 0.0,
                "version": int(self.version),
                "entries": int((self.entry_version >= 0).sum()),
                "staleness": self.staleness}
