"""The Sum-stage plan: destination-sorted edge order, built on the host.

The TPU plan (``repro/kernels/ops.py:CSCPlan``) pads every 128-row
destination block to a common lane count for a one-hot matmul; that
geometry is a TPU adaptation. On the GPU one warp walks one destination
row, so the plan keeps only the contracts:

- ``perm`` (E,): edge ids sorted by destination, stable;
- ``indptr`` (N+1,): row ``i`` owns ``perm[indptr[i]:indptr[i+1]]``;
- ``edge_dst`` (E,): each edge's destination row, the inverse map the
  backward kernels read (pad edges hold ``num_segments``).

Edges whose segment id is ``num_segments`` or more (the pad edges of a
bucket) sort past ``indptr[-1]`` and join no row, so the kernels read
each real edge once and need no atomics. Built once per graph or per
staged view, with numpy; work is O(E).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class CSCPlan:
    perm: torch.Tensor         # (E,) int32
    indptr: torch.Tensor       # (N+1,) int32
    edge_dst: torch.Tensor     # (E,) int32, pad edges = num_segments
    num_segments: int
    num_edges: int

    def to(self, device, copy: bool = False) -> "CSCPlan":
        return replace(self, perm=self.perm.to(device, copy=copy),
                       indptr=self.indptr.to(device, copy=copy),
                       edge_dst=self.edge_dst.to(device, copy=copy))


def build_csc_plan(segment_ids: np.ndarray, num_segments: int) -> CSCPlan:
    """Plan over ``segment_ids`` (E,); ids at or past ``num_segments``
    are pad edges and join no row."""
    ids = np.asarray(segment_ids).astype(np.int64)
    E = len(ids)
    if E >= 2 ** 31 or num_segments >= 2 ** 31:
        raise ValueError(f"{E} edges / {num_segments} segments overflow "
                         "the kernels' int32 indices")
    if E and int(ids.min()) < 0:
        raise ValueError("negative segment id")
    valid = ids < num_segments
    edge_dst = np.where(valid, ids, num_segments).astype(np.int32)
    perm = np.argsort(edge_dst, kind="stable").astype(np.int32)
    counts = np.bincount(ids[valid], minlength=num_segments)
    indptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSCPlan(torch.from_numpy(perm),
                   torch.from_numpy(indptr.astype(np.int32)),
                   torch.from_numpy(edge_dst), int(num_segments), E)


def build_bucket_csc_plan(dst_local: np.ndarray, n_pad: int,
                          e_pad: int) -> CSCPlan:
    """Plan for one bucket-padded compact block: the view's ``e`` real
    edges, then ``e_pad - e`` pad edges with id ``n_pad`` that join no
    row. Leaf shapes are a function of the bucket alone."""
    e = len(dst_local)
    if e > e_pad:
        raise ValueError(f"{e} edges do not fit the bucket's e_pad={e_pad}")
    if e and int(dst_local.max()) >= n_pad:
        raise ValueError(f"destination id {int(dst_local.max())} outside "
                         f"the bucket's n_pad={n_pad}")
    ids = np.full(e_pad, n_pad, np.int32)
    ids[:e] = dst_local
    return build_csc_plan(ids, n_pad)
