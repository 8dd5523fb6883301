"""The Sum-stage plan: destination-sorted edge order, built on the host.

The TPU plan (``repro/kernels/ops.py:CSCPlan``) pads every 128-row
destination block to a common lane count for a one-hot matmul; that
geometry is a TPU adaptation. On the GPU warps walk destination rows
and pieces of rows, so the plan keeps only the contracts:

- ``perm`` (E,): edge ids sorted by destination, stable;
- ``indptr`` (N+1,): row ``i`` owns ``perm[indptr[i]:indptr[i+1]]``;
- ``edge_dst`` (E,): each edge's destination row, the inverse map the
  backward kernels read (pad edges hold ``num_segments``);
- ``piece_ptr`` (N+1,): the prefix sum over the rows of each row's
  pieces, ``max(0, ceil((deg - PIECE) / PIECE))``: the kernels' row
  and piece schedule (``csrc/row_pieces.cuh``) cuts a row of more than
  ``PIECE`` edges into pieces counted from the row's start, so a row's
  cuts are a function of its length alone. ``num_pieces`` is
  ``piece_ptr[N]`` and ``num_real_edges`` is ``indptr[N]``, kept on the
  host for reports and the plain versions; both change from view to view
  within a bucket.
- ``max_pieces``: ``E // PIECE``, a bound on ``num_pieces`` that depends
  on the edge count alone (a row of ``d > 0`` edges has
  ``ceil(d / PIECE) - 1 <= d / PIECE`` pieces). A kernel launch sizes its
  grid and scratch from it and reads the true counts from the device
  (``piece_ptr[N]``, ``indptr[N]``), so one launch, and one CUDA graph
  captured over it, fits every view of a bucket.

Edges whose segment id is ``num_segments`` or more (the pad edges of a
bucket) sort past ``indptr[-1]`` and join no row, so the kernels read
each real edge once and need no atomics. Built once per graph or per
staged view, with numpy; work is O(E) (a stable radix sort). Each build
is a ``plan.build`` span (:mod:`repro_torch.utils.trace`).

The same plan over the *source* ids (a block's ``src_plan``) turns the
backward of the NN-G gather ``n[src]`` into a per-source segment sum,
so it too runs in a fixed order with no atomics.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.utils import trace

# edges per unit of the kernels' schedule, csrc/row_pieces.cuh's kPiece
PIECE = 64


@dataclass(frozen=True)
class CSCPlan:
    perm: torch.Tensor         # (E,) int32
    indptr: torch.Tensor       # (N+1,) int32
    edge_dst: torch.Tensor     # (E,) int32, pad edges = num_segments
    num_segments: int
    num_edges: int
    piece_ptr: torch.Tensor    # (N+1,) int32, pieces before each row
    num_pieces: int
    num_real_edges: int        # indptr[N]; the rest are pad edges

    @property
    def max_pieces(self) -> int:
        """A bound on ``num_pieces`` from the edge count alone."""
        return self.num_edges // PIECE

    def to(self, device, copy: bool = False) -> "CSCPlan":
        return replace(self, perm=self.perm.to(device, copy=copy),
                       indptr=self.indptr.to(device, copy=copy),
                       edge_dst=self.edge_dst.to(device, copy=copy),
                       piece_ptr=self.piece_ptr.to(device, copy=copy))


def _stable_order(ids: np.ndarray) -> np.ndarray:
    """``np.argsort(ids, kind="stable")`` for non-negative int32 ids, as
    one or two passes of numpy's radix sort over 16-bit digits (its
    stable sort of wider integers is a merge sort, several times
    slower on unsorted ids)."""
    if len(ids) == 0 or int(ids.max()) < 1 << 16:
        return np.argsort(ids.astype(np.uint16), kind="stable")
    low = np.argsort((ids & 0xFFFF).astype(np.uint16), kind="stable")
    return low[np.argsort((ids[low] >> 16).astype(np.uint16),
                          kind="stable")]


def build_csc_plan(segment_ids: np.ndarray, num_segments: int) -> CSCPlan:
    """Plan over ``segment_ids`` (E,); ids at or past ``num_segments``
    are pad edges and join no row."""
    with trace.span("plan.build"):
        return _plan(segment_ids, num_segments)


def _plan(segment_ids: np.ndarray, num_segments: int) -> CSCPlan:
    ids = np.asarray(segment_ids).astype(np.int64)
    E = len(ids)
    if E >= 2 ** 31 or num_segments >= 2 ** 31:
        raise ValueError(f"{E} edges / {num_segments} segments overflow "
                         "the kernels' int32 indices")
    if E and int(ids.min()) < 0:
        raise ValueError("negative segment id")
    valid = ids < num_segments
    edge_dst = np.where(valid, ids, num_segments).astype(np.int32)
    perm = _stable_order(edge_dst).astype(np.int32)
    counts = np.bincount(ids[valid], minlength=num_segments)
    indptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    piece_ptr = np.zeros(num_segments + 1, np.int64)
    np.cumsum(np.maximum(0, -(-(counts - PIECE) // PIECE)),
              out=piece_ptr[1:])
    return CSCPlan(torch.from_numpy(perm),
                   torch.from_numpy(indptr.astype(np.int32)),
                   torch.from_numpy(edge_dst), int(num_segments), E,
                   torch.from_numpy(piece_ptr.astype(np.int32)),
                   int(piece_ptr[-1]), int(indptr[-1]))


def build_bucket_csc_plan(dst_local: np.ndarray, n_pad: int,
                          e_pad: int) -> CSCPlan:
    """Plan for one bucket-padded compact block: the view's ``e`` real
    edges, then ``e_pad - e`` pad edges with id ``n_pad`` that join no
    row. Leaf shapes are a function of the bucket alone. Over the view's
    ``src_local`` it is the block's source plan."""
    e = len(dst_local)
    if e > e_pad:
        raise ValueError(f"{e} edges do not fit the bucket's e_pad={e_pad}")
    if e and int(dst_local.max()) >= n_pad:
        raise ValueError(f"destination id {int(dst_local.max())} outside "
                         f"the bucket's n_pad={n_pad}")
    ids = np.full(e_pad, n_pad, np.int32)
    ids[:e] = dst_local
    return build_csc_plan(ids, n_pad)


def build_csc_plans_stacked(ids: np.ndarray, mask: np.ndarray,
                            num_segments: int) -> list:
    """One plan per row of ``ids`` (P, E) over ``num_segments`` segments,
    all of the same shapes (the counterpart of the reference's
    ``build_csc_plans_stacked``, without its lane padding): the plans of
    a partitioning's shards. Entries whose ``mask`` is 0 are pad edges and
    join no row (``build_csc_plan``'s rule)."""
    ids = np.asarray(ids)
    return [build_csc_plan(np.where(np.asarray(m) > 0, row, num_segments),
                           num_segments) for row, m in zip(ids, mask)]

