// The row-and-piece schedule that segment_max.cu and edge_softmax.cu
// share, so that no row's degree sets a kernel's time.
//
// The first launch has one warp per unit. Unit k < N is row k: its
// first kPiece edges, [s, min(e, s + kPiece)) with s = indptr[k] and
// e = indptr[k + 1]. Unit N + q is piece q: the edges of
// [q*kPiece, (q+1)*kPiece) along the plan's edge axis that lie past
// their row's first kPiece, so a row of d edges costs 1 + d / kPiece
// warps, each a bounded walk (the 20,000-node alipay_like layer's
// 412-edge row is 7 warps' work). Only the indptr[N] real edges are
// cut: pad edges sort past indptr[N] and join no row.
//
// A unit that holds a whole row writes it out. A row that is cut
// leaves one partial per unit in scratch: slot 1 of the piece index
// where it starts (indptr[r] / kPiece) from its row unit, slot 0 of
// each piece unit it reaches. The second launch gives each cut row to
// the warp of the piece that holds its end (merge_row[q] = r, else
// -1), which folds slot 1 of the first piece and slot 0 of each later
// one, in plan order, and writes the row.
//
// Deterministic: the units are a function of the plan alone
// (compile-time sizes; nothing depends on the SM count or timing),
// each output row and each slot has one writer, there are no atomics,
// and every merge runs in a fixed order.
#pragma once

#include <stdint.h>

namespace row_pieces {

constexpr int kWarpsPerBlock = 8;
constexpr int kPiece = 64;  // a warp's edges of one row
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;  // the port's masking sentinel, kernels/ref.py

// #{r in [lo, hi) : (by_item ? r : 0) + indptr[r+1] < d}, given that
// every r < lo counts: without by_item, the rows that end by edge
// d - 1; with it (edge_softmax.cu's merge-path chunks), the rows whose
// end marker comes before item d. The key rises with r, so the warp
// narrows [lo, hi) by 32 probes a round; every lane returns the same
// value.
__device__ inline int count_rows(const int* __restrict__ indptr, int lo,
                                 int hi, bool by_item, int64_t d, int lane) {
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool less =
        p < hi && (by_item ? (int64_t)p : 0) + indptr[p + 1] < d;
    const int c = __popc(__ballot_sync(kFullMask, less));
    if (c == 0) {
      hi = lo;
    } else {
      const int next = lo + c * step;
      lo += (c - 1) * step + 1;
      if (c < 32 && next < hi) hi = next;
    }
  }
  return lo;
}

// Unit k's work: edges [a, b) of row `row`, written out whole when
// slot < 0, else as the partial at slot index `slot` (unit * 2 + 0 or
// 1). `live` is false for a piece that holds none of its row's edges;
// a row unit is live even when its row is empty. Lane 0 of a piece
// unit also sets merge_row[q]. Every lane must call it.
struct Unit {
  int row, a, b;
  int64_t slot;
  bool live;
};

__device__ inline Unit unit_of(const int* __restrict__ indptr, int n,
                               int64_t k, int* __restrict__ merge_row,
                               int lane) {
  if (k < n) {
    const int s = indptr[k], e = indptr[k + 1];
    const int b = e - s > kPiece ? s + kPiece : e;
    return {(int)k, s, b, b == e ? -1 : (int64_t)(s / kPiece) * 2 + 1,
            true};
  }
  const int64_t q = k - n;
  const int64_t p0 = q * kPiece;
  if (p0 >= indptr[n]) {
    if (lane == 0) merge_row[q] = -1;
    return {0, 0, 0, -1, false};
  }
  const int r = count_rows(indptr, 0, n, false, p0 + 1, lane);
  const int s = indptr[r], e = indptr[r + 1];
  const int a = p0 > s + kPiece ? (int)p0 : s + kPiece;
  const int b = p0 + kPiece < e ? (int)(p0 + kPiece) : e;
  if (lane == 0) merge_row[q] = (a < b && b == e) ? r : -1;
  return {r, a, b, q * 2, a < b};
}

// The piece index whose slot 1 holds cut row r's first partial.
__device__ inline int64_t first_piece(const int* __restrict__ indptr,
                                      int r) {
  return indptr[r] / kPiece;
}

// A plan's schedule: the first launch's warps (rows, then pieces) and
// the pieces, which hold partials and merge them.
struct Schedule {
  int64_t warps, units;
};

inline Schedule schedule_for(int64_t num_segments, int64_t num_edges) {
  const int64_t pieces = (num_edges + kPiece - 1) / kPiece;
  return {num_segments + pieces, pieces};
}

// Scratch layout: merge_row (units int32), then the partials from this
// byte offset, 16-byte aligned: (units, 2, slot) elements.
inline int64_t carry_offset(int64_t units) {
  return (units * 4 + 15) / 16 * 16;
}

inline int64_t scratch_bytes(int64_t units, int64_t slot_bytes) {
  return carry_offset(units) + units * 2 * slot_bytes;
}

inline unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace row_pieces
