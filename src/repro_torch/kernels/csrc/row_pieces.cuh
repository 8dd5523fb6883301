// The row-and-piece schedule that segment_sum.cu, segment_max.cu,
// edge_softmax.cu and edge_softmax_bwd.cu share, so that no row's
// degree sets a kernel's time, and the 16-byte column groups that
// segment_sum.cu and edge_softmax_bwd.cu read rows by.
//
// A row's units are cut relative to the row: with s = indptr[r] and
// e = indptr[r + 1], its row unit is its first kPiece edges,
// [s, min(e, s + kPiece)), and its piece j >= 1 is
// [s + j*kPiece, min(e, s + (j+1)*kPiece)). Where a row is cut is then a
// function of its length alone, not of its offset in the plan, so the
// same row in two plans (a served target's top layer over a 1-hop view
// and over a K-hop one) is cut the same way and sums in the same order.
// A row of d edges has max(0, ceil((d - kPiece) / kPiece)) pieces;
// piece_ptr (N+1, the plan's, kernels/plan.py) is their prefix sum over
// the rows, so row r's pieces are piece_ptr[r] .. piece_ptr[r+1] - 1 and
// the plan has num_pieces = piece_ptr[N] of them. Only the indptr[N]
// real edges are cut: pad edges sort past indptr[N] and join no row.
//
// The host sizes every launch from the plan's shapes alone: a row of
// d > 0 edges has ceil(d / kPiece) - 1 <= d / kPiece pieces, so
// max_pieces(E) = E / kPiece bounds num_pieces for any plan of E edges
// (pad edges included), and ceil(E / kPiece) bounds the kPiece-edge runs
// of its pad edges. The kernels read the true counts, piece_ptr[N] and
// indptr[N], from the device, and a unit past them exits at once. So
// the grid, the scratch and the launches are the same for every view of
// a bucket, and one CUDA graph captured over one view replays for all of
// them; the units that run, and their order, are those of the true
// counts, so the bits are too.
//
// The first launch has one warp per unit: unit k < N is row k's row
// unit, unit N + p is piece p, which finds its row by a 32-way warp
// search over piece_ptr (the 20,000-node alipay_like layer's 412-edge
// row is 7 warps' work). A unit that holds a whole row writes it out. A
// row that is cut leaves one partial per unit in scratch: slot 1 of its
// first piece piece_ptr[r] from its row unit, slot 0 of each piece. The
// second launch, one warp per piece up to max_pieces, gives each cut row
// to the warp of its last piece (merge_row[p] = r, else -1), which folds
// slot 1 of the first piece and slot 0 of each piece, in row order, and
// writes the row.
//
// Deterministic: the units are a function of the plan alone
// (compile-time sizes; nothing depends on the SM count or timing),
// each output row and each slot has one writer, there are no atomics,
// and every merge runs in a fixed order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_pieces {

constexpr int kWarpsPerBlock = 8;
constexpr int kPiece = 64;  // a warp's edges of one row
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;  // the port's masking sentinel, kernels/ref.py

// #{r in [lo, hi) : (by_item ? r : 0) + ptr[r+1] < d}, given that every
// r < lo counts: without by_item, over piece_ptr, the rows whose pieces
// end by piece d - 1; with it (edge_softmax.cu's merge-path chunks,
// over indptr), the rows whose end marker comes before item d. The key
// rises with r, so the warp narrows [lo, hi) by 32 probes a round;
// every lane returns the same value.
__device__ inline int count_rows(const int* __restrict__ ptr, int lo, int hi,
                                 bool by_item, int64_t d, int lane) {
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool less = p < hi && (by_item ? (int64_t)p : 0) + ptr[p + 1] < d;
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
// slot < 0, else as the partial at slot index `slot` (piece * 2 + 0 or
// 1). A row unit may be an empty row.
struct Unit {
  int row, a, b;
  int64_t slot;
};

// The row unit of row k < n.
__device__ inline Unit row_unit(const int* __restrict__ indptr,
                                const int* __restrict__ piece_ptr, int k) {
  const int s = indptr[k], e = indptr[k + 1];
  const int b = e - s > kPiece ? s + kPiece : e;
  return {k, s, b, b == e ? -1 : (int64_t)piece_ptr[k] * 2 + 1};
}

// Piece p < piece_ptr[n]. Lane 0 also sets merge_row[p], unless
// merge_row is null (a kernel with no merge). Every lane must call it.
__device__ inline Unit piece_unit(const int* __restrict__ indptr,
                                  const int* __restrict__ piece_ptr, int n,
                                  int64_t p, int* __restrict__ merge_row,
                                  int lane) {
  const int r = count_rows(piece_ptr, 0, n, false, p + 1, lane);
  const int s = indptr[r], e = indptr[r + 1];
  const int a = s + (int)(p - piece_ptr[r] + 1) * kPiece;
  const int b = a + kPiece < e ? a + kPiece : e;
  if (lane == 0 && merge_row) merge_row[p] = b == e ? r : -1;
  return {r, a, b, p * 2};
}

__device__ inline Unit unit_of(const int* __restrict__ indptr,
                               const int* __restrict__ piece_ptr, int n,
                               int64_t k, int* __restrict__ merge_row,
                               int lane) {
  return k < n ? row_unit(indptr, piece_ptr, (int)k)
               : piece_unit(indptr, piece_ptr, n, k - n, merge_row, lane);
}

// The bound on the pieces of any plan of num_edges edges.
inline int64_t max_pieces(int64_t num_edges) { return num_edges / kPiece; }

// The bound on the kPiece-edge runs of its pad edges.
inline int64_t max_pad_runs(int64_t num_edges) {
  return (num_edges + kPiece - 1) / kPiece;
}

// Whether piece p exists in the plan: p < piece_ptr[n], read from the
// device (every lane reads the same word, so the branch is uniform).
__device__ inline bool has_piece(const int* __restrict__ piece_ptr, int n,
                                 int64_t p) {
  return p < piece_ptr[n];
}

// A plan's schedule: the first launch's warps (rows, then up to
// max_pieces pieces) and the pieces, which hold partials and merge them.
struct Schedule {
  int64_t warps, units;
};

inline Schedule schedule_for(int64_t num_segments, int64_t max_pieces) {
  return {num_segments + max_pieces, max_pieces};
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

// The lanes a row of `count` columns takes: the smallest power of two
// >= count, at most 32.
__host__ __device__ inline int pow2_lanes(int64_t count) {
  int l = 1;
  while (l < 32 && l < count) l <<= 1;
  return l;
}

// Group c (floats 4c..4c+3) of a row of `dim` floats: one 16-byte access
// when kVec (dim % 4 == 0, the row 16-byte aligned), else up to 4 scalar
// ones that stop at dim.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row,
                                        int64_t c, int64_t dim) {
  if (kVec) return reinterpret_cast<const float4*>(row)[c];
  const int64_t i = 4 * c;
  return make_float4(row[i], i + 1 < dim ? row[i + 1] : 0.f,
                     i + 2 < dim ? row[i + 2] : 0.f,
                     i + 3 < dim ? row[i + 3] : 0.f);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ row, int64_t c,
                                       int64_t dim, const float4& v) {
  if (kVec) {
    reinterpret_cast<float4*>(row)[c] = v;
    return;
  }
  const int64_t i = 4 * c;
  row[i] = v.x;
  if (i + 1 < dim) row[i + 1] = v.y;
  if (i + 2 < dim) row[i + 2] = v.z;
  if (i + 3 < dim) row[i + 3] = v.w;
}

}  // namespace row_pieces
