// Per-destination sum of edge messages: the Sum stage of GCN and of SAGE
// with sum or mean combine, and, over a block's source plan, the
// backward of the NN-G gathers (core/tgar.py, _PlannedGather).
//
// Replaces: src/repro/kernels/segment_sum.py, segment_sum_csc (body
// _segment_sum_kernel), the TPU kernel that sums the messages of each
// 128-row destination block as a one-hot matmul on the MXU.
//
// Bound on the H100: bytes. Each message row is read once and each
// output row written once; there is one add per element read, far below
// the card's 67 TFLOP/s of float32, so the floor is
// (E*D + N*D) * 4 bytes (plus the plan's 4 bytes per edge and row) over
// 3.35 TB/s.
//
// Design: the row-and-piece schedule of row_pieces.cuh (a row's first
// kPiece edges, then pieces of kPiece edges counted from the row's
// start), so that no row's degree sets the time, with the warp's lanes
// fitted to narrow rows. A lane holds a group of 4 floats (a 16-byte
// load where D % 4 == 0 and the operands are aligned, else 4 masked
// loads); a row of G = ceil(D / 4) groups takes sub-warps of L lanes, L
// the power of two >= G (at most 32), and a warp has S = 32 / L of them.
// - A row warp takes S consecutive rows, and each sub-warp sums its
//   row's row unit (up to kPiece edges) alone, in edge order, kUnroll
//   edges' message loads in flight while the next kUnroll ids load:
//   the power-law plans' 6-edge rows fill the warp's lanes (at the
//   gathers' width 4, 32 rows a warp) where a warp per row would leave
//   26 of 32 lanes idle. A row warp's time is its longest row unit's
//   (at most kPiece edges), which a whole-warp walk of each long row in
//   turn would not bound: the power-law graphs' hub rows sit side by
//   side in the first warps. Where a row fills the warp (S = 1, D > 64:
//   the GCN cells' 128), the lanes load 32 ids at a time, one each, and
//   share them by shuffles.
// - A piece warp finds its row by a 32-way search over piece_ptr,
//   stages its edge ids in shared memory, and its S sub-warps take
//   alternate edges, counted from the piece's start, each summing its
//   edges in order; they merge by xor shuffles in a fixed tree. A cut
//   row leaves a partial per unit in scratch, and the second launch
//   (segment_sum_merge) adds them in row order: the row unit's, then
//   each piece's. Both launches are sized by the plan's max_pieces, and
//   a piece warp past piece_ptr[N] exits (row_pieces.cuh).
// So a row's order of summation is a function of its length, its edges'
// order and D alone: the same row gives the same bits in any plan and at
// any offset (a served cache hit equals a full recompute), and on every
// run: no atomics, each output and slot has one writer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_pieces.cuh"

namespace {

using namespace row_pieces;

constexpr int kUnroll = 8;  // edges whose loads a sub-warp issues at once

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ float4 shfl_xor(const float4& v, int off) {
  return make_float4(__shfl_xor_sync(kFullMask, v.x, off),
                     __shfl_xor_sync(kFullMask, v.y, off),
                     __shfl_xor_sync(kFullMask, v.z, off),
                     __shfl_xor_sync(kFullMask, v.w, off));
}

// The warp's lanes over a row of `groups` groups: sub-warps of `lanes`
// lanes (the smallest power of two >= groups, at most 32).
struct Lanes {
  int lanes, subs, sub, li;
};

// Group g of the sum over edges perm[a:b], in edge order: kUnroll
// edges' message loads in flight while the next kUnroll ids load.
template <bool kVec>
__device__ __forceinline__ float4 walk(const float* __restrict__ data,
                                       const int* __restrict__ perm, int a,
                                       int b, int64_t dim, int64_t g) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int ids[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) ids[u] = a + u < b ? perm[a + u] : -1;
  for (int t = a; t < b; t += kUnroll) {
    int next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tn = t + kUnroll + u;
      next[u] = tn < b ? perm[tn] : -1;
    }
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = ids[u] >= 0 ? load4<kVec>(data + (int64_t)ids[u] * dim, g, dim)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    // adding the +0 of an edge past the end changes no bit: acc starts
    // at +0 and a round-to-nearest sum is never -0 from it
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_to(acc, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ids[u] = next[u];
  }
  return acc;
}

// walk with a whole warp on one row (S = 1): the lanes load 32 ids at a
// time, one each, and take them in turn by shuffles; the same sum. Every
// lane must call it (`active`: whether group g is the lane's).
template <bool kVec>
__device__ __forceinline__ float4 walk_warp(const float* __restrict__ data,
                                            const int* __restrict__ perm,
                                            int a, int b, int64_t dim,
                                            int64_t g, bool active,
                                            int lane) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = a; base < b; base += 32) {
    const int mine = base + lane < b ? perm[base + lane] : 0;
    const int count = b - base < 32 ? b - base : 32;
    for (int j = 0; j < count; j += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t e = __shfl_sync(kFullMask, mine, (j + u) & 31);
        v[u] = active && j + u < count
                   ? load4<kVec>(data + e * dim, g, dim)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_to(acc, v[u]);  // +0s: see walk
    }
  }
  return acc;
}

// A piece: its `count` edge ids staged in ids[]; sub-warp i sums edges
// i, i + subs, ... in order, and the tree merges the sub-warps. Writes
// group g to dst_slot (carry).
template <bool kVec>
__device__ __forceinline__ void piece_sum(const float* __restrict__ data,
                                          const int* ids, int count,
                                          int64_t dim, int64_t groups,
                                          float4* __restrict__ dst_slot,
                                          Lanes ln) {
  for (int64_t g0 = 0; g0 < groups; g0 += ln.lanes) {
    const int64_t g = g0 + ln.li;
    const bool active = g < groups;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = ln.sub; t < count; t += ln.subs * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tu = t + u * ln.subs;
        v[u] = active && tu < count
                   ? load4<kVec>(data + (int64_t)ids[tu] * dim, g, dim)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_to(acc, v[u]);  // +0s: see walk
    }
    for (int off = ln.lanes; off < 32; off <<= 1)
      add_to(acc, shfl_xor(acc, off));
    if (ln.sub == 0 && active) dst_slot[g] = acc;
  }
}

// carry: (pieces, 2, groups) float4 partials; merge_row: per piece, the
// row whose last piece it is, or -1. Warps: row_warps row warps of
// `subs` rows each, then one per piece.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_kernel(const float* __restrict__ data,
                   const int* __restrict__ perm,
                   const int* __restrict__ indptr,
                   const int* __restrict__ piece_ptr,
                   float* __restrict__ out, float4* __restrict__ carry,
                   int* __restrict__ merge_row, int n, int64_t dim,
                   int64_t row_warps, int64_t warps) {
  __shared__ int s_ids[kWarpsPerBlock][kPiece];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t k = (int64_t)blockIdx.x * kWarpsPerBlock + w;
  if (k >= warps) return;  // uniform across the warp
  const int64_t groups = (dim + 3) / 4;
  const int l = pow2_lanes(groups);
  const Lanes ln{l, 32 / l, lane / l, lane % l};
  if (k >= row_warps) {  // a piece
    if (!has_piece(piece_ptr, n, k - row_warps)) return;
    const Unit u = piece_unit(indptr, piece_ptr, n, k - row_warps,
                              merge_row, lane);
    for (int t = lane; t < u.b - u.a; t += 32) s_ids[w][t] = perm[u.a + t];
    __syncwarp();
    piece_sum<kVec>(data, s_ids[w], u.b - u.a, dim, groups,
                    carry + u.slot * groups, ln);
    return;
  }
  // a row warp: rows k*subs .. k*subs + subs - 1, one per sub-warp
  const int64_t r = k * ln.subs + ln.sub;
  if (r >= n) return;  // no shuffle follows
  const Unit u = row_unit(indptr, piece_ptr, (int)r);
  for (int64_t g0 = 0; g0 < groups; g0 += ln.lanes) {
    const int64_t g = g0 + ln.li;
    const bool active = g < groups;
    float4 acc;
    if (ln.subs == 1) {  // uniform: a warp on one row
      acc = walk_warp<kVec>(data, perm, u.a, u.b, dim, g, active, lane);
    } else {
      if (!active) break;  // only the last pass, and no shuffle follows
      acc = walk<kVec>(data, perm, u.a, u.b, dim, g);
    }
    if (!active) continue;
    if (u.slot < 0)
      store4<kVec>(out + r * dim, g, dim, acc);
    else
      carry[u.slot * groups + g] = acc;
  }
}

// One warp per piece: finish the cut row whose last piece it is, adding
// the row's partials in row order, slot 1 of its first piece (its row
// unit's), then slot 0 of each of its pieces.
template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_sum_merge(const int* __restrict__ piece_ptr,
                  const float4* __restrict__ carry,
                  const int* __restrict__ merge_row, float* __restrict__ out,
                  int n, int64_t dim, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= units || !has_piece(piece_ptr, n, k)) return;
  const int r = merge_row[k];
  if (r < 0) return;  // uniform across the warp
  const int64_t groups = (dim + 3) / 4;
  const int64_t first = piece_ptr[r];
  for (int64_t g = lane; g < groups; g += 32) {
    float4 acc = carry[(first * 2 + 1) * groups + g];
    for (int64_t q = first; q <= k; ++q)
      add_to(acc, carry[q * 2 * groups + g]);
    store4<kVec>(out + (int64_t)r * dim, g, dim, acc);
  }
}

// The first launch's row warps: rows of `dim` floats, `subs` a warp.
int64_t row_warps_for(int64_t num_segments, int64_t dim) {
  const int64_t subs = 32 / pow2_lanes((dim + 3) / 4);
  return (num_segments + subs - 1) / subs;
}

template <bool kVec>
void launch(const float* data, const int* perm, const int* indptr,
            const int* piece_ptr, float* out, char* scratch,
            int64_t num_segments, int64_t max_pieces, int64_t dim,
            cudaStream_t s) {
  const int64_t row_warps = row_warps_for(num_segments, dim);
  const int64_t warps = row_warps + max_pieces;
  int* merge_row = reinterpret_cast<int*>(scratch);
  float4* carry =
      reinterpret_cast<float4*>(scratch + carry_offset(max_pieces));
  const dim3 block(32 * kWarpsPerBlock);
  segment_sum_kernel<kVec><<<blocks_for(warps), block, 0, s>>>(
      data, perm, indptr, piece_ptr, out, carry, merge_row,
      (int)num_segments, dim, row_warps, warps);
  if (max_pieces > 0)  // a shape test: the merge runs for every view
    segment_sum_merge<kVec><<<blocks_for(max_pieces), block, 0, s>>>(
        piece_ptr, carry, merge_row, out, (int)num_segments, dim,
        max_pieces);
}

}  // namespace

// Bytes of scratch segment_sum_f32 needs for a plan of at most
// max_pieces pieces at width dim.
extern "C" int64_t segment_sum_scratch_bytes(int64_t max_pieces,
                                             int64_t dim) {
  return scratch_bytes(max_pieces, (dim + 3) / 4 * 16);
}

// data (E, dim) f32, perm (E,) int32, indptr and piece_ptr
// (num_segments+1,) int32, max_pieces (row_pieces.cuh's bound for E
// edges), scratch (segment_sum_scratch_bytes, 16-byte aligned) -> out
// (num_segments, dim) f32. Two launches on `stream` (one when E <
// kPiece). Returns cudaGetLastError().
extern "C" int segment_sum_f32(const void* data, const void* perm,
                               const void* indptr, const void* piece_ptr,
                               void* out, void* scratch,
                               int64_t num_segments, int64_t max_pieces,
                               int64_t dim, void* stream) {
  if (num_segments <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(data);
  const auto* pm = static_cast<const int*>(perm);
  const auto* ip = static_cast<const int*>(indptr);
  const auto* pp = static_cast<const int*>(piece_ptr);
  auto* o = static_cast<float*>(out);
  auto* scr = static_cast<char*>(scratch);
  if (dim % 4 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0)
    launch<true>(d, pm, ip, pp, o, scr, num_segments, max_pieces, dim, s);
  else
    launch<false>(d, pm, ip, pp, o, scr, num_segments, max_pieces, dim, s);
  return (int)cudaGetLastError();
}
