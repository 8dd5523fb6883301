// Per-destination, feature-wise max of edge messages: the Sum stage of
// max-pooling GraphSAGE (SAGE-max).
//
// Replaces: src/repro/kernels/segment_sum.py, segment_max_csc (body
// _segment_max_kernel), the TPU kernel that expands each edge chunk of a
// 128-row destination block into a (BE, BN, BD) masked candidate tensor
// on the VPU (max has no matrix-unit form) and reduces it, d-tiled to fit
// VMEM.
//
// Semantics kept from the TPU kernel: an empty row gives NEG (-1e30; the
// combine clamps it to 0), and a NaN among a row's entries makes that
// row's output NaN, as jnp.maximum propagates it. fmaxf would drop the
// NaN, so the max is written out: take v when v > acc or v is NaN. Every
// merge of partial results, across sub-warps and across pieces of a
// row, uses the same max_nan.
//
// Bound on the H100: bytes. Each message row is read once and each
// output row written once; one comparison per element read, far below
// the card's float32 rate, so the floor is (E*D + N*D) * 4 bytes, plus
// the plan's 4 bytes per edge and row, over 3.35 TB/s.
//
// Design: the row-and-piece schedule of row_pieces.cuh, so that no
// row's degree sets the time: a warp per row takes its first kPiece
// edges, and the rest of a long row is cut into pieces of kPiece edges
// counted from the row's start, one more warp per piece (the
// 1,000,000-node alipay_like plan's 2,832-edge row is 45 warps' work). A warp stages
// its edge ids in shared memory. Lanes stride over the feature axis
// with 16-byte loads when D % 4 == 0; when a row is narrower than the
// warp (D 64: 16 float4s), the warp splits into 2 (or more) sub-warps
// that take alternate edges, so no lane idles, each issuing kUnroll
// edges' loads before it compares them, and merges them by shuffles at
// the piece's end in a fixed order. A piece that is a whole row is
// written straight to `out`; a cut row leaves a partial max per unit in
// scratch, which the second launch (segment_max_merge) folds in plan
// order. Both launches are sized by the plan's max_pieces, and a piece
// warp past piece_ptr[N] exits (row_pieces.cuh). Deterministic as row_pieces.cuh says: the same plan and data
// give the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_pieces.cuh"

namespace {

using namespace row_pieces;

constexpr int kUnroll = 4;  // edges whose loads a sub-warp issues at once

// acc = max(acc, v), propagating NaN from either side
__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ void max_to(float4& acc, const float4& v) {
  acc.x = max_nan(acc.x, v.x);
  acc.y = max_nan(acc.y, v.y);
  acc.z = max_nan(acc.z, v.z);
  acc.w = max_nan(acc.w, v.w);
}

__device__ __forceinline__ void max_to(float& acc, const float& v) {
  acc = max_nan(acc, v);
}

__device__ __forceinline__ void set_neg(float4& acc) {
  acc = make_float4(kNeg, kNeg, kNeg, kNeg);
}

__device__ __forceinline__ void set_neg(float& acc) { acc = kNeg; }

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(kFullMask, v, off);
}

__device__ __forceinline__ float4 shfl_xor(const float4& v, int off) {
  return make_float4(shfl_xor(v.x, off), shfl_xor(v.y, off),
                     shfl_xor(v.z, off), shfl_xor(v.w, off));
}

// The warp's lanes over a row's `width` Ts: sub-warps of `lanes` lanes
// (the smallest power of two >= width, at most 32) take alternate edges.
struct Lanes {
  int lanes, subs, sub;
};

__device__ __forceinline__ Lanes lanes_for(int64_t width, int lane) {
  const int l = pow2_lanes(width);
  return {l, 32 / l, lane / l};
}

// Column c's max over the `count` edges ids[0..count), merged across
// the sub-warps: every lane of the warp must call it.
template <typename T>
__device__ T fold(const T* __restrict__ data, const int* ids, int count,
                  int64_t width, int64_t c, bool active, const Lanes& ln) {
  T acc;
  set_neg(acc);
  for (int t = ln.sub; t < count; t += ln.subs * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tu = t + u * ln.subs;
      if (active && tu < count)
        v[u] = data[(int64_t)ids[tu] * width + c];
      else
        set_neg(v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) max_to(acc, v[u]);
  }
  for (int off = ln.lanes; off < 32; off <<= 1)
    max_to(acc, shfl_xor(acc, off));
  return acc;
}

// One row piece: fold its `count` staged edges and write the max to
// dst (a row of out, or a slot).
template <typename T>
__device__ __forceinline__ void piece(const T* __restrict__ data,
                                      const int* ids, int count,
                                      T* __restrict__ dst, int64_t width,
                                      const Lanes& ln, int lane) {
  for (int64_t c0 = 0; c0 < width; c0 += ln.lanes) {
    const int64_t c = c0 + lane % ln.lanes;
    const bool active = c < width;
    const T acc = fold(data, ids, count, width, c, active, ln);
    if (ln.sub == 0 && active) dst[c] = acc;
  }
}

// T is float4 (D % 4 == 0, 16-byte aligned) or float; `width` counts Ts.
// carry: (pieces, 2, width) partials; merge_row: per piece, the row
// whose last piece it is and whose partials the second launch folds, or
// -1.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_max_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                   const int* __restrict__ indptr,
                   const int* __restrict__ piece_ptr, T* __restrict__ out,
                   T* __restrict__ carry, int* __restrict__ merge_row,
                   int n, int64_t width, int64_t warps) {
  __shared__ int s_ids[kWarpsPerBlock][kPiece];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t k = (int64_t)blockIdx.x * kWarpsPerBlock + w;
  if (k >= warps) return;  // uniform across the warp
  if (k >= n && !has_piece(piece_ptr, n, k - n)) return;
  const Unit u = unit_of(indptr, piece_ptr, n, k, merge_row, lane);
  for (int t = lane; t < u.b - u.a; t += 32) s_ids[w][t] = perm[u.a + t];
  __syncwarp();
  piece(data, s_ids[w], u.b - u.a,
        u.slot < 0 ? out + (int64_t)u.row * width : carry + u.slot * width,
        width, lanes_for(width, lane), lane);
}

// One warp per piece: finish the cut row whose last piece it is,
// folding the row's partials in row order, slot 1 of its first piece
// (its row unit's), then slot 0 of each of its pieces.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_max_merge(const int* __restrict__ piece_ptr,
                  const T* __restrict__ carry,
                  const int* __restrict__ merge_row, T* __restrict__ out,
                  int n, int64_t width, int64_t units) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= units || !has_piece(piece_ptr, n, k)) return;
  const int r = merge_row[k];
  if (r < 0) return;  // uniform across the warp
  const int64_t first = piece_ptr[r];
  for (int64_t c = lane; c < width; c += 32) {
    T acc = carry[(first * 2 + 1) * width + c];
    for (int64_t q = first; q <= k; ++q)
      max_to(acc, carry[(q * 2) * width + c]);
    out[(int64_t)r * width + c] = acc;
  }
}

template <typename T>
void launch(const T* data, const int* perm, const int* indptr,
            const int* piece_ptr, T* out, char* scratch, int64_t num_segments,
            int64_t max_pieces, int64_t width, cudaStream_t s) {
  const Schedule sc = schedule_for(num_segments, max_pieces);
  int* merge_row = reinterpret_cast<int*>(scratch);
  T* carry = reinterpret_cast<T*>(scratch + carry_offset(sc.units));
  const dim3 block(32 * kWarpsPerBlock);
  segment_max_kernel<T><<<blocks_for(sc.warps), block, 0, s>>>(
      data, perm, indptr, piece_ptr, out, carry, merge_row,
      (int)num_segments, width, sc.warps);
  if (sc.units > 0)  // a shape test: the merge runs for every view
    segment_max_merge<T><<<blocks_for(sc.units), block, 0, s>>>(
        piece_ptr, carry, merge_row, out, (int)num_segments, width,
        sc.units);
}

}  // namespace

// Bytes of scratch segment_max_f32 needs for a plan of num_segments rows
// and at most max_pieces pieces at width dim.
extern "C" int64_t segment_max_scratch_bytes(int64_t num_segments,
                                             int64_t max_pieces,
                                             int64_t dim) {
  return scratch_bytes(schedule_for(num_segments, max_pieces).units,
                       dim * 4);
}

// data (E, dim) f32, perm (E,) int32, indptr and piece_ptr
// (num_segments+1,) int32, max_pieces (row_pieces.cuh's bound for E
// edges), scratch (segment_max_scratch_bytes, 16-byte aligned) -> out
// (num_segments, dim) f32. Two launches on `stream` (one when E <
// kPiece). Returns cudaGetLastError().
extern "C" int segment_max_f32(const void* data, const void* perm,
                               const void* indptr, const void* piece_ptr,
                               void* out, void* scratch,
                               int64_t num_segments, int64_t max_pieces,
                               int64_t dim, void* stream) {
  if (num_segments <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && (uintptr_t)data % 16 == 0 &&
                    (uintptr_t)out % 16 == 0 && (uintptr_t)scratch % 16 == 0;
  if (vec4) {
    launch(static_cast<const float4*>(data), static_cast<const int*>(perm),
           static_cast<const int*>(indptr),
           static_cast<const int*>(piece_ptr), static_cast<float4*>(out),
           static_cast<char*>(scratch), num_segments, max_pieces, dim / 4, s);
  } else {
    launch(static_cast<const float*>(data), static_cast<const int*>(perm),
           static_cast<const int*>(indptr),
           static_cast<const int*>(piece_ptr), static_cast<float*>(out),
           static_cast<char*>(scratch), num_segments, max_pieces, dim, s);
  }
  return (int)cudaGetLastError();
}
