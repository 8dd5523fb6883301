// Backward of the per-destination edge softmax (GAT and GAT-E's Sum
// stage). With p_e the softmax weight of edge e among the in-edges of its
// destination row i, per head:
//     d_values[e]  = p_e * g[i]
//     d_logits[e]  = p_e * (values[e] . g[i] - og[i]),  og[i] = out[i] . g[i]
//
// Replaces: src/repro/kernels/backward.py, edge_softmax_bwd_csc (body
// _edge_softmax_bwd_kernel), the TPU kernel that rebuilds p_e per edge
// tile from the saved logits and the forward's per-row statistics (m,
// den), with the heads on its grid, in one launch.
//
// Semantics kept from the TPU kernel:
// - p_e = exp(logit_e - m_i) / max(den_i, 1e-20), and p_e = 0 where
//   logit_e <= NEG / 2. Masking works only through the NEG logits, so an
//   all-masked row (m = NEG, den = its edge count) gives zero gradients.
// - The row lookup clips, as jnp.take(..., mode="clip") does: a
//   bucket's pad edge (edge_dst == N, kernels/plan.py) reads row N - 1.
//   Outputs have the plan's edge count; the wrapper (kernels/ops.py)
//   returns empty tensors without a launch when there are no edges and
//   zeros when N = 0.
//
// Bound on the H100: bytes. Each edge's H logits and H*D values are read
// once and its H + H*D cotangents written once, and the rows' g, out, m
// and den are read; a few multiply-adds and one exponential per element
// are far below the float32 rate, so the floor is about
// (2*E*H*(1+D) + E + N*H*(2*D+2)) * 4 bytes over 3.35 TB/s.
//
// Design: the destination plan's rows and pieces (row_pieces.cuh), so
// that a row's g, out, m and den are read once a unit and not once an
// edge, with a lane per (edge, head): lh lanes an edge (the power of two
// >= H, at most 32), and each lane sums its head's D products, and takes
// og = out . g of its head, in its own registers, in a fixed order, with
// no shuffles. A row warp takes several row units, one per sub-warp of
// two edges' lanes (4 rows a warp at GAT-E's 4 heads of 8, where a warp
// per row left most of its time to the chain of dependent loads: indptr,
// perm, then the edges); a piece, or kPiece of the pad edges, takes a
// whole warp. A lane issues kUnroll edges' loads at once; where D is 4, 8
// or 16 (aligned), the width is a compile-time constant, so a lane's
// edges' logits and all their value groups load together and its head's
// g stays in registers (PERF.md times each step of this design). The
// edges come in plan order, at random edge ids, so a 4-head edge's 16
// bytes of d_logits half-fill a 32-byte sector of device memory; where
// the call's traffic exceeds the L2 cache the caller pads d_logits' rows
// to whole sectors, which the lanes fill with zeros past the heads. There
// is no merge: each output element belongs to one edge and is written by
// one lane, with no atomics, so the result is deterministic. The pad
// edges, perm[indptr[N]:E], join no row and get units of their own that
// read row N - 1, as the clip does. The grid holds max_pieces piece warps
// and max_pad_runs run warps (row_pieces.cuh's bounds from E); a warp
// past piece_ptr[N] or past E exits, so one launch fits every view of a
// bucket. Any H and D: 16-byte accesses where
// D % 4 == 0 and the operands are aligned, else scalar ones.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_pieces.cuh"

namespace {

using namespace row_pieces;

constexpr int kUnroll = 4;  // edges whose loads a lane issues at once

__device__ __forceinline__ float edge_weight(float x, float m, float den) {
  return x > kNeg / 2 ? expf(x - m) / fmaxf(den, 1e-20f) : 0.f;
}

// d_logits[e, h] in rows of dl_stride >= heads floats; the lane of head h
// also zeroes pad columns heads + h, heads + h + heads, ..., so that a
// padded row fills whole 32-byte sectors (see the entry point).
__device__ __forceinline__ void put_logit(float* __restrict__ d_logits,
                                          int64_t e, int64_t h, int64_t heads,
                                          int64_t dl_stride, float v) {
  float* row = d_logits + e * dl_stride;
  row[h] = v;
  for (int64_t j = heads + h; j < dl_stride; j += heads) row[j] = 0.f;
}

// acc += a * b, element by element: four chains of D / 4 terms each,
// summed once at the end (sum4), so a wide head sums as a short tree
__device__ __forceinline__ void fma4(float4& acc, const float4& a,
                                     const float4& b) {
  acc.x += a.x * b.x;
  acc.y += a.y * b.y;
  acc.z += a.z * b.z;
  acc.w += a.w * b.w;
}

__device__ __forceinline__ float sum4(const float4& a) {
  return (a.x + a.y) + (a.z + a.w);
}

__device__ __forceinline__ float4 scale4(float p, const float4& a) {
  return make_float4(p * a.x, p * a.y, p * a.z, p * a.w);
}

// Edges perm[a:b] of row r, by a group of lanes: lane (slot, hl) of the
// group takes head hl (and hl + lh, ... when there are more) of the
// unit's edges slot, slot + slots, ...; each lane sums its head's D
// products in its own registers, in a fixed order, and takes og for its
// head once. No shuffle: the lanes of a warp need not move together.
template <bool kVec>
__device__ __forceinline__ void unit_bwd(
    const float* __restrict__ g, const float* __restrict__ logits,
    const float* __restrict__ values, const float* __restrict__ m,
    const float* __restrict__ den, const float* __restrict__ out,
    const int* __restrict__ perm, int a, int b, int64_t r,
    float* __restrict__ d_logits, float* __restrict__ d_values,
    int64_t heads, int64_t dl_stride, int64_t dim, int slot, int slots,
    int hl, int lh) {
  const int64_t hd = heads * dim, groups = (dim + 3) / 4;
  for (int64_t h = hl; h < heads; h += lh) {
    const float* gr = g + r * hd + h * dim;
    const float* orow = out + r * hd + h * dim;
    const float mi = m[r * heads + h], di = den[r * heads + h];
    float4 og4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t c = 0; c < groups; ++c)
      fma4(og4, load4<kVec>(orow, c, dim), load4<kVec>(gr, c, dim));
    const float og = sum4(og4);
    for (int t = a + slot; t < b; t += kUnroll * slots) {
      int64_t e[kUnroll];
      float p[kUnroll];
      float4 prod[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tu = t + u * slots;
        e[u] = tu < b ? perm[tu] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = e[u] >= 0 ? edge_weight(logits[e[u] * heads + h], mi, di)
                         : 0.f;
        prod[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int64_t c = 0; c < groups; ++c) {
        const float4 gg = load4<kVec>(gr, c, dim);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e[u] < 0) continue;
          const int64_t at = e[u] * hd + h * dim;
          fma4(prod[u], load4<kVec>(values + at, c, dim), gg);
          store4<kVec>(d_values + at, c, dim, scale4(p[u], gg));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e[u] >= 0)
          put_logit(d_logits, e[u], h, heads, dl_stride,
                    p[u] * (sum4(prod[u]) - og));
    }
  }
}

// unit_bwd for aligned heads of D = 4 * kG floats, kG a compile-time
// count: a lane's kUnroll edges' logits and all their value groups load
// at once, and its head's g stays in registers. The same sums, in the
// same order, as unit_bwd.
template <int kG>
__device__ __forceinline__ void unit_bwd_small(
    const float* __restrict__ g, const float* __restrict__ logits,
    const float* __restrict__ values, const float* __restrict__ m,
    const float* __restrict__ den, const float* __restrict__ out,
    const int* __restrict__ perm, int a, int b, int64_t r,
    float* __restrict__ d_logits, float* __restrict__ d_values,
    int64_t heads, int64_t dl_stride, int slot, int slots, int hl, int lh) {
  const int64_t hg = heads * kG;  // float4 groups of a row
  const auto* g4 = reinterpret_cast<const float4*>(g);
  const auto* o4 = reinterpret_cast<const float4*>(out);
  const auto* v4 = reinterpret_cast<const float4*>(values);
  auto* dv4 = reinterpret_cast<float4*>(d_values);
  for (int64_t h = hl; h < heads; h += lh) {
    float4 gg[kG];
    float4 og4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kG; ++c) {
      gg[c] = g4[r * hg + h * kG + c];
      fma4(og4, o4[r * hg + h * kG + c], gg[c]);
    }
    const float og = sum4(og4);
    const float mi = m[r * heads + h], di = den[r * heads + h];
    for (int t = a + slot; t < b; t += kUnroll * slots) {
      int64_t e[kUnroll];
      float x[kUnroll];
      float4 v[kUnroll][kG];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tu = t + u * slots;
        e[u] = tu < b ? perm[tu] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = e[u] >= 0 ? logits[e[u] * heads + h] : 0.f;
#pragma unroll
        for (int c = 0; c < kG; ++c)
          v[u][c] = e[u] >= 0 ? v4[e[u] * hg + h * kG + c]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e[u] < 0) continue;
        const float p = edge_weight(x[u], mi, di);
        float4 prod = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kG; ++c) {
          fma4(prod, v[u][c], gg[c]);
          dv4[e[u] * hg + h * kG + c] = scale4(p, gg[c]);
        }
        put_logit(d_logits, e[u], h, heads, dl_stride,
                  p * (sum4(prod) - og));
      }
    }
  }
}

// A row warp's rows: sub-warps of two edges' lanes, one row each.
__host__ __device__ inline int rows_per_warp(int64_t heads) {
  const int lh = pow2_lanes(heads);
  return lh >= 16 ? 1 : 32 / (2 * lh);
}

// The operands and sizes of one call.
struct Args {
  const float *g, *logits, *values, *m, *den, *out;
  const int *perm, *indptr, *piece_ptr;
  float *d_logits, *d_values;
  int n;
  int64_t max_pieces, num_edges, heads, dl_stride, dim, row_warps, warps;
};

// Warps: row_warps row warps of rows_per_warp(heads) row units each (the
// lanes of two edges a row), then max_pieces for the pieces, then
// max_pad_runs for the kPiece-edge runs of pad edges, each with all 32
// lanes; a warp with no piece or run exits. kG > 0: aligned heads of 4 * kG floats
// (unit_bwd_small); else any D.
template <bool kVec, int kG>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_bwd_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int64_t k =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= p.warps) return;  // uniform across the warp
  const int lh = pow2_lanes(p.heads);
  int64_t r;
  int a, b, slot, slots;
  if (k < p.row_warps) {  // a row unit per sub-warp
    const int lanes = 32 / rows_per_warp(p.heads);
    r = k * (32 / lanes) + lane / lanes;
    if (r >= p.n) return;
    a = p.indptr[r];
    const int e = p.indptr[r + 1];
    b = e - a > kPiece ? a + kPiece : e;
    slot = (lane % lanes) / lh;
    slots = lanes / lh;
  } else {  // a piece, or kPiece pad edges, with all 32 lanes
    const int64_t q = k - p.row_warps;
    if (q < p.max_pieces) {
      if (!has_piece(p.piece_ptr, p.n, q)) return;  // uniform
      const Unit u = piece_unit(p.indptr, p.piece_ptr, p.n, q, nullptr, lane);
      r = u.row, a = u.a, b = u.b;
    } else {
      const int64_t at = p.indptr[p.n] + (q - p.max_pieces) * kPiece;
      if (at >= p.num_edges) return;  // uniform
      r = p.n - 1;
      a = (int)at;
      b = (int)(at + kPiece < p.num_edges ? at + kPiece : p.num_edges);
    }
    slot = lane / lh;
    slots = 32 / lh;
  }
  if constexpr (kG > 0)
    unit_bwd_small<kG>(p.g, p.logits, p.values, p.m, p.den, p.out, p.perm,
                       a, b, r, p.d_logits, p.d_values, p.heads, p.dl_stride,
                       slot, slots, lane % lh, lh);
  else
    unit_bwd<kVec>(p.g, p.logits, p.values, p.m, p.den, p.out, p.perm, a, b,
                   r, p.d_logits, p.d_values, p.heads, p.dl_stride, p.dim,
                   slot, slots, lane % lh, lh);
}

template <bool kVec, int kG>
void launch(const Args& p, cudaStream_t s) {
  edge_softmax_bwd_kernel<kVec, kG>
      <<<blocks_for(p.warps), 32 * kWarpsPerBlock, 0, s>>>(p);
}

}  // namespace

// g and out (num_segments, heads, dim), logits (num_edges, heads), values
// (num_edges, heads, dim), m and den (num_segments, heads), all f32;
// perm (num_edges,), indptr and piece_ptr (num_segments+1,) int32,
// max_pieces (row_pieces.cuh's bound for num_edges edges) -> d_logits (num_edges, dl_stride), its first
// heads columns the cotangent and the rest zeros, and d_values
// (num_edges, heads, dim) f32. A caller pads d_logits' rows to whole
// 32-byte sectors (dl_stride = 8 at 4 heads) where the call's traffic
// exceeds the L2 cache: a row of 16 bytes written at a random edge fills
// half a sector, which the L2 must complete by a read from device memory
// when it evicts it. One launch on `stream`. Returns cudaGetLastError().
extern "C" int edge_softmax_bwd_f32(const void* g, const void* logits,
                                    const void* values, const void* m,
                                    const void* den, const void* out,
                                    const void* perm, const void* indptr,
                                    const void* piece_ptr, void* d_logits,
                                    void* d_values, int64_t num_edges,
                                    int64_t num_segments, int64_t max_pieces,
                                    int64_t heads,
                                    int64_t dl_stride, int64_t dim,
                                    void* stream) {
  if (num_edges <= 0 || num_segments <= 0 || heads <= 0 || dim <= 0 ||
      dl_stride < heads)
    return 0;
  // rows, pieces, then the pad edges in runs of kPiece
  const int64_t subs = rows_per_warp(heads);
  const int64_t row_warps = (num_segments + subs - 1) / subs;
  const Args p{static_cast<const float*>(g),
               static_cast<const float*>(logits),
               static_cast<const float*>(values),
               static_cast<const float*>(m),
               static_cast<const float*>(den),
               static_cast<const float*>(out),
               static_cast<const int*>(perm),
               static_cast<const int*>(indptr),
               static_cast<const int*>(piece_ptr),
               static_cast<float*>(d_logits),
               static_cast<float*>(d_values),
               (int)num_segments,
               max_pieces,
               num_edges,
               heads,
               dl_stride,
               dim,
               row_warps,
               row_warps + max_pieces + max_pad_runs(num_edges)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                    (uintptr_t)values % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                    (uintptr_t)d_values % 16 == 0;
  if (!vec4)
    launch<false, 0>(p, s);
  else if (dim == 4)
    launch<true, 1>(p, s);
  else if (dim == 8)
    launch<true, 2>(p, s);
  else if (dim == 16)
    launch<true, 4>(p, s);
  else
    launch<true, 0>(p, s);
  return (int)cudaGetLastError();
}
