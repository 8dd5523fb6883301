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
// - The row lookup clips, as jnp.take(..., mode="clip") does: an edge
//   whose edge_dst is N (a bucket's pad edge, kernels/plan.py) reads row
//   N - 1. Outputs have the plan's edge count; the wrapper
//   (kernels/ops.py) returns empty tensors without a launch when there are
//   no edges, zeros when N = 0, and computes og outside the kernel.
//
// Bound on the H100: bytes. Each edge's H logits and H*D values are read
// once and its H + H*D cotangents written once, and the rows' g, m, den
// and og are read; a few multiply-adds and one exponential per element are
// far below the float32 rate, so the floor is about
// (2*E*H*(1+D) + E + N*H*(D+3)) * 4 bytes over 3.35 TB/s.
//
// Design: edge-parallel and scatter-free, one warp per edge. When D
// divides 32 (GAT-E's 4 heads of 8), lane j holds the pair (h, d) =
// (j / D, j % D), so a warp reads the edge's values and the row's g as
// whole 128-byte lines; each lane computes its head's p, and the D lanes
// of a head sum values * g with xor shuffles that stay inside the head's
// aligned lane group. Other widths loop over heads with the lanes striding
// over d and a full-warp shuffle sum. Every output element is written by
// one lane, with no atomics, so the result is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;  // the port's masking sentinel, kernels/ref.py

__device__ __forceinline__ float edge_weight(float x, float m, float den) {
  return x > kNeg / 2 ? expf(x - m) / fmaxf(den, 1e-20f) : 0.f;
}

// dim divides 32: lanes hold (head, d) pairs, heads align to lane groups.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_bwd_grouped(const float* __restrict__ g,
                         const float* __restrict__ logits,
                         const float* __restrict__ values,
                         const float* __restrict__ m,
                         const float* __restrict__ den,
                         const float* __restrict__ og,
                         const int* __restrict__ edge_dst,
                         float* __restrict__ d_logits,
                         float* __restrict__ d_values, int64_t num_edges,
                         int64_t num_segments, int64_t heads, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t hd = heads * dim;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t e = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       e < num_edges; e += warps) {  // uniform across the warp
    int64_t i = edge_dst[e];
    if (i > num_segments - 1) i = num_segments - 1;  // clip, as on the TPU
    for (int64_t j0 = 0; j0 < hd; j0 += 32) {
      const int64_t j = j0 + lane;
      const bool active = j < hd;
      const int64_t h = active ? j / dim : 0;
      float p = 0.f, prod = 0.f;
      if (active) {
        p = edge_weight(logits[e * heads + h], m[i * heads + h],
                        den[i * heads + h]);
        const float gi = g[i * hd + j];
        prod = values[e * hd + j] * gi;
        d_values[e * hd + j] = p * gi;
      }
      for (int off = dim >> 1; off > 0; off >>= 1)
        prod += __shfl_xor_sync(kFullMask, prod, off);
      if (active && j % dim == 0)
        d_logits[e * heads + h] = p * (prod - og[i * heads + h]);
    }
  }
}

// Any dim: one head at a time, lanes striding over d.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_bwd_strided(const float* __restrict__ g,
                         const float* __restrict__ logits,
                         const float* __restrict__ values,
                         const float* __restrict__ m,
                         const float* __restrict__ den,
                         const float* __restrict__ og,
                         const int* __restrict__ edge_dst,
                         float* __restrict__ d_logits,
                         float* __restrict__ d_values, int64_t num_edges,
                         int64_t num_segments, int64_t heads, int64_t dim) {
  const int lane = threadIdx.x & 31;
  const int64_t hd = heads * dim;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t e = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       e < num_edges; e += warps) {  // uniform across the warp
    int64_t i = edge_dst[e];
    if (i > num_segments - 1) i = num_segments - 1;  // clip, as on the TPU
    for (int64_t h = 0; h < heads; ++h) {
      const float p = edge_weight(logits[e * heads + h], m[i * heads + h],
                                  den[i * heads + h]);
      float prod = 0.f;
      for (int64_t d = lane; d < dim; d += 32) {
        const float gi = g[i * hd + h * dim + d];
        prod += values[e * hd + h * dim + d] * gi;
        d_values[e * hd + h * dim + d] = p * gi;
      }
      for (int off = 16; off > 0; off >>= 1)
        prod += __shfl_xor_sync(kFullMask, prod, off);
      if (lane == 0) d_logits[e * heads + h] = p * (prod - og[i * heads + h]);
    }
  }
}

}  // namespace

// g (num_segments, heads, dim), logits (num_edges, heads), values
// (num_edges, heads, dim), m, den and og (num_segments, heads), all f32;
// edge_dst (num_edges,) int32 -> d_logits (num_edges, heads) and d_values
// (num_edges, heads, dim) f32. Returns cudaGetLastError().
extern "C" int edge_softmax_bwd_f32(const void* g, const void* logits,
                                    const void* values, const void* m,
                                    const void* den, const void* og,
                                    const void* edge_dst, void* d_logits,
                                    void* d_values, int64_t num_edges,
                                    int64_t num_segments, int64_t heads,
                                    int64_t dim, void* stream) {
  if (num_edges <= 0 || num_segments <= 0 || heads <= 0 || dim <= 0)
    return 0;
  int64_t blocks = (num_edges + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride
  const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* lf = static_cast<const float*>(logits);
  const float* vf = static_cast<const float*>(values);
  const float* mf = static_cast<const float*>(m);
  const float* df = static_cast<const float*>(den);
  const float* of = static_cast<const float*>(og);
  const int* dst = static_cast<const int*>(edge_dst);
  float* dl = static_cast<float*>(d_logits);
  float* dv = static_cast<float*>(d_values);
  if (dim <= 32 && 32 % dim == 0) {
    edge_softmax_bwd_grouped<<<grid, block, 0, s>>>(
        gf, lf, vf, mf, df, of, dst, dl, dv, num_edges, num_segments, heads,
        (int)dim);
  } else {
    edge_softmax_bwd_strided<<<grid, block, 0, s>>>(
        gf, lf, vf, mf, df, of, dst, dl, dv, num_edges, num_segments, heads,
        dim);
  }
  return (int)cudaGetLastError();
}
