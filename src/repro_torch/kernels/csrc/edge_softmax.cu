// Per destination and head: the softmax over the row's in-edge logits,
// applied to the edges' values; the Sum stage of GAT and GAT-E.
//
// Replaces: src/repro/kernels/edge_softmax.py, edge_softmax_csc (body
// _edge_softmax_kernel), the TPU kernel that runs an online softmax over
// the edge chunks of each 128-row destination block with one-hot matmuls.
//
// Bound on the H100: bytes. Each edge's H logits and H*D values are read
// once and each row's H*D outputs and 2*H statistics written once; the
// two exponentials and few multiply-adds per element read are far below
// the float32 rate, so the floor is
// (E*H*(1+D) + N*H*(D+2)) * 4 bytes (plus the plan) over 3.35 TB/s.
//
// Design: one warp per destination row; lane j holds the pair
// (h, d) = (j / D, j % D), striding when H*D > 32 (GAT-E's 4 heads of 8
// fill one warp exactly). Each lane keeps the online state (m, l, acc)
// of its head in registers and walks the row's edges in plan order,
// rescaling by exp(m_prev - m_new), so every value is read once in
// 128-byte rows and nothing is staged in shared memory. The warp loads
// 32 edge ids at a time and broadcasts them with __shfl_sync. It writes
// out = acc / max(l, 1e-20) with m and den = l, as the TPU kernel does.
// Masked edges arrive with NEG logits and no separate mask: a row whose
// edges are all masked ends with m = NEG and den = its edge count, an
// empty row with m = NEG, den = 0 and out = 0. The order is fixed by the
// plan and there are no atomics, so the result is the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;  // the port's masking sentinel, kernels/ref.py

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_kernel(const float* __restrict__ logits,
                    const float* __restrict__ values,
                    const int* __restrict__ perm,
                    const int* __restrict__ indptr,
                    float* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ den_out, int64_t num_segments,
                    int64_t heads, int64_t dim) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_segments) return;  // uniform across the warp
  const int64_t hd = heads * dim;
  const int64_t begin = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t j0 = 0; j0 < hd; j0 += 32) {
    const int64_t j = j0 + lane;
    const bool active = j < hd;
    const int64_t h = active ? j / dim : 0;
    float m = kNeg, l = 0.f, acc = 0.f;
    for (int64_t base = begin; base < end; base += 32) {
      const int mine = (base + lane < end) ? perm[base + lane] : 0;
      const int n = end - base < 32 ? (int)(end - base) : 32;
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        const int64_t e = __shfl_sync(kFullMask, mine, k);
        if (active) {
          const float x = logits[e * heads + h];
          const float v = values[e * hd + j];
          const float m_new = fmaxf(m, x);
          const float alpha = expf(m - m_new);
          const float p = expf(x - m_new);
          l = l * alpha + p;
          acc = acc * alpha + p * v;
          m = m_new;
        }
      }
    }
    if (active) {
      out[row * hd + j] = acc / fmaxf(l, 1e-20f);
      if (j % dim == 0) {
        m_out[row * heads + h] = m;
        den_out[row * heads + h] = l;
      }
    }
  }
}

}  // namespace

// logits (E, heads) f32, values (E, heads, dim) f32, perm (E,) int32,
// indptr (num_segments+1,) int32 -> out (num_segments, heads, dim),
// m and den (num_segments, heads) f32. Returns cudaGetLastError().
extern "C" int edge_softmax_f32(const void* logits, const void* values,
                                const void* perm, const void* indptr,
                                void* out, void* m_out, void* den_out,
                                int64_t num_segments, int64_t heads,
                                int64_t dim, void* stream) {
  if (num_segments <= 0 || heads <= 0 || dim <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(
      (unsigned)((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock));
  edge_softmax_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(values),
      static_cast<const int*>(perm), static_cast<const int*>(indptr),
      static_cast<float*>(out), static_cast<float*>(m_out),
      static_cast<float*>(den_out), num_segments, heads, dim);
  return (int)cudaGetLastError();
}
