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
// NaN, so the max is written out: take v when v > acc or v is NaN.
//
// Bound on the H100: bytes. Each message row is read once and each
// output row written once; one comparison per element read, far below
// the card's float32 rate, so the floor is (E*D + N*D) * 4 bytes, plus
// the plan's 4 bytes per edge and row, over 3.35 TB/s.
//
// Design: segment_sum.cu's. One warp per destination row walks the row's
// edges perm[indptr[i]:indptr[i+1]] in plan order; the warp loads 32 edge
// ids at a time (one per lane) and broadcasts them with __shfl_sync;
// lanes stride over the feature axis with 16-byte loads when D % 4 == 0,
// so each message row is read in whole 128-byte lines and reduced in
// registers. No shared memory and no atomics: each output element has one
// writer and the result is the same on every run. The TPU's candidate
// tensor does not exist here: a lane compares each edge's value as it
// arrives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;  // kernels/ref.py:NEG

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

// T is float4 (D % 4 == 0, 16-byte aligned) or float; `width` counts Ts.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_max_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                   const int* __restrict__ indptr, T* __restrict__ out,
                   int64_t num_segments, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_segments) return;  // uniform across the warp
  const int64_t begin = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t c0 = 0; c0 < width; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool active = c < width;
    T acc;
    set_neg(acc);
    for (int64_t base = begin; base < end; base += 32) {
      const int mine = (base + lane < end) ? perm[base + lane] : 0;
      const int n = end - base < 32 ? (int)(end - base) : 32;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t e = __shfl_sync(kFullMask, mine, j);
        if (active) max_to(acc, data[e * width + c]);
      }
    }
    if (active) out[row * width + c] = acc;
  }
}

}  // namespace

// data (E, dim) f32, perm (E,) int32, indptr (num_segments+1,) int32
// -> out (num_segments, dim) f32. Returns cudaGetLastError().
extern "C" int segment_max_f32(const void* data, const void* perm,
                               const void* indptr, void* out,
                               int64_t num_segments, int64_t dim,
                               void* stream) {
  if (num_segments <= 0 || dim <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(
      (unsigned)((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = dim % 4 == 0 && (uintptr_t)data % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  if (vec4) {
    segment_max_kernel<float4><<<grid, block, 0, s>>>(
        static_cast<const float4*>(data), static_cast<const int*>(perm),
        static_cast<const int*>(indptr), static_cast<float4*>(out),
        num_segments, dim / 4);
  } else {
    segment_max_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(data), static_cast<const int*>(perm),
        static_cast<const int*>(indptr), static_cast<float*>(out),
        num_segments, dim);
  }
  return (int)cudaGetLastError();
}
